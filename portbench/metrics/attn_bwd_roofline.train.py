"""The backward attention kernel's share of its roofline in the training
steps: operations twice the forward's (four products), bytes q, k, v, the
mask and the upstream gradient read once and dq, dk, dv written once,
counted from shapes, over the summed device time of the kernel's own trace
entries (one or two a call). The peak is the card's bfloat16 dense rate,
so the share cannot pass 100%."""
from portbench.metrics._common import roofline_pct

NAME, UNIT, SOURCE = "attn_bwd_roofline.train", "%", "device_trace"
LAYER = "kernels: csrc/masked_attention_bwd.cu"
MOVES = "train_pairs_per_s"


def read(run):
    return roofline_pct(run, "attn_bwd", "attn_bwd_launches",
                        "masked_attention_bwd_kernel")
