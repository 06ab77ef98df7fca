"""The forward attention kernel's share of its roofline in the matching
calls: the calls' operations (4 d nq nk a head at the valid queries and
keys) and bytes (q, k, v, mask and output once, in their dtypes), counted
from shapes, over the summed device time of the kernel's own trace
entries. The peak is the card's bfloat16 dense rate; no product here runs
faster than bfloat16, so the share cannot pass 100% whatever implements
the kernel."""
from portbench.metrics._common import roofline_pct

NAME, UNIT, SOURCE = "attn_fwd_roofline.pairs", "%", "device_trace"
LAYER = "kernels: csrc/masked_attention.cu"
MOVES = "pairs_per_s"


def read(run):
    return roofline_pct(run, "attn_fwd", "attn_fwd_launches",
                        "masked_attention_kernel", exclude="bwd")
