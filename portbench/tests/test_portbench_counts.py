"""The operation and byte counts against hand counts and against an
independent count of the reference's products."""
import torch
from torch.utils.flop_counter import FlopCounterMode

import portbench_tiny as tiny
from portbench import frontend
from portbench.flops import counts
from portbench.reference import models, precision

CFG = {"aliked": {"channels": [32, 64, 128, 128], "desc_dim": 128},
       "lightglue": {"dim": 256, "heads": 4, "layers": 9}}


def test_lightglue_at_2048_keypoints_is_254_2_gflop():
    assert round(counts.lightglue_ops(CFG, 2048, 2048) / 1e9, 1) == 254.2
    attn = sum(counts.attention_fwd(CFG, c)[0]
               for c in counts.attention_calls(CFG, [2048], [2048]))
    assert round(attn / 1e9, 1) == 154.6


def test_hand_counts_at_small_shapes():
    cfg = {"aliked": {"channels": [8, 8], "desc_dim": 4},
           "lightglue": {"dim": 8, "heads": 2, "layers": 1}}
    # 16x16 image: blocks at 8x8 and 4x4; heads at 8x8
    hand = (2 * 64 * 4 * 8 * 9 + 2 * 64 * 8 * 8 * 9
            + 2 * 16 * 8 * 8 * 9 * 2
            + 2 * 64 * 16 * 4 + 2 * 64 * 16 * 32 * 9 + 2 * 64 * 32 * 9)
    assert counts.aliked_ops(cfg, 16, 16) == hand
    # one self call, 1 head of 2, 3 queries, 5 keys: 4 d nq nk; bytes
    # q, k (f32), v (bf16), mask, output (f32)
    one = {"lightglue": {"dim": 2, "heads": 1, "layers": 1}}
    assert counts.attention_fwd(one, ("self", [(3, 5)])) == \
        (4 * 2 * 3 * 5, 3 * 2 * 4 + 5 * 2 * 4 + 5 * 2 * 2 + 5 + 3 * 2 * 4)
    assert counts.attention_bwd(one, ("cross", [(3, 5)])) == \
        (8 * 2 * 3 * 5,
         3 * 2 * 2 * 2 + 3 * 2 * 4 + 5 * 2 * 2 * 2 * 2 + 5)


def test_counts_equal_the_reference_products():
    cfg = tiny.PAIRS_CFG
    tree = frontend.weights_tree(cfg, 1)
    pa, pl = frontend.reference_params(tree, "cpu")
    prec = precision.STATED
    with FlopCounterMode(display=False) as fc:
        models.aliked(pa, torch.rand(1, 64, 96), prec)
    assert fc.get_total_flops() == counts.aliked_ops(cfg, 64, 96)
    n0, n1 = 7, 5
    k0, k1 = torch.rand(1, n0, 2) * 60, torch.rand(1, n1, 2) * 60
    d0, d1 = torch.randn(1, n0, 16), torch.randn(1, n1, 16)
    v0, v1 = torch.ones(1, n0, dtype=torch.bool), \
        torch.ones(1, n1, dtype=torch.bool)
    with FlopCounterMode(display=False) as fc:
        models.lightglue(pl, k0, d0, v0, k1, d1, v1, (64, 96), prec,
                         heads=2)
    assert fc.get_total_flops() == counts.lightglue_ops(cfg, n0, n1)
