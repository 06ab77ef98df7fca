"""Operations (2 per multiply-add) and bytes of the front-end, from the
widths in a configuration file and the shapes of a call.

Only products are counted: convolutions, dense layers, the attention's two
products and the assignment's; norms, activations, pooling, resampling,
softmaxes and the keypoint selection are not. LightGlue is counted at each
image's valid keypoints; the attention at the valid queries and keys of
each call (its mask).
"""
from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks() -> dict:
    with open(PEAKS_FILE) as f:
        return json.load(f)


def conv_ops(h, w, cin, cout, k):
    return 2 * h * w * cin * cout * k * k


def aliked_ops(cfg, H, W) -> int:
    """One image of H x W (multiples of 8)."""
    ch = cfg["aliked"]["channels"]
    D = cfg["aliked"]["desc_dim"]
    h, w = H // 2, W // 2
    ops, cin = 0, 4
    for i, c in enumerate(ch):
        ops += conv_ops(h, w, cin, c, 3) + conv_ops(h, w, c, c, 3)
        cin = c
        if i + 1 < len(ch):
            h, w = h // 2, w // 2
    fused = sum(ch)
    h2, w2 = H // 2, W // 2
    return ops + conv_ops(h2, w2, fused, D, 1) \
        + conv_ops(h2, w2, fused, 32, 3) + conv_ops(h2, w2, 32, 1, 3)


def lightglue_ops(cfg, n0, n1) -> int:
    """One pair with n0 and n1 valid keypoints."""
    lg = cfg["lightglue"]
    d, D, L = lg["dim"], cfg["aliked"]["desc_dim"], lg["layers"]
    hd = d // lg["heads"]
    dense = 4 * 2 * d * d + 2 * (2 * d) * (2 * d) + 2 * (2 * d) * d
    per_layer = 2 * dense * (n0 + n1) \
        + sum(attention_ops(lg["heads"], hd, nq, nk)
              for nq, nk in ((n0, n0), (n1, n1), (n0, n1), (n1, n0)))
    ends = (2 * D * d + 2 * 2 * (hd // 2) + 2 * d * d + 2 * d) * (n0 + n1)
    return L * per_layer + ends + 2 * n0 * n1 * d


def attention_ops(heads, hd, nq, nk) -> int:
    """The forward's two products, q k^T and p v."""
    return 4 * heads * hd * nq * nk


def attention_calls(cfg, n0s, n1s):
    """The forward attention calls of one LightGlue forward over pairs
    with valid counts ``n0s`` and ``n1s``: a list of (kind, [(nq, nk) per
    pair]), self calls taking float32 q and k, cross calls bfloat16."""
    out = []
    for _ in range(cfg["lightglue"]["layers"]):
        out += [("self", list(zip(n0s, n0s))), ("self", list(zip(n1s, n1s))),
                ("cross", list(zip(n0s, n1s))), ("cross", list(zip(n1s, n0s)))]
    return out


def _dtype_bytes(kind):
    """(q, k, v) bytes per element: self attention takes float32 q and k
    (after the rotary encoding) and a bfloat16 v; cross all bfloat16."""
    return (4, 4, 2) if kind == "self" else (2, 2, 2)


def attention_fwd(cfg, call):
    """(ops, bytes) of one forward call: q, k, v and the mask read once,
    the float32 output written once, at the valid rows."""
    kind, pairs = call
    heads = cfg["lightglue"]["heads"]
    hd = cfg["lightglue"]["dim"] // heads
    qb, kb, vb = _dtype_bytes(kind)
    ops = sum(attention_ops(heads, hd, nq, nk) for nq, nk in pairs)
    byt = sum(heads * (nq * hd * (qb + 4) + nk * (hd * (kb + vb) + 1))
              for nq, nk in pairs)
    return ops, byt


def attention_bwd(cfg, call):
    """(ops, bytes) of one backward call: four products (twice the
    forward's operations); q, k, v, the mask and the float32 upstream
    gradient read once, dq, dk and dv written once in their inputs'
    dtypes."""
    kind, pairs = call
    heads = cfg["lightglue"]["heads"]
    hd = cfg["lightglue"]["dim"] // heads
    qb, kb, vb = _dtype_bytes(kind)
    ops = 2 * sum(attention_ops(heads, hd, nq, nk) for nq, nk in pairs)
    byt = sum(heads * (nq * hd * (2 * qb + 4) + nk * (2 * hd * (kb + vb) + 1))
              for nq, nk in pairs)
    return ops, byt


def infonce_ops(cfg, g) -> int:
    """The training loss's descriptor similarity of one pair, g points."""
    return 2 * g * g * cfg["aliked"]["desc_dim"]


def train_step_ops(cfg, H, W, valid_counts) -> int:
    """Model operations of one training step: the forward (both views'
    ALIKED, the descriptor similarity, LightGlue at each pair's valid
    points) and a backward counted as twice the forward."""
    fwd = sum(2 * aliked_ops(cfg, H, W) + infonce_ops(cfg, n)
              + lightglue_ops(cfg, n, n) for n in valid_counts)
    return 3 * fwd
