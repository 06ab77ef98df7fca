"""ALIKED, its keypoint selection (DKD) and LightGlue, in plain PyTorch.

The parameters are the trained tree as stored: nested dicts of float32
tensors with flax names and layouts (convolution kernels HWIO, dense
kernels (in, out), norms ``scale`` and ``bias``). Each function follows the
model's equations:

* ALIKED: the image split 2x2 into 4 channels, four blocks of two 3x3
  convolutions with GELU (tanh form) and GroupNorm(8, eps 1e-6), average
  pooling between blocks, the four block outputs upsampled bilinearly
  (half-pixel centres) to half resolution and concatenated, a 1x1
  descriptor head and a two-layer 3x3 score head upsampled to the image;
* DKD: 5x5 non-maximum suppression, an 8-pixel border, the top K scores,
  a 3x3 soft-argmax (temperature 0.1) for the subpixel offset, the
  descriptor sampled bilinearly at half resolution and normalised;
* LightGlue: rotary encoding of centred, scaled keypoints, 9 layers of a
  self and a cross unit (4 heads of 64, key-masked attention, LayerNorm
  eps 1e-6 over [x, message], a GELU MLP, residuals), then the double
  softmax assignment times both matchabilities.

``prec`` (``precision.py``) says how the operands of each product are
rounded; with :data:`precision.STATED` that is the configuration's
bfloat16 and float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e9


def _t(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def params_to(tree, device):
    """The nested tree of arrays as float32 tensors on ``device``."""
    return {k: params_to(v, device) if isinstance(v, dict) else _t(v, device)
            for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# ALIKED
# --------------------------------------------------------------------------- #

def _conv(x, p, prec):
    """A bfloat16 convolution with SAME padding: operands rounded, product
    and bias add each stored as bfloat16."""
    w = p["kernel"].permute(3, 2, 0, 1)
    y = prec.store(F.conv2d(prec.r_low(x), prec.r_low(w),
                            padding=w.shape[-1] // 2))
    return prec.store(y + prec.store(p["bias"])[None, :, None, None])


def _gelu(x, prec):
    return prec.store(F.gelu(x, approximate="tanh"))


def _block(x, p, prec):
    x = _conv(_gelu(_conv(x, p["Conv_0"], prec), prec), p["Conv_1"], prec)
    g = p["GroupNorm_0"]
    return _gelu(prec.store(F.group_norm(x, 8, g["scale"], g["bias"],
                                         eps=1e-6)), prec)


def aliked(p, img, prec):
    """(B, H, W) grey images in [0, 1], H and W multiples of 8 -> (score
    (B, H, W), descriptor map (B, H/2, W/2, D)), float32."""
    B, H, W = img.shape
    x = prec.store(img).reshape(B, H // 2, 2, W // 2, 2)
    x = x.permute(0, 2, 4, 1, 3).reshape(B, 4, H // 2, W // 2)  # (dy, dx)
    feats = []
    n = sum(1 for k in p if k.startswith("block"))
    for i in range(n):
        x = _block(x, p[f"block{i + 1}"], prec)
        feats.append(x)
        if i + 1 < n:
            x = prec.store(F.avg_pool2d(x, 2))
    h2, w2 = H // 2, W // 2
    fused = prec.store(torch.cat([feats[0]] + [
        F.interpolate(f, size=(h2, w2), mode="bilinear", align_corners=False)
        for f in feats[1:]], 1))
    desc = _conv(fused, p["desc_head"], prec)
    s = _conv(_gelu(_conv(fused, p["score_conv1"], prec), prec),
              p["score_conv2"], prec)
    score = F.interpolate(s, size=(H, W), mode="bilinear",
                          align_corners=False)[:, 0]
    return score, desc.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------- #
# DKD
# --------------------------------------------------------------------------- #

NMS_RADIUS, BORDER, TEMP = 2, 8, 0.1


def gated_scores(score):
    """(B, H, W): the score where a pixel is a 5x5 maximum inside the
    border, -inf elsewhere."""
    B, H, W = score.shape
    mx = F.max_pool2d(score[:, None], 2 * NMS_RADIUS + 1, stride=1,
                      padding=NMS_RADIUS)[:, 0]
    yy = torch.arange(H, device=score.device)[:, None]
    xx = torch.arange(W, device=score.device)[None, :]
    inb = (xx >= BORDER) & (xx < W - BORDER) & (yy >= BORDER) \
        & (yy < H - BORDER)
    return torch.where((score >= mx) & inb, score,
                       torch.full_like(score, -math.inf))


def refine_offsets(score):
    """(dx, dy), each (B, H, W): the 3x3 soft-argmax offset at every pixel
    (the window clamped at the image's edge)."""
    B, H, W = score.shape
    pad = F.pad(score[:, None], (1, 1, 1, 1), mode="replicate")
    patches = F.unfold(pad, 3).reshape(B, 9, H, W)
    w = torch.softmax(patches / TEMP, 1)
    d = torch.arange(-1, 2, device=score.device, dtype=torch.float32)
    dy = d[:, None].expand(3, 3).reshape(9)
    dx = d[None, :].expand(3, 3).reshape(9)
    return (w * dx[None, :, None, None]).sum(1), \
        (w * dy[None, :, None, None]).sum(1)


def sample_desc(dmap, x, y):
    """(Hf, Wf, D) map at full-resolution pixels (N,) -> (N, D) unit
    vectors (bilinear at half resolution)."""
    Hf, Wf, D = dmap.shape
    xs = torch.clamp(x * 0.5, 0.0, Wf - 1.001)
    ys = torch.clamp(y * 0.5, 0.0, Hf - 1.001)
    x0, y0 = torch.floor(xs).long(), torch.floor(ys).long()
    fx, fy = (xs - x0)[:, None], (ys - y0)[:, None]
    f = dmap.reshape(-1, D)
    b = y0 * Wf + x0
    v = (f[b] * ((1 - fx) * (1 - fy)) + f[b + 1] * (fx * (1 - fy))
         + f[b + Wf] * ((1 - fx) * fy) + f[b + Wf + 1] * (fx * fy))
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-8)


def dkd(score, dmap, k):
    """One image's top-``k`` keypoints: (kpts (k, 2), desc (k, D), scores
    (k,), valid (k,)), padded rows zero."""
    H, W = score.shape
    top_v, top_i = torch.topk(gated_scores(score[None])[0].reshape(-1), k)
    valid = torch.isfinite(top_v)
    dx, dy = refine_offsets(score[None])
    x = (top_i % W).float() + dx.reshape(-1)[top_i]
    y = (top_i // W).float() + dy.reshape(-1)[top_i]
    desc = sample_desc(dmap, x, y)
    zero = torch.zeros_like(top_v)
    return (torch.stack([x, y], -1), torch.where(valid[:, None], desc, 0.0),
            torch.where(valid, top_v, zero), valid)


# --------------------------------------------------------------------------- #
# LightGlue
# --------------------------------------------------------------------------- #

def _dense(x, p, prec, low):
    """A dense layer: bfloat16 (``low``: operands rounded, product and bias
    add stored as bfloat16) or float32."""
    if low:
        y = prec.store(prec.r_low(x) @ prec.r_low(p["kernel"]))
        return prec.store(y + prec.store(p["bias"]))
    y = prec.r_f32(x) @ prec.r_f32(p["kernel"])
    return y + p["bias"] if "bias" in p else y


def _rotate_pairs(x):
    return torch.stack([-x[..., 1::2], x[..., 0::2]], -1).reshape(x.shape)


def _rotary(x, theta):
    cos = torch.repeat_interleave(torch.cos(theta), 2, dim=-1)
    sin = torch.repeat_interleave(torch.sin(theta), 2, dim=-1)
    return x * cos + _rotate_pairs(x) * sin


def attention(q, k, v, mask_k, prec):
    """softmax(q k^T / sqrt(d), masked keys' logits replaced by -1e9) v,
    float32; q (..., Nq, d), k and v (..., Nk, d), mask (..., Nk)."""
    logits = prec.r_f32(q) @ prec.r_f32(k).transpose(-1, -2) \
        / math.sqrt(q.shape[-1])
    logits = torch.where(mask_k[..., None, :], logits,
                         torch.full_like(logits, NEG))
    return prec.r_f32(torch.softmax(logits, -1)) @ prec.r_f32(v)


def _unit(p, x, src, mask_src, th_x, th_src, heads, prec):
    a = p["attn"]
    B, Nq, dim = x.shape
    Nk = src.shape[1]
    hd = dim // heads

    def split(t, n):
        return t.reshape(B, n, heads, hd).transpose(1, 2)

    q = split(_dense(x, a["q"], prec, True), Nq)
    k = split(_dense(src, a["k"], prec, True), Nk)
    v = split(_dense(src, a["v"], prec, True), Nk)
    if th_x is not None:
        q = _rotary(q, th_x[:, None, :, : hd // 2])
        k = _rotary(k, th_src[:, None, :, : hd // 2])
    out = attention(q, k, v, mask_src[:, None, :], prec)
    out = out.transpose(1, 2).reshape(B, Nq, dim)
    msg = _dense(prec.store(out), a["proj"], prec, True)
    ln = p["LayerNorm_0"]
    y = F.layer_norm(torch.cat([x, msg], -1), (2 * dim,), ln["scale"],
                     ln["bias"], eps=1e-6)
    h = prec.store(F.gelu(_dense(y, p["ff1"], prec, True),
                          approximate="tanh"))
    return x + _dense(h, p["ff2"], prec, True)


def lightglue(p, kpts0, desc0, valid0, kpts1, desc1, valid1, hw, prec,
              heads=4):
    """kpts (B, N, 2) pixels, desc (B, N, D), valid (B, N) bool -> (P
    (B, N, M) assignment, sig0 (B, N), sig1 (B, M))."""
    H, W = hw
    scale = float(max(H, W))
    dim = p["input_proj"]["kernel"].shape[1]
    layers = sum(1 for k in p if k.startswith("self"))

    def theta(kp):
        c = torch.stack([kp[..., 0] - W / 2.0, kp[..., 1] - H / 2.0], -1)
        return _dense(c / scale, p["rotary_freq"], prec, False) * 10.0

    th0, th1 = theta(kpts0), theta(kpts1)
    x0 = _dense(desc0.float(), p["input_proj"], prec, False)
    x1 = _dense(desc1.float(), p["input_proj"], prec, False)
    for i in range(layers):
        su, cu = p[f"self{i}"], p[f"cross{i}"]
        x0 = _unit(su, x0, x0, valid0, th0, th0, heads, prec)
        x1 = _unit(su, x1, x1, valid1, th1, th1, heads, prec)
        x0n = _unit(cu, x0, x1, valid1, None, None, heads, prec)
        x1 = _unit(cu, x1, x0, valid0, None, None, heads, prec)
        x0 = x0n
    m0 = _dense(x0, p["final_proj"], prec, False)
    m1 = _dense(x1, p["final_proj"], prec, False)
    S = prec.r_f32(m0) @ prec.r_f32(m1).transpose(-1, -2) / math.sqrt(dim)
    sig0 = torch.sigmoid(_dense(x0, p["matchability"], prec, False)[..., 0])
    sig1 = torch.sigmoid(_dense(x1, p["matchability"], prec, False)[..., 0])
    pair = valid0[:, :, None] & valid1[:, None, :]
    S = torch.where(pair, S, torch.full_like(S, NEG))
    P = torch.softmax(S, -1) * torch.softmax(S, -2) * sig0[:, :, None] \
        * sig1[:, None, :]
    return torch.where(pair, P, torch.zeros_like(P)), sig0, sig1


def mutual_matches(P, min_conf):
    """(N, M) assignment -> (idx1 (N,), ok (N,)): row i's mutual best
    column where its value passes ``min_conf``."""
    nn1 = torch.argmax(P, 1)
    nn0 = torch.argmax(P, 0)
    conf = P.gather(1, nn1[:, None])[:, 0]
    rows = torch.arange(P.shape[0], device=P.device)
    return nn1, (nn0[nn1] == rows) & (conf > min_conf)
