"""The front-end's training loss and optimizer, in plain PyTorch.

The loss of a batch of view pairs with known correspondences (the sum, as
the training step weights it, of):

* ``desc``: InfoNCE of the descriptors at corresponding points, both
  directions, temperature 0.1, over the pair's valid points;
* ``rep``: squared difference of the two views' scores at corresponding
  points (weight 0.5);
* ``peak``: view 0's 128 strongest 5x5 maxima (chosen without gradient),
  carried through the dense correspondence into view 1, must peak there:
  the negative log softmax (temperature 0.5) of the warped pixel in its 7x7
  window of view 1's scores (weight 0.5);
* ``reg``: 0.1 x (relu(1 - std of view 0's scores) + 0.01 x mean of its
  clamped squares);
* ``match``: LightGlue's negative log assignment at the correspondences;
* ``sig``: the binary cross-entropy of view 0's matchability against the
  point's validity (weight 0.1).

The optimizer: non-finite gradient entries zeroed, the global norm clipped
at 1, Adam (0.9, 0.999, eps 1e-8 outside the root, bias corrected), weight
decay 1e-4 on every entry, and a warm-up cosine learning rate read at the
count before the update, so the first update is exactly zero.

``n_valid`` and ``share`` let a block of the batch contribute its part of
the whole batch's loss, so the reference can run a large batch in blocks
and add the gradients.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import models


def _bilinear(fmap, x, y):
    """(B, Hf, Wf, C) at (B, N) coordinates -> (B, N, C), coordinates
    clamped inside the map."""
    B, Hf, Wf, C = fmap.shape
    x = torch.clamp(x, 0.0, Wf - 1.001)
    y = torch.clamp(y, 0.0, Hf - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    f = fmap.reshape(B, Hf * Wf, C)
    b = y0 * Wf + x0

    def at(i):
        return torch.gather(f, 1, i[..., None].expand(-1, -1, C))

    return (at(b) * ((1 - fx) * (1 - fy)) + at(b + 1) * (fx * (1 - fy))
            + at(b + Wf) * ((1 - fx) * fy) + at(b + Wf + 1) * (fx * fy))


def _unit_desc(dmap, pts):
    d = _bilinear(dmap, pts[..., 0] * 0.5, pts[..., 1] * 0.5)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-8)


def _peak_loss(score0, score1, warp01, wvalid, n_peaks=128, r=3, tau=0.5):
    B, H, W = score0.shape
    gated = models.gated_scores(score0)
    gated = torch.where(wvalid, gated, torch.full_like(gated, -math.inf))
    v, idx = torch.topk(gated.detach().reshape(B, -1), n_peaks)
    ok = torch.isfinite(v)
    q = torch.gather(warp01.reshape(B, H * W, 2), 1,
                     idx[..., None].expand(-1, -1, 2))
    ok = ok & (q[..., 0] >= r + 1) & (q[..., 0] < W - r - 1) \
        & (q[..., 1] >= r + 1) & (q[..., 1] < H - r - 1)
    qx = torch.clamp(torch.round(q[..., 0]).long(), r, W - 1 - r)
    qy = torch.clamp(torch.round(q[..., 1]).long(), r, H - 1 - r)
    d = torch.arange(-r, r + 1, device=score0.device)
    win = ((qy[..., None, None] + d[:, None]) * W
           + qx[..., None, None] + d[None, :]).reshape(B, -1)
    vals = torch.gather(score1.reshape(B, H * W), 1, win)
    logp = torch.log_softmax(vals.reshape(B, n_peaks, -1) / tau, -1)
    centre = (2 * r + 1) * r + r
    return -torch.where(ok, logp[..., centre], torch.zeros_like(v)).sum(-1) \
        / torch.clamp(ok.sum(-1), min=1)


def loss(pa, pl, batch, hw, prec, n_valid=None, share=1.0):
    """(total, terms) of ``batch`` (img0/img1 (B, H, W, 1), pts0/pts1
    (B, G, 2), pt_valid (B, G), warp01 (B, H, W, 2), warp_valid (B, H, W))
    under ALIKED parameters ``pa`` and LightGlue parameters ``pl``."""
    score0, dmap0 = models.aliked(pa, batch["img0"][..., 0], prec)
    score1, dmap1 = models.aliked(pa, batch["img1"][..., 0], prec)
    pts0, pts1, pv = batch["pts0"], batch["pts1"], batch["pt_valid"]
    if n_valid is None:
        n_valid = torch.clamp(pv.sum(), min=1)
    d0, d1 = _unit_desc(dmap0, pts0), _unit_desc(dmap1, pts1)

    sim = torch.einsum("bgd,bhd->bgh", d0, d1) / 0.1
    lp01 = torch.log_softmax(torch.where(pv[:, None, :], sim,
                                         torch.full_like(sim, -1e9)), -1)
    lp10 = torch.log_softmax(torch.where(pv[:, :, None], sim,
                                         torch.full_like(sim, -1e9)), -2)
    diag = (torch.diagonal(lp01, dim1=1, dim2=2)
            + torch.diagonal(lp10, dim1=1, dim2=2)) * 0.5
    zero = torch.zeros_like(diag)
    l_desc = -torch.where(pv, diag, zero).sum() / n_valid

    s0 = _bilinear(score0[..., None], pts0[..., 0], pts0[..., 1])[..., 0]
    s1 = _bilinear(score1[..., None], pts1[..., 0], pts1[..., 1])[..., 0]
    l_rep = torch.where(pv, (s0 - s1) ** 2, zero).sum() / n_valid
    l_peak = _peak_loss(score0, score1, batch["warp01"],
                        batch["warp_valid"]).mean() * share
    l_reg = (torch.relu(1.0 - torch.std(score0, dim=(1, 2), correction=0))
             .mean() + 0.01 * torch.clamp(score0 ** 2, max=1e4).mean()) \
        * share

    P, sig0, _ = models.lightglue(pl, pts0, d0, pv, pts1, d1, pv, hw, prec)
    l_match = -torch.where(pv, torch.log(torch.diagonal(P, dim1=1, dim2=2)
                                         + 1e-9), zero).sum() / n_valid
    s = torch.clamp(sig0, 1e-6, 1.0 - 1e-6)
    l_sig = -torch.where(pv, torch.log(s), torch.log(1.0 - s)).mean() * share
    total = (l_desc + 0.5 * l_rep + 0.5 * l_peak + 0.1 * l_reg + l_match
             + 0.1 * l_sig)
    return total, {"desc": l_desc, "rep": l_rep, "peak": l_peak,
                   "match": l_match, "sig": l_sig, "total": total}


class AdamW:
    """The training step's optimizer over a dict of float32 leaves."""

    B1, B2, EPS, WD, MAX_NORM = 0.9, 0.999, 1e-8, 1e-4, 1.0

    def __init__(self, lr, warmup, total_steps):
        self.lr, self.warmup = float(lr), int(warmup)
        self.decay = max(int(total_steps), self.warmup + 1) - self.warmup
        self.count = 0
        self.mu, self.nu = None, None

    def rate(self, count):
        if count < self.warmup:
            return self.lr * count / self.warmup
        t = min(count - self.warmup, self.decay)
        return self.lr * (0.9 * 0.5 * (1.0 + math.cos(math.pi * t
                                                       / self.decay)) + 0.1)

    @torch.no_grad()
    def step(self, params, grads):
        """Update ``params`` (name -> tensor) in place; returns the
        gradient as the moments take it (sanitised and clipped)."""
        g = {k: torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
             for k, v in grads.items()}
        norm = torch.sqrt(sum((v.double() ** 2).sum() for v in g.values()))
        if float(norm) >= self.MAX_NORM:
            g = {k: v / norm.float() * self.MAX_NORM for k, v in g.items()}
        if self.mu is None:
            self.mu = {k: torch.zeros_like(v) for k, v in g.items()}
            self.nu = {k: torch.zeros_like(v) for k, v in g.items()}
        lr = self.rate(self.count)
        self.count += 1
        c1, c2 = 1 - self.B1 ** self.count, 1 - self.B2 ** self.count
        for k, v in g.items():
            self.mu[k] = self.B1 * self.mu[k] + (1 - self.B1) * v
            self.nu[k] = self.B2 * self.nu[k] + (1 - self.B2) * v * v
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.EPS)
            params[k].add_(-lr * (u + self.WD * params[k]))
        return g
