"""The numbers that decide ``correct``: what the timed path produced, held
to the reference.

Extraction (one frame; the reference's score map ``score`` and descriptor
map ``dmap`` computed again from the frame):

* ``kp_count``: |valid keypoints - min(K, the reference's candidates)|;
* ``kp_loc_px``: each keypoint is traced to the integer pixel, of the 4x4
  around it and inside the 8-pixel border, whose reference soft-argmax
  lands nearest to it and whose reference score is nearest to the
  keypoint's score (the least sum of the distance in pixels and the score
  gap over the frame's score scale); the widest distance of a keypoint
  from its pixel's soft-argmax, in pixels;
* ``kp_select``: the widest gap, over keypoints, by which the reference
  would not select that pixel: how far its reference score lies below the
  reference's K-th candidate and below its 5x5 maximum, over the frame's
  score scale (the root mean square of the reference's score map, since
  rounding errs in proportion to a score's size; on a plateau of equal
  scores each of its pixels is a 5x5 maximum, so two keypoints may trace
  to one pixel); a keypoint with no pixel inside the border reads 1e9;
* ``kp_missed``: for each of the reference's own K keypoints that no
  keypoint produced lies within 0.5 pixels of, how clearly the reference
  selects it: the least of its score's lead over the K-th candidate and
  over the rest of its 5x5 window (on a ridge of near-equal scores
  rounding picks the peak); the widest, over the frame's score scale;
* ``kp_score``: the widest |keypoint score - reference score at its
  pixel|, over the frame's score scale;
* ``desc_cos``: the widest 1 - cos between a keypoint's descriptor and the
  reference descriptor map sampled at the keypoint.

Matching (one pair; the reference's assignment computed from the
keypoints and descriptors that the timed path produced):

* ``assign_p99``: the 99th percentile, over the matches produced, of
  |match confidence - reference assignment| (``assign``, the widest, is
  reported and not compared: where two columns of a row nearly tie, the
  row's mass splits between them and rounding decides the split);
* ``match_rank``: the widest, over the matches produced, of how far the
  reference's assignment of the pair lies below the best of its row or
  of its column, in nats (ln best - ln assignment; the assignment is a
  product of two softmaxes, so this is a gap of logits, as a served
  token's logit is held below the reference's best; 0 where the
  reference ranks the pair first both ways, whether or not it clears the
  confidence gate);
* ``match_lost``: the share of the reference's sure matches that were
  not produced, a sure match being one whose assignment exceeds the gate
  and its row's and its column's runners-up by ``margin`` nats (the
  cell's ``lost_margin``, more than rounding moves an assignment by at
  the cell's size). A row or column matched twice reads 1e9 on all.

Training (three steps from the same weights and batches):

* ``loss_rel``: the widest gap of a loss term over the steps, relative to
  the step's total loss;
* ``grad_leaf``: by the worst leaf, | |g| - |g_ref| | over the larger of
  |g_ref| and the median leaf's, for the first gradient as the optimizer
  takes it;
* ``change_leaf``: the same for each leaf's change over the three steps;
* ``grad_median``, ``change_median``: the median leaf's gap of each;
* ``change_attn``: over the attention's projections (q, k, v and proj,
  kernel and bias, of self- and of cross-attention: the leaves whose
  gradients the attention's backward gives first), the worst of each
  one's median change gap over the layers.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's (zero but for rounding, such as a key's bias under softmax) are
  left out of all five.
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from portbench.reference import models

FLAG = 1e9
MISS_PX = 0.5
TINY = 1e-30


def features(score, dmap, kpts, desc, scores, valid, k):
    """The extraction numbers of one frame (see the module's docstring):
    score (H, W) and dmap (H/2, W/2, D) the reference's; the rest the
    frame's keypoints as produced."""
    H, W = score.shape
    gated = models.gated_scores(score[None])[0].reshape(-1)
    n_cand = int(torch.isfinite(gated).sum())
    top, top_i = torch.topk(gated, min(k, n_cand))
    thr = top[-1]
    scale = torch.clamp(score.square().mean().sqrt(), min=1e-12)
    out = {"kp_count": float(abs(int(valid.sum()) - min(k, n_cand)))}
    x, y = kpts[valid, 0].double(), kpts[valid, 1].double()
    if x.numel() == 0:
        return dict(out, kp_loc_px=0.0, kp_select=0.0, kp_missed=0.0,
                    kp_score=0.0, desc_cos=0.0)
    dx, dy = (t[0].double() for t in models.refine_offsets(score[None]))
    d = torch.arange(-1, 3, device=score.device)
    cx = (torch.floor(x)[:, None, None] + d[None, None, :]).long()
    cy = (torch.floor(y)[:, None, None] + d[None, :, None]).long()
    cx, cy = cx.expand(-1, 4, 4), cy.expand(-1, 4, 4)
    cxc, cyc = cx.clamp(0, W - 1), cy.clamp(0, H - 1)
    b = models.BORDER
    inside = (cx >= b) & (cx < W - b) & (cy >= b) & (cy < H - b)
    lx = cxc + dx[cyc, cxc]
    ly = cyc + dy[cyc, cxc]
    dist = torch.hypot(lx - x[:, None, None], ly - y[:, None, None])
    dist = dist.reshape(len(x), -1)
    cs = score[cyc, cxc].reshape(len(x), -1)
    sgap = (scores[valid][:, None] - cs).abs() / scale
    cost = torch.where(inside.reshape(len(x), -1), dist + sgap,
                       torch.full_like(dist, float("inf")))
    best = cost.argmin(1)
    px = cxc.reshape(len(x), -1).gather(1, best[:, None])[:, 0]
    py = cyc.reshape(len(x), -1).gather(1, best[:, None])[:, 0]
    s = score[py, px]
    mx = F.max_pool2d(score[None, None], 2 * models.NMS_RADIUS + 1, stride=1,
                      padding=models.NMS_RADIUS)[0, 0][py, px]
    select = (torch.relu(thr - s) + torch.relu(mx - s)) / scale
    chosen_inside = inside.reshape(len(x), -1).gather(1, best[:, None])[:, 0]
    select = torch.where(chosen_inside, select, torch.full_like(select, FLAG))
    # the reference's own keypoints that none produced lies near
    rx = (top_i % W).double() + dx.reshape(-1)[top_i]
    ry = (top_i // W).double() + dy.reshape(-1)[top_i]
    near = torch.cdist(torch.stack([rx, ry], -1),
                       torch.stack([x, y], -1)).min(1).values
    r = models.NMS_RADIUS
    w = torch.arange(-r, r + 1, device=score.device)
    wy = (top_i // W)[:, None, None] + w[None, :, None]
    wx = (top_i % W)[:, None, None] + w[None, None, :]
    win = score[wy.clamp(0, H - 1), wx.clamp(0, W - 1)].reshape(len(top), -1)
    win[:, win.shape[1] // 2] = -float("inf")
    clear = torch.minimum(top - thr, top - win.max(1).values)
    missed = torch.where(near > MISS_PX, clear.double() / scale,
                         torch.zeros_like(near))
    ref_desc = models.sample_desc(dmap, kpts[valid, 0], kpts[valid, 1])
    cos = (desc[valid].double() * ref_desc.double()).sum(-1)
    out.update(kp_loc_px=float(dist.gather(1, best[:, None]).max()),
               kp_select=float(select.max()),
               kp_missed=float(missed.max()),
               kp_score=float(((scores[valid] - s).abs() / scale).max()),
               desc_cos=float((1.0 - cos).max()))
    return out


def matches(P, idx0, idx1, conf, valid, min_conf, margin):
    """The matching numbers of one pair: P (N, M) the reference's
    assignment; idx0, idx1, conf, valid the matches as produced; margin
    in nats (``match_lost``)."""
    i, j, c = idx0[valid], idx1[valid], conf[valid].double()
    P = P.double()
    if i.numel() and (torch.unique(i).numel() != i.numel()
                      or torch.unique(j).numel() != j.numel()):
        return {"assign_p99": FLAG, "assign": FLAG, "match_rank": FLAG,
                "match_lost": FLAG}
    out = {"assign_p99": 0.0, "assign": 0.0, "match_rank": 0.0,
           "match_lost": 0.0}
    if i.numel():
        pij = P[i, j]
        a = (c - pij).abs()
        best = torch.maximum(P[i].max(1).values, P[:, j].max(0).values)
        rank = torch.log(best.clamp(min=TINY)) - torch.log(pij.clamp(min=TINY))
        out.update(assign_p99=float(torch.quantile(a, 0.99)),
                   assign=float(a.max()), match_rank=float(rank.max()))
    nn1, ok = models.mutual_matches(P, min_conf)
    ri = torch.arange(P.shape[0], device=P.device)[ok]
    rj = nn1[ok]
    if ri.numel():
        pij = P[ri, rj]
        n = torch.arange(len(ri), device=P.device)
        row = P[ri].clone()
        row[n, rj] = -1.0
        col = P[:, rj].T.clone()
        col[n, ri] = -1.0
        near = torch.maximum(torch.maximum(row.max(1).values,
                                           col.max(1).values),
                             torch.full_like(pij, min_conf))
        sure = torch.log(pij) - torch.log(near.clamp(min=TINY)) > margin
        got = torch.full((P.shape[0],), -1, dtype=torch.long,
                         device=P.device)
        got[i] = j
        lost = sure & (got[ri] != rj)
        out["match_lost"] = float(lost.sum()) / max(int(sure.sum()), 1)
    return out


def _leaf_gaps(prog, ref, keep):
    """Per kept leaf: | |prog| - |ref| | over the larger of |ref| and the
    median kept leaf's |ref|."""
    names = [n for n in ref if keep[n]]
    med = float(torch.tensor([float(ref[n]) for n in names],
                             dtype=torch.float64).median())
    return torch.tensor([abs(float(prog[n]) - float(ref[n]))
                         / max(float(ref[n]), med) for n in names],
                        dtype=torch.float64)


def _attn_worst(names, gaps):
    """The worst, over the attention's projections, of the median over
    the layers of the leaf gaps ``gaps`` (one per name of ``names``)."""
    roles = {}
    for n, g in zip(names, gaps.tolist()):
        if "/attn/" in n:
            roles.setdefault(re.sub(r"\d+/", "/", n), []).append(g)
    return max((float(torch.tensor(v, dtype=torch.float64).median())
                for v in roles.values()), default=0.0)


def train(prog_terms, ref_terms, prog_grad, ref_grad, prog_change,
          ref_change):
    """The training numbers: terms are lists (one per step) of {term:
    value}; grads and changes {leaf: norm}."""
    loss_rel = max(abs(p[k] - r[k]) / abs(r["total"])
                   for p, r in zip(prog_terms, ref_terms) for k in r)
    norms = torch.tensor(list(ref_grad.values()), dtype=torch.float64)
    floor = 1e-3 * float(norms.median())
    keep = {n: float(v) >= floor for n, v in ref_grad.items()}
    names = [n for n in ref_grad if keep[n]]
    g = _leaf_gaps(prog_grad, ref_grad, keep)
    c = _leaf_gaps(prog_change, ref_change, keep)
    return {"loss_rel": loss_rel,
            "grad_leaf": float(g.max()), "grad_median": float(g.median()),
            "change_leaf": float(c.max()),
            "change_median": float(c.median()),
            "change_attn": _attn_worst(names, c)}
