"""Two-view bootstrap: H-vs-F model competition + initial map (the
counterpart of ``simpleslam_tpu/core/bootstrap.py``).

Both branches, both RANSACs, the truncated chi^2 scores, the four
homography pose candidates and the essential pose recovery are computed on
the device in one pass; the reference's decision tree then runs on the host
over the returned scalars:

  1. H-RANSAC + F-RANSAC at ``ransac_px``;
  2. truncated scores over all matches (symmetric transfer vs chi2_H=5.99,
     Sampson vs chi2_F=3.84); prefer H when S_H/(S_H+S_F) > 0.45;
  3. H path: 4 candidates validated by posdepth >= 0.90, median parallax
     and N >= 60, best by (posdepth, parallax);
  4. F path: E refitted on the F inliers, Sampson-polished, recoverPose,
     validated on the cheirality subset;
  5. ``bootstrap_two_view_map``: >= 50 matches, >= min_pts inliers,
     triangulation in the cam0 (= world) frame, depth window in both
     views, >= 80 surviving points.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from enum import Enum, auto
from typing import Optional, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.ops import epipolar
from simpleslam_tpu_torch.ops.maskops import masked_fraction, masked_median
from simpleslam_tpu_torch.ops.projection import pixels_to_normalized
from simpleslam_tpu_torch.ops.triangulation import triangulate_two_view
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.precision import highest_precision
from simpleslam_tpu_torch.utils.rng import TorchKey

logger = logging.getLogger("two_view_bootstrap")

_EPS = 1e-12


class TwoViewModel(Enum):
    HOMOGRAPHY = auto()
    FUNDAMENTAL = auto()


@dataclass
class InitParams:
    """Thresholds; defaults identical to the reference."""
    ransac_px: float = 1.5
    chi2_H: float = 5.99
    chi2_F: float = 3.84
    min_pts_for_tests: int = 60
    min_posdepth: float = 0.90
    min_parallax_deg: float = 1.5
    score_ratio_H: float = 0.45
    n_hyp: int = 256


@dataclass
class TwoViewPose:
    model: TwoViewModel
    R: np.ndarray
    t: np.ndarray
    posdepth: float
    parallax_deg: float


@dataclass
class TwoViewDecision:
    pose: TwoViewPose
    inlier_mask: np.ndarray


def _triangulation_metrics(R, t, p0n, p1n, mask):
    """(posdepth fraction, median parallax deg) over masked normalised
    points, triangulated with P0 = [I|0], P1 = [R|t]; R/t may be batched."""
    eye34 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device),
                       torch.zeros(3, 1, dtype=R.dtype, device=R.device)], 1)
    P2 = torch.cat([R, t[..., :, None]], -1)
    batch = P2.shape[:-2]
    X = triangulate_two_view(eye34.expand(*batch, 1, 3, 4),
                             P2[..., None, :, :], p0n, p1n)
    z0 = X[..., 2]
    z1 = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    posdepth = torch.stack([masked_fraction(c, mask) for c in
                            ((z0 > 0) & (z1 > 0)).reshape(-1, z0.shape[-1])])
    C2 = -(R.transpose(-1, -2) @ t[..., :, None])[..., 0]
    v0 = X
    v1 = X - C2[..., None, :]
    cos = (v0 * v1).sum(-1) / (torch.linalg.norm(v0, dim=-1)
                               * torch.linalg.norm(v1, dim=-1) + _EPS)
    ang = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    parallax = torch.stack([masked_median(a, mask)
                            for a in ang.reshape(-1, ang.shape[-1])])
    return posdepth.reshape(batch), parallax.reshape(batch)


@highest_precision()
def evaluate_two_view(key, p0, p1, valid, K, ransac_px: float,
                      chi2_H: float, chi2_F: float, n_hyp: int = 256):
    """Everything the bootstrap decision needs, without host branching."""
    kH, kF = key.split()
    H, maskH, okH = epipolar.find_homography(kH, p0, p1, valid, ransac_px,
                                             n_hyp=n_hyp)
    F, maskF, okF = epipolar.find_fundamental(kF, p0, p1, valid, ransac_px,
                                              n_hyp=n_hyp)
    dH = epipolar.symmetric_transfer_error_sq(H, p0, p1)
    dF = epipolar.sampson_error_sq(F, p0, p1)
    zero = torch.zeros_like(dH)
    S_H = torch.where(valid, torch.clamp(chi2_H - dH, min=0.0), zero).sum()
    S_F = torch.where(valid, torch.clamp(chi2_F - dF, min=0.0), zero).sum()
    S_H = torch.where(okH, S_H, torch.zeros_like(S_H))
    S_F = torch.where(okF, S_F, torch.zeros_like(S_F))
    ratio_H = S_H / (S_H + S_F + _EPS)

    p0n, p1n = pixels_to_normalized(p0, K), pixels_to_normalized(p1, K)
    Rs, ts, _ns = epipolar.decompose_homography(H, K)
    ts_unit = ts / torch.clamp(torch.linalg.norm(ts, dim=1, keepdim=True),
                               min=_EPS)
    pdH, parH = _triangulation_metrics(Rs, ts_unit, p0n, p1n, valid)

    wF = (maskF & valid).to(p0.dtype)
    E = epipolar.refine_essential_sampson(
        epipolar.fit_essential(p0n, p1n, wF), p0n, p1n, wF)
    R_F, t_F, cheir, n_cheir = epipolar.recover_pose_essential(E, p0, p1,
                                                               valid, K)
    pdF, parF = _triangulation_metrics(R_F, t_F, p0n, p1n, cheir)
    return dict(H=H, F=F, maskH=maskH & valid, maskF=maskF & valid,
                okH=okH, okF=okF, S_H=S_H, S_F=S_F, ratio_H=ratio_H,
                H_Rs=Rs, H_ts=ts_unit, H_posdepth=pdH, H_parallax=parH,
                F_R=R_F, F_t=t_F, F_cheir=cheir & valid, F_n_cheir=n_cheir,
                F_posdepth=pdF, F_parallax=parF, n_valid=valid.sum())


def evaluate_two_view_bootstrap_with_masks(
        K, pts_ref, pts_cur, params: InitParams = InitParams(), valid=None,
        key=None, device=None) -> Optional[TwoViewDecision]:
    """H-vs-F selection + pose + final inlier mask (host decision tree).
    ``device``: None is the GPU (raises without one), "cpu" the CPU."""
    dev = resolve_device(device)
    pts_ref = np.asarray(pts_ref, np.float32)
    pts_cur = np.asarray(pts_cur, np.float32)
    n = len(pts_ref)
    if valid is None:
        valid = np.ones(n, bool)
    if key is None:
        key = TorchKey(0)
    if n < 8:
        return None
    out = evaluate_two_view(
        key, torch.as_tensor(pts_ref, device=dev),
        torch.as_tensor(pts_cur, device=dev),
        torch.as_tensor(np.asarray(valid), device=dev),
        torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev),
        float(params.ransac_px), float(params.chi2_H), float(params.chi2_F),
        n_hyp=params.n_hyp)
    out = {k: v.cpu().numpy() for k, v in out.items()}

    okH, okF = bool(out["okH"]), bool(out["okF"])
    if not okH and not okF:
        logger.info("Both H and F estimation failed -> reject pair.")
        return None
    ratio_H = float(out["ratio_H"])
    logger.info("Scores  S_H=%.1f  S_F=%.1f  -> ratio_H=%.3f",
                float(out["S_H"]), float(out["S_F"]), ratio_H)
    n_valid = int(out["n_valid"])

    def _h_pose() -> Optional[TwoViewPose]:
        best, best_key = None, (-1.0, -1.0)
        for i in range(4):
            pd, ang = float(out["H_posdepth"][i]), float(out["H_parallax"][i])
            ok = (n_valid >= params.min_pts_for_tests
                  and pd >= params.min_posdepth
                  and ang >= params.min_parallax_deg)
            if ok and (pd, ang) > best_key:
                best = TwoViewPose(TwoViewModel.HOMOGRAPHY,
                                   out["H_Rs"][i].astype(np.float64),
                                   out["H_ts"][i].astype(np.float64), pd, ang)
                best_key = (pd, ang)
        return best

    def _f_pose() -> Optional[TwoViewPose]:
        n_cheir = int(out["F_n_cheir"])
        if n_cheir < params.min_pts_for_tests:
            logger.info("F/E rejected: not enough inliers for validation.")
            return None
        pd, ang = float(out["F_posdepth"]), float(out["F_parallax"])
        if pd >= params.min_posdepth and ang >= params.min_parallax_deg:
            return TwoViewPose(TwoViewModel.FUNDAMENTAL,
                               out["F_R"].astype(np.float64),
                               out["F_t"].astype(np.float64), pd, ang)
        logger.info("F/E rejected after validation.")
        return None

    pose: Optional[TwoViewPose] = None
    if ratio_H > params.score_ratio_H and okH:
        pose = _h_pose()
    if pose is None and okF:
        pose = _f_pose()
    if pose is None:
        logger.info("Pair rejected: ambiguous or too weak for init.")
        return None
    if pose.model is TwoViewModel.FUNDAMENTAL:
        mask = out["maskF"] & out["F_cheir"]
    else:
        mask = out["maskH"]
    return TwoViewDecision(pose=pose, inlier_mask=mask.astype(bool) & valid)


@highest_precision()
def _triangulate_cam0(K, R, t, p0, p1):
    """Triangulate in the cam0 (= world) frame with normalised projections."""
    p0n, p1n = pixels_to_normalized(p0, K), pixels_to_normalized(p1, K)
    P1 = torch.cat([torch.eye(3, dtype=K.dtype, device=K.device),
                    torch.zeros(3, 1, dtype=K.dtype, device=K.device)], 1)
    P2 = torch.cat([R, t[:, None]], 1)
    X = triangulate_two_view(P1, P2, p0n, p1n)
    return X, X[:, 2], (X @ R.T + t)[:, 2]


def bootstrap_two_view_map(K, feats_ref, feats_cur, matches, args, world_map,
                           params: InitParams = InitParams(),
                           decision: Optional[TwoViewDecision] = None,
                           key=None) -> Tuple[bool, Optional[np.ndarray],
                                              Optional[np.ndarray]]:
    """Build the initial map from one accepted pair -> (ok, T0_cw = I,
    T1_cw = [R|t]). On success the map holds the triangulated landmarks
    (grey 0.7) observed by KF0 and KF1; poses are added by the caller."""
    mvalid = matches.valid.cpu().numpy()
    n_matches = int(mvalid.sum())
    if n_matches < 50:
        logger.info("[BOOTSTRAP] Not enough matches for init (%d < 50).",
                    n_matches)
        return False, None, None
    dev = feats_ref.kpts.device
    i0 = matches.idx0.cpu().numpy()
    i1 = matches.idx1.cpu().numpy()
    pts_ref = feats_ref.kpts[matches.idx0].cpu().numpy()
    pts_cur = feats_cur.kpts[matches.idx1].cpu().numpy()
    if decision is None:
        decision = evaluate_two_view_bootstrap_with_masks(
            K, pts_ref, pts_cur, params, valid=mvalid, key=key, device=dev)
        if decision is None:
            return False, None, None
    pose = decision.pose
    mask = decision.inlier_mask & mvalid
    ninl = int(mask.sum())
    logger.info("[BOOTSTRAP] Using model=%s with %d inliers.",
                pose.model.name, ninl)
    if ninl < params.min_pts_for_tests:
        return False, None, None

    R = torch.as_tensor(pose.R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(pose.t, dtype=torch.float32, device=dev).reshape(3)
    X, z0, z1 = _triangulate_cam0(
        torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev), R, t,
        torch.as_tensor(pts_ref, device=dev),
        torch.as_tensor(pts_cur, device=dev))
    X, z0, z1 = (a.cpu().numpy() for a in (X, z0, z1))
    min_d = float(getattr(args, "min_depth", 0.0))
    max_d = float(getattr(args, "max_depth", 1e6))
    ok = mask & (z0 > min_d) & (z0 < max_d) & (z1 > min_d) & (z1 < max_d)
    n_kept = int(ok.sum())
    logger.info("[BOOTSTRAP] Triangulated=%d kept=%d after depth filter.",
                ninl, n_kept)
    if n_kept < 80:
        return False, None, None

    T1_cw = np.eye(4)
    T1_cw[:3, :3] = pose.R.astype(np.float32)
    T1_cw[:3, 3] = pose.t.reshape(3).astype(np.float32)
    sel = np.flatnonzero(ok)
    ids = world_map.add_points(X[sel], np.full((n_kept, 3), 0.7, np.float32),
                               keyframe_idx=0)
    desc_ref = feats_ref.desc.cpu().numpy()
    desc_cur = feats_cur.desc.cpu().numpy()
    for pid, s in zip(ids, sel):
        world_map.points[pid].add_observation(0, int(i0[s]), desc_ref[i0[s]])
        world_map.points[pid].add_observation(1, int(i1[s]), desc_cur[i1[s]])
    logger.info("[BOOTSTRAP] Map initialised: %d landmarks.", len(ids))
    return True, np.eye(4), T1_cw
