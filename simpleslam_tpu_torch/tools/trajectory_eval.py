"""Trajectory evaluation: ATE-RMSE and RTE with Sim(3)/SE(3) alignment
(the counterpart of ``simpleslam_tpu/tools/trajectory_eval.py``; numpy
only).

Usage as a module:
    ate, stats = ate_rmse(est_T, gt_T, align="sim3")
    trans_err, rot_err = rte(est_T, gt_T, delta=1)

CLI:
    python -m simpleslam_tpu_torch.tools.trajectory_eval est.txt gt.txt [--align sim3]
(pose files in KITTI format: N rows of flattened 3x4 T_wc matrices)
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import numpy as np

from simpleslam_tpu_torch.core.trajectory_utils import umeyama_sim3


def _centers_from_T(T: np.ndarray, convention: str = "wc") -> np.ndarray:
    """(N,4,4)/(N,3,4) poses -> (N,3) camera centers.

    'wc' (camera-to-world, KITTI GT convention): center = T[:3, 3].
    'cw' (camera-from-world, pipeline convention): center = -R^T t.
    """
    T = np.asarray(T, np.float64)
    if convention == "wc":
        return T[:, :3, 3].copy()
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def ate_rmse(est_T: np.ndarray, gt_T: np.ndarray, *, align: str = "sim3",
             est_convention: str = "cw", gt_convention: str = "wc",
             ) -> Tuple[float, Dict[str, float]]:
    """Absolute trajectory error RMSE after optional alignment.

    align: 'sim3' (Umeyama similarity — standard for monocular, removes the
    scale ambiguity), 'se3' (rigid only), or 'none'.
    Returns (rmse, stats dict with mean/median/max and the scale used).
    """
    est = _centers_from_T(np.asarray(est_T), est_convention)
    gt = _centers_from_T(np.asarray(gt_T), gt_convention)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    # a diverged run can log non-finite poses; evaluate the finite subset
    # rather than crash the Umeyama SVD (and report how much was dropped)
    finite = np.isfinite(est).all(axis=1) & np.isfinite(gt).all(axis=1)
    n_bad = int(n - finite.sum())
    if n_bad:
        est, gt, n = est[finite], gt[finite], int(finite.sum())
    if n < 2:
        return float("nan"), {"n": n, "n_nonfinite": n_bad}

    s, R, t = 1.0, np.eye(3), np.zeros(3)
    if align == "sim3":
        s, R, t = umeyama_sim3(est, gt)
    elif align == "se3":
        _, R, t = umeyama_sim3(est, gt)
        s = 1.0
        t = gt.mean(0) - R @ est.mean(0)
    aligned = s * est @ R.T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    rmse = float(np.sqrt(np.mean(err ** 2)))
    stats = {
        "mean": float(err.mean()), "median": float(np.median(err)),
        "max": float(err.max()), "scale": float(s), "n": n,
    }
    if n_bad:
        stats["n_nonfinite"] = n_bad
    return rmse, stats


def rte(est_T: np.ndarray, gt_T: np.ndarray, delta: int = 1,
        est_convention: str = "cw", gt_convention: str = "wc",
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Relative trajectory error over frame gaps of ``delta``.

    Returns (translation errors (M,), rotation errors deg (M,)) comparing
    relative motions est_i->i+d vs gt_i->i+d (scale-corrected globally).
    """
    def to_Twc(T, conv):
        T = np.asarray(T, np.float64)
        if T.shape[1] == 3:
            T4 = np.tile(np.eye(4), (len(T), 1, 1))
            T4[:, :3, :4] = T
            T = T4
        if conv == "cw":
            return np.linalg.inv(T)
        return T

    E = to_Twc(est_T, est_convention)
    G = to_Twc(gt_T, gt_convention)
    n = min(len(E), len(G))
    E, G = E[:n], G[:n]
    # global scale correction (monocular)
    s, _, _ = umeyama_sim3(E[:, :3, 3], G[:, :3, 3])
    E = E.copy()
    E[:, :3, 3] *= s

    te, re = [], []
    for i in range(n - delta):
        dE = np.linalg.inv(E[i]) @ E[i + delta]
        dG = np.linalg.inv(G[i]) @ G[i + delta]
        err = np.linalg.inv(dG) @ dE
        te.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        re.append(np.degrees(np.arccos(c)))
    return np.asarray(te), np.asarray(re)


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI pose file -> (N,4,4) T_wc."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (len(raw), 1, 1))
    T[:, :3, :4] = raw
    return T


def save_kitti_poses(path: str, T: np.ndarray) -> None:
    T = np.asarray(T)
    np.savetxt(path, T[:, :3, :4].reshape(len(T), 12))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("trajectory_eval")
    p.add_argument("est")
    p.add_argument("gt")
    p.add_argument("--align", choices=["sim3", "se3", "none"], default="sim3")
    p.add_argument("--est_convention", choices=["cw", "wc"], default="wc")
    p.add_argument("--delta", type=int, default=1)
    a = p.parse_args(argv)

    est = load_kitti_poses(a.est)
    gt = load_kitti_poses(a.gt)
    rmse, stats = ate_rmse(est, gt, align=a.align,
                           est_convention=a.est_convention)
    te, re = rte(est, gt, delta=a.delta, est_convention=a.est_convention)
    print(f"ATE-RMSE: {rmse:.4f} m  (mean {stats['mean']:.4f}, "
          f"median {stats['median']:.4f}, max {stats['max']:.4f}, "
          f"scale {stats['scale']:.4f}, n={stats['n']})")
    print(f"RTE(d={a.delta}): trans {te.mean():.4f} m  rot {re.mean():.4f} deg")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
