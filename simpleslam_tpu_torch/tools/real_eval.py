"""Front-end evaluation on photographs under known homographies and
illumination jitter (the counterpart of
``simpleslam_tpu/tools/real_eval.py``).

Each photograph is warped by random homographies and its exposure jittered
(gain, bias, gamma); a front-end extracts on both views and is scored by
the HPatches-style protocol:

  * repeatability -- the share of keypoints visible in both views whose
    warped location has a detected keypoint within ``tol`` px;
  * descriptor separation -- median L2 of true pairs against the nearest
    distractor (float descriptors only);
  * matcher precision and recall -- LightGlue's (or the brute-force
    matcher's) matches at ``min_conf`` against the true warp.

``--compare`` runs the learned pipeline and the ORB and AKAZE front-ends
over one episode list (the same homographies and illumination draws).
The front-ends are ``core/frontend.py``'s, the learned one with the trained
tree (``models/checkpoint.py``); they run on ``--device`` (default the
GPU; ``cpu`` runs there), the warps too. The photographs come from
``--glob``; the repository carries none.

    python -m simpleslam_tpu_torch.tools.real_eval --glob 'DIR/*.png' \\
        [--n 31] [--warps 5] [--frontend learned|orb|akaze|sift] \\
        [--compare] [--no_illum] [--hw H W] [--json] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob as globmod
import json
import os
import sys

import numpy as np
import torch

from simpleslam_tpu_torch.tools.synth import REAL_PHOTO_GLOB

DEFAULT_GLOB = REAL_PHOTO_GLOB


def select_split(paths, split: str):
    """The photographs' train/eval split: ``heldout`` is the even-indexed
    half of the sorted paths (never used by real-image training, which
    takes the odd half and grace_hopper, ``models/train.py::
    train_photo_paths``), ``train`` that odd half, ``all`` every path."""
    paths = sorted(paths)
    if split == "heldout":
        return paths[::2]
    if split == "train":
        return paths[1::2]
    return paths


def _load_gray(path: str, hw):
    """The photograph as grey uint8 (``utils/imgproc.py::imread_gray``),
    shrunk to ``hw`` by area averaging when given, cropped to multiples of
    8; None where it cannot be read."""
    from simpleslam_tpu_torch.utils.imgproc import imread_gray, resize_area_u8

    img = imread_gray(path)
    if img is None:
        return None
    if hw is not None:
        img = resize_area_u8(img, hw)
    H8, W8 = (img.shape[0] // 8) * 8, (img.shape[1] // 8) * 8
    return img[:H8, :W8]


def _random_h(rng, H, W, mag=0.12):
    """Corner-jitter homography of an (H, W) image, float64."""
    from simpleslam_tpu_torch.utils.imgproc import get_perspective_transform

    c0 = np.float32([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1]])
    c1 = np.float32(c0 + rng.uniform(-mag, mag, (4, 2)) * [W, H])
    return get_perspective_transform(c0, c1)


def _warp_pts(Hm, pts):
    ph = np.concatenate([pts, np.ones_like(pts[:, :1])], 1)
    q = ph @ Hm.T
    return q[:, :2] / np.maximum(np.abs(q[:, 2:3]), 1e-9) * np.sign(q[:, 2:3])


def _apply_photometric(img: np.ndarray, ph) -> np.ndarray:
    """Gain, bias and gamma jitter in [0, 255] (the illumination axis)."""
    if ph is None:
        return img
    x = (img.astype(np.float32) / 255.0) ** ph["gamma"]
    x = x * 255.0 * ph["gain"] + ph["bias"]
    return np.clip(x, 0, 255).astype(np.uint8)


def build_episodes(paths, warps, hw, seed=0, illum=True, mag=0.12):
    """The shared episode list, built once so that every compared front-end
    sees the same inputs: dicts of path, grey image, homography and
    photometric draw."""
    rng = np.random.default_rng(seed)
    eps = []
    for p in paths:
        img = _load_gray(p, hw)
        if img is None:
            continue
        for _w in range(warps):
            Hm = _random_h(rng, *img.shape, mag=mag)
            ph = ({"gain": float(rng.uniform(0.7, 1.4)),
                   "bias": float(rng.uniform(-20, 20)),
                   "gamma": float(rng.uniform(0.7, 1.4))} if illum else None)
            eps.append({"path": p, "img": img, "H": Hm, "photo": ph})
    return eps


def evaluate_pair(det, mat, img0, Hm, photo=None, tol=3.0):
    """One episode (an image and its warped, jittered copy) -> a dict of
    metrics, or None when either view has fewer than 16 keypoints or fewer
    than 32 are visible in both. The warp and the extractions run on the
    detector's device."""
    from simpleslam_tpu_torch.utils.imgproc import warp_perspective

    dev = det.device
    H, W = img0.shape
    img1 = _apply_photometric(warp_perspective(
        torch.as_tensor(img0, device=dev), Hm, (W, H)).cpu().numpy(), photo)
    g0 = det.fn(torch.as_tensor(img0, device=dev).float())
    g1 = det.fn(torch.as_tensor(img1, device=dev).float())
    f0, f1 = g0.numpy(), g1.numpy()
    kp0, d0 = f0["kpts"][f0["valid"]], f0["desc"][f0["valid"]]
    kp1, d1 = f1["kpts"][f1["valid"]], f1["desc"][f1["valid"]]
    if len(kp0) < 16 or len(kp1) < 16:
        return None

    gt1 = _warp_pts(Hm, kp0)
    m = 8
    vis = (gt1[:, 0] >= m) & (gt1[:, 0] < W - m) \
        & (gt1[:, 1] >= m) & (gt1[:, 1] < H - m)
    if vis.sum() < 32:
        return None
    dist = np.linalg.norm(gt1[vis][:, None] - kp1[None], axis=-1)
    nn = dist.argmin(1)
    rep = dist.min(1) < tol

    out = {"n_vis": int(vis.sum()), "repeatability": float(rep.mean())}
    if d0.dtype != np.uint8 and rep.any():
        true_l2 = np.linalg.norm(d0[vis][rep] - d1[nn[rep]], axis=-1)
        sim = np.linalg.norm(d0[vis][rep][:, None] - d1[None], axis=-1)
        distract = np.where(dist[rep] > 10.0, sim, np.inf).min(1)
        out["true_l2_p50"] = float(np.median(true_l2))
        out["distractor_l2_p50"] = float(np.median(distract))
        out["frac_true_under_gate"] = float((true_l2 < 0.8).mean())

    # the matcher's episode, over the full padded sets as in the pipeline
    if mat is not None:
        mm = mat.fn(g0, g1).numpy()
        sel = mm["valid"]
        if sel.any():
            p0 = f0["kpts"][mm["idx0"][sel]]
            p1 = f1["kpts"][mm["idx1"][sel]]
            err = np.linalg.norm(_warp_pts(Hm, p0) - p1, axis=-1)
            out["n_matches"] = int(sel.sum())
            out["match_precision"] = float((err < tol).mean())
            out["match_recall_vs_vis"] = float((err < tol).sum()
                                               / max(int(vis.sum()), 1))
        else:
            out["n_matches"] = 0
            out["match_precision"] = 0.0
            out["match_recall_vs_vis"] = 0.0
    return out


def _frontend(name: str, max_kp: int, min_conf: float, device=None):
    """(detector, matcher) of ``core/frontend.py`` for ``name`` on
    ``device``; the learned one with the trained tree."""
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.core.frontend import init_feature_pipeline

    argv = ["--dataset", "kitti", "--headless",
            "--max_features", str(max_kp), "--min_conf", str(min_conf)]
    if name == "learned":
        argv.append("--use_lightglue")
    else:
        argv += ["--detector", name]
    return init_feature_pipeline(parse_config(argv), device=device)


AGG_KEYS = ("repeatability", "true_l2_p50", "distractor_l2_p50",
            "frac_true_under_gate", "match_precision", "match_recall_vs_vis",
            "n_matches")


def eval_frontend(name, episodes, max_kp=1024, min_conf=0.7, verbose=True,
                  device=None):
    """Run one front-end over a shared episode list -> (aggregate, rows)."""
    det, mat = _frontend(name, max_kp, min_conf, device=device)
    rows = []
    for ep in episodes:
        r = evaluate_pair(det, mat, ep["img"], ep["H"], ep["photo"])
        if r is None:
            continue
        r["image"] = os.path.basename(ep["path"])
        rows.append(r)
        if verbose:
            print(f"[{name}] {r['image']}: rep={r['repeatability']:.2f} "
                  f"prec={r.get('match_precision', float('nan')):.2f} "
                  f"rec={r.get('match_recall_vs_vis', float('nan')):.2f} "
                  f"n={r.get('n_matches', 0)}", flush=True)
    if not rows:
        raise RuntimeError(f"no valid evaluation episodes for {name}")
    agg = {}
    for k in AGG_KEYS:
        vals = [e[k] for e in rows if k in e]
        if vals:
            agg[k] = float(np.mean(vals))
    agg["n_episodes"] = len(rows)
    return agg, rows


def run_eval(image_glob=DEFAULT_GLOB, n_images=31, warps=5, hw=None,
             classical=False, max_kp=1024, min_conf=0.7, seed=0,
             verbose=True, frontend=None, illum=True, device=None):
    """One front-end's evaluation over the first ``n_images`` matches of
    ``image_glob``; ``classical=True`` means ORB."""
    paths = sorted(globmod.glob(image_glob))[:n_images]
    if not paths:
        raise FileNotFoundError(f"no images match {image_glob}")
    episodes = build_episodes(paths, warps, hw, seed=seed, illum=illum)
    name = frontend or ("orb" if classical else "learned")
    agg, rows = eval_frontend(name, episodes, max_kp, min_conf, verbose,
                              device=device)
    agg["n_images"] = len(paths)
    return agg, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser("real_eval")
    p.add_argument("--glob", default=DEFAULT_GLOB)
    p.add_argument("--n", type=int, default=31)
    p.add_argument("--warps", type=int, default=5)
    p.add_argument("--hw", type=int, nargs=2, default=None,
                   help="resize images to H W before eval")
    p.add_argument("--frontend", default="learned",
                   choices=["learned", "orb", "akaze", "sift"])
    p.add_argument("--classical", action="store_true",
                   help="alias for --frontend orb")
    p.add_argument("--compare", action="store_true",
                   help="run learned + ORB + AKAZE on identical episodes")
    p.add_argument("--no_illum", action="store_true",
                   help="disable the gain/bias/gamma illumination jitter")
    p.add_argument("--split", default="all",
                   choices=["all", "heldout", "train"],
                   help="photo split: 'heldout' = the even-indexed half "
                        "(disjoint from real-image training)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_kp", type=int, default=1024)
    p.add_argument("--min_conf", type=float, default=0.7)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run "
                        "there)")
    a = p.parse_args(argv)
    from simpleslam_tpu_torch.utils.device import resolve_device
    device = resolve_device(a.device)

    paths = select_split(globmod.glob(a.glob), a.split)[:a.n]
    if not paths:
        raise FileNotFoundError(f"no images match {a.glob}")
    hw = tuple(a.hw) if a.hw else None
    episodes = build_episodes(paths, a.warps, hw, seed=a.seed,
                              illum=not a.no_illum)
    names = (["learned", "orb", "akaze"] if a.compare
             else ["orb" if a.classical else a.frontend])
    results = {}
    for name in names:
        agg, _rows = eval_frontend(name, episodes, a.max_kp, a.min_conf,
                                   verbose=not a.json, device=device)
        agg["n_images"] = len(paths)
        results[name] = agg

    if a.json:
        print(json.dumps(results if a.compare else results[names[0]]))
    elif a.compare:
        cols = ["repeatability", "match_precision", "match_recall_vs_vis",
                "n_matches"]
        print(f"\n{'frontend':<10}" + "".join(f"{c:>22}" for c in cols)
              + f"{'episodes':>10}")
        for name, agg in results.items():
            print(f"{name:<10}" + "".join(
                f"{agg.get(c, float('nan')):>22.4f}" for c in cols)
                + f"{agg['n_episodes']:>10d}")
    else:
        print("aggregate:", {k: (round(v, 4) if isinstance(v, float) else v)
                             for k, v in results[names[0]].items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
