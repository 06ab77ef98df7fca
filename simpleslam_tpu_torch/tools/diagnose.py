"""Pipeline diagnostics: each stage of the SLAM loop measured on its own
(the counterpart of ``simpleslam_tpu/tools/diagnose.py``).

  * ``desc`` -- keypoint repeatability and true-match against distractor
                descriptor distance across view gaps, at training and
                pipeline resolution (is the front-end scale-robust?);
  * ``tri``  -- where keyframe-pair matches die: matcher -> F-RANSAC ->
                each triangulation gate (is map replenishment starving?);
  * ``e2e``  -- the fused device loop over a synthetic full-scale sequence
                with the per-frame (tracked, kf, n_inl, n_new, n_cand, ba)
                log and the ATE (where does tracking die?);
  * ``ba``   -- local-BA solves/s and latency per iteration count.

Each probe is a function (``probe_desc``, ``probe_tri``, ``probe_e2e``,
``probe_ba``) that returns its numbers and a ``cmd_*`` that prints the
reference's lines. Frames for the full-scale probes are rendered once on
the device and cached under the temporary directory
(``slam_torch_synth_frames_*.npz``, apart from the reference's cache,
which holds its own renderer's frames); ``e2e`` writes its trajectory to
``slam_torch_diag_e2e_traj.npz`` there.

Every probe runs on the GPU unless ``--device cpu`` asks for the CPU.

Usage: python -m simpleslam_tpu_torch.tools.diagnose <desc|tri|e2e|ba>
       [options] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

TRI_PAIRS = ((4, 10), (10, 16), (20, 26))
DESC_SIZES = ((144, 256, 512), (376, 1232, 2048))   # (H, W, keypoints)
BA_SIZE = (10, 2048, 16384)                         # (P, L, E)


def _scaled_K(H: int, W: int) -> np.ndarray:
    """The KITTI camera scaled to a (H, W) render, as ``bench.py`` does."""
    from simpleslam_tpu_torch.tools.synth import DEFAULT_K
    s = W / 1232.0
    K = DEFAULT_K.copy()
    K[0] *= s
    K[1] *= s
    K[1, 2] = 0.487 * H
    return K


def full_scale_frames(H=376, W=1232, n=40, yaw=0.3, seed=0,
                      scene="corridor", device=None):
    """(frames (n, H, W) uint8 numpy, K, T_wc) of the probes' sequence,
    rendered on ``device`` once and then read from the cache. Past ~85
    frames at the default yaw the camera leaves the corridor; long runs
    take a gentler ``yaw`` (0 stays inside)."""
    from simpleslam_tpu_torch.tools.synth import (SCENE_FAMILIES,
                                                  make_trajectory,
                                                  renderer_version)
    K = _scaled_K(H, W)
    T = make_trajectory(n, speed=0.5, yaw_rate_deg=yaw)
    tag = "" if (seed == 0 and scene == "corridor") else f"_{scene}{seed}"
    ytag = "" if yaw == 0.3 else f"_y{yaw}"
    cache = os.path.join(tempfile.gettempdir(),
                         f"slam_torch_synth_frames_{H}x{W}_{n}{tag}{ytag}_"
                         f"{renderer_version()}.npz")
    if os.path.exists(cache):
        frames = np.load(cache)["frames"]
    else:
        print(f"rendering {n} {scene} frames (seed {seed}) at {H}x{W}...",
              flush=True)
        sc = SCENE_FAMILIES[scene](seed=seed, hw=(H, W), K=K, device=device)
        frames = np.stack([sc.render(T[i]).cpu().numpy() for i in range(n)])
        np.savez_compressed(cache, frames=frames)
    return frames, K, T


# --------------------------------------------------------------------------- #
# desc
# --------------------------------------------------------------------------- #

def probe_desc(seed: int = 0, scene: str = "corridor", device=None,
               sizes=None) -> list:
    """Per (size, gap), gaps 1, 3 and 6 over 10 views: the reprojected
    keypoints of view 0 visible in view ``gap``, the share with a keypoint there within 3 px, the true
    matches' descriptor distance (p50, p90), the nearest distractor's
    (more than 10 px away) and the share of true distances below 0.8.
    ``sizes``: (H, W, keypoints) triples, default DESC_SIZES. ALIKED
    restores the trained tree."""
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.models import pipeline as pipe_mod
    from simpleslam_tpu_torch.tools.synth import (SCENE_FAMILIES,
                                                  make_trajectory)
    from simpleslam_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    rows = []
    for (H, W, n_kp) in sizes or DESC_SIZES:
        K = _scaled_K(H, W)
        sc = SCENE_FAMILIES[scene](seed=seed, hw=(H, W), K=K, device=dev)
        T = make_trajectory(10, speed=0.5, yaw_rate_deg=0.3)
        rend = [tuple(t.cpu().numpy() for t in sc.render_with_geometry(T[i]))
                for i in range(10)]
        cfg = parse_config(["--dataset", "kitti", "--headless",
                            "--max_features", str(n_kp), "--use_lightglue"])
        det = pipe_mod.build_learned_extractor(
            cfg, ((n_kp + 127) // 128) * 128, device=dev)
        feats = [det.fn(torch.as_tensor(r[0], device=dev).float()).numpy()
                 for r in rend]
        for gap in (1, 3, 6):
            f0, f1 = feats[0], feats[gap]
            _, hit0, _ = rend[0]
            _, _, depth1 = rend[gap]
            kp0 = f0["kpts"][f0["valid"]]
            d0 = f0["desc"][f0["valid"]]
            xs = np.clip(kp0[:, 0].round().astype(int), 0, W - 1)
            ys = np.clip(kp0[:, 1].round().astype(int), 0, H - 1)
            Xw = hit0[ys, xs]
            T1cw = np.linalg.inv(T[gap])
            Xc = Xw @ T1cw[:3, :3].T + T1cw[:3, 3]
            z = Xc[:, 2]
            uv = (Xc[:, :2] / np.maximum(z[:, None], 1e-6)) \
                * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
            vi = np.clip(uv[:, 1].astype(int), 0, H - 1)
            ui = np.clip(uv[:, 0].astype(int), 0, W - 1)
            r1 = np.linalg.norm(Xc, axis=1)
            occl = np.abs(depth1[vi, ui] - r1) < 0.1 * np.maximum(r1, 1.0)
            inb = (z > 0.2) & (uv[:, 0] >= 8) & (uv[:, 0] < W - 8) \
                & (uv[:, 1] >= 8) & (uv[:, 1] < H - 8) & occl
            kp1 = f1["kpts"][f1["valid"]]
            d1 = f1["desc"][f1["valid"]]
            dist = np.linalg.norm(uv[inb][:, None, :] - kp1[None], axis=-1)
            nn = dist.argmin(1)
            rep = dist.min(1) < 3.0
            dd = np.linalg.norm(d0[inb][rep] - d1[nn[rep]], axis=-1)
            sim = np.linalg.norm(d0[inb][rep][:, None, :] - d1[None],
                                 axis=-1)
            distract = np.where(dist[rep] > 10.0, sim, np.inf).min(1)
            rows.append(dict(
                hw=[H, W], gap=gap, visible=int(inb.sum()),
                repeat=float(rep.mean()), true_p50=float(np.median(dd)),
                true_p90=float(np.percentile(dd, 90)),
                distractor_p50=float(np.median(distract)),
                frac_true_below_0_8=float(np.mean(dd < 0.8))))
    return rows


def cmd_desc(a) -> int:
    """Repeatability + descriptor separation across gaps and resolutions."""
    for r in probe_desc(a.seed, a.scene, a.device):
        H, W = r["hw"]
        print(f"[{H}x{W}] gap={r['gap']}: visible={r['visible']} "
              f"repeat={r['repeat']:.2f} "
              f"trueL2 p50={r['true_p50']:.3f} "
              f"p90={r['true_p90']:.3f} "
              f"distractorL2 p50={r['distractor_p50']:.3f} "
              f"frac_true<0.8={r['frac_true_below_0_8']:.2f}", flush=True)
    return 0


# --------------------------------------------------------------------------- #
# tri
# --------------------------------------------------------------------------- #

def probe_tri(seed: int = 0, scene: str = "corridor", learned: bool = True,
              min_conf: float = 0.7, device=None, pairs=TRI_PAIRS,
              key=None, weights=None) -> list:
    """Per keyframe pair (i, j): raw matches, F-RANSAC survivors,
    triangulations kept by every gate and the count each gate rejects.
    ``key``: the F-RANSAC randomness (default ``TorchKey(0)``, the
    reference filter's default seed); ``weights``: (aliked, lightglue)
    state dicts, else the trained tree."""
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.core.frontend import (filter_matches_ransac,
                                                    init_feature_pipeline)
    from simpleslam_tpu_torch.ops.triangulation import (projection_matrix,
                                                        triangulate_two_view,
                                                        two_view_gates)
    from simpleslam_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    frames, K, T_wc = full_scale_frames(seed=seed, scene=scene, device=dev)
    argv = ["--dataset", "kitti", "--headless", "--max_features", "2048"]
    if learned:
        argv += ["--use_lightglue", "--min_conf", str(min_conf)]
    cfg = parse_config(argv)
    det, mat = init_feature_pipeline(cfg, device=dev, weights=weights)
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)

    def t32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    rows = []
    for (i, j) in pairs:
        f0 = det.fn(torch.as_tensor(frames[i], device=dev).float())
        f1 = det.fn(torch.as_tensor(frames[j], device=dev).float())
        m = mat.fn(f0, f1)
        n_raw = int(m.valid.sum())
        mr = filter_matches_ransac(f0, f1, m, cfg.ransac_thresh, key=key)
        T0 = np.linalg.inv(T_wc[i])
        T1 = np.linalg.inv(T_wc[j])
        uv0 = f0.kpts[mr.idx0]
        uv1 = f1.kpts[mr.idx1]
        X = triangulate_two_view(projection_matrix(Kt, t32(T0)),
                                 projection_matrix(Kt, t32(T1)), uv0, uv1)
        keep, why = two_view_gates(
            X, Kt, t32(T0), t32(T1), uv0, uv1, min_depth=cfg.min_depth,
            max_depth=cfg.max_depth,
            min_parallax_deg=cfg.triangulation_parallax_min_deg,
            max_reproj_px=cfg.mvt_rep_err)
        rows.append(dict(
            pair=[i, j], raw=n_raw, ransac=int(mr.valid.sum()),
            tri_keep=int((keep & mr.valid).sum()),
            why={k: int((v & mr.valid).sum()) for k, v in why.items()}))
    return rows


def cmd_tri(a) -> int:
    """KF-pair match attrition through RANSAC + triangulation gates."""
    for r in probe_tri(a.seed, a.scene, a.learned, a.min_conf, a.device):
        i, j = r["pair"]
        print(f"pair ({i},{j}): raw={r['raw']} ransac={r['ransac']} "
              f"tri_keep={r['tri_keep']} why={r['why']}", flush=True)
    return 0


# --------------------------------------------------------------------------- #
# e2e
# --------------------------------------------------------------------------- #

def e2e_argv(learned: bool = True, min_conf: float = 0.7,
             tri_kf2: bool = False, capacity: int = 8192,
             extra: str = "") -> list:
    """The run_slam argv the e2e probe configures."""
    argv = ["--dataset", "kitti", "--headless", "--no_viz3d",
            "--max_features", "2048", "--map_capacity", str(capacity)]
    if learned:
        argv += ["--use_lightglue", "--min_conf", str(min_conf)]
    if tri_kf2:
        argv += ["--tri_kf2"]
    return argv + (extra.split() if extra else [])


def probe_e2e(frames: np.ndarray, K: np.ndarray, T_wc: np.ndarray,
              argv: list, device=None, stage_all: bool = False,
              weights=None,
              launches: Optional[Callable[[], int]] = None,
              traj_path: Optional[str] = None,
              verbose: bool = False) -> dict:
    """The host bootstrap on ``frames`` (uint8), then the fused step over
    the rest. Returns the bootstrap frame, the per-frame log rows
    (frame, tracked, kf, n_inl, n_new, n_cand, ba), seconds, the ATE
    (Sim(3)) against ``T_wc`` over every posed frame, lost frames, map
    size, keyframes, compactions, the matcher's calls during the bootstrap
    and in all, and with ``launches`` (a counter read after the bootstrap
    and at the end) the launches in the fused loop. ``stage_all``: every
    frame on the device before the loop. ``traj_path``: where to save
    the trajectory (npz)."""
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.run_slam import SLAMSystem, build_fused_loop
    from simpleslam_tpu_torch.tools.trajectory_eval import ate_rmse
    from simpleslam_tpu_torch.utils.device import resolve_device

    def say(msg):
        if verbose:
            print(msg, flush=True)

    dev = resolve_device(device)
    n_frames = len(frames)
    cfg = parse_config(argv)
    H, W = frames.shape[1:3]
    system = SLAMSystem(cfg, K, None, img_hw=(H, W), device=dev,
                        weights=weights)
    prev = system.process_frame(0, frames[0], None)
    start = 1
    while start < n_frames and not system.initialised:
        prev = system.process_frame(start, frames[start], prev)
        start += 1
    out = {"bootstrap_frame": start - 1 if system.initialised else None,
           "map_bootstrap": len(system.world_map)}
    say(f"bootstrapped at {start - 1}; map={len(system.world_map)}")
    if not system.initialised:
        return out
    calls_boot = getattr(system.matcher, "calls", 0)
    n_boot = launches() if launches else None
    _fc, step, state = build_fused_loop(cfg, system, prev, n_frames)
    staged = None
    if stage_all:
        say(f"staging {n_frames - start} frames on device "
            f"({(n_frames - start) * frames[0].nbytes / 1e6:.0f} MB)...")
        t_up = time.perf_counter()
        staged = [torch.as_tensor(frames[i], device=dev)
                  for i in range(start, n_frames)]
        staged[-1].sum().item()
        out["staged_s"] = time.perf_counter() - t_up
        say(f"staged in {out['staged_s']:.0f}s")
    t0 = time.perf_counter()
    t_warm = None
    for i in range(start, n_frames):
        img = staged[i - start] if staged is not None \
            else torch.as_tensor(frames[i], device=dev)
        state = step(state, img)
        if i == start + 9:
            state.Tcw.sum().item()          # observe the first 10 frames
            t_warm = time.perf_counter()
    flags = state.log_flags.cpu().numpy()
    frames_log = state.log_frame.cpu().numpy()
    n = int(state.log_n)
    out["loop_s"] = time.perf_counter() - t0
    if t_warm is not None and n_frames - start > 20:
        out["sustained_frames_per_s"] = (n_frames - start - 10) / (
            time.perf_counter() - t_warm)
    out["log"] = [[int(frames_log[i])] + [int(v) for v in flags[i][:6]]
                  for i in range(n)]
    est = {fi: np.asarray(p) for fi, p in
           zip(system.frame_ids, system.world_map.poses)}
    log_pose = state.log_pose.cpu().numpy()
    for i in range(n):
        if frames_log[i] >= 0:
            est[int(frames_log[i])] = log_pose[i]
    fids = sorted(est.keys())
    est_T = np.stack([est[f] for f in fids])
    if traj_path:
        np.savez(traj_path, est_T=est_T, fids=np.asarray(fids),
                 gt_T=T_wc[fids])
    ate, stats = ate_rmse(est_T, T_wc[fids][:, :3, :4], align="sim3")
    out.update(
        frames_fused=n, ate_m=float(ate), ate_frames=len(fids),
        scale=float(stats.get("scale", 0.0)),
        lost=n - int(flags[:n, 0].sum()), map_points=int(state.n_points),
        keyframes=int(state.kf_count), compactions=int(state.compactions),
        matcher_calls_bootstrap=calls_boot,
        matcher_calls=getattr(system.matcher, "calls", 0),
        host_reads=step.host_reads, finite=bool(np.isfinite(est_T).all()))
    if launches:
        out["launches_fused_loop"] = launches() - n_boot
    return out


def cmd_e2e(a) -> int:
    """Fused loop over the full-scale synthetic sequence, per-frame log."""
    from simpleslam_tpu_torch.utils.device import resolve_device
    dev = resolve_device(a.device)
    frames, K, T_wc = full_scale_frames(n=a.frames, yaw=a.yaw, seed=a.seed,
                                        scene=a.scene, device=dev)
    r = probe_e2e(frames, K, T_wc,
                  e2e_argv(a.learned, a.min_conf, a.tri_kf2, a.capacity,
                           a.extra), device=dev, stage_all=a.stage_all,
                  traj_path=os.path.join(tempfile.gettempdir(),
                                         "slam_torch_diag_e2e_traj.npz"),
                  verbose=True)
    if r["bootstrap_frame"] is None:
        print("bootstrap FAILED")
        return 1
    print(f"ran {r['frames_fused']} frames in {r['loop_s']:.1f}s "
          f"(incl warm-up)")
    if "sustained_frames_per_s" in r:
        print(f"sustained (post-warm-up) {r['sustained_frames_per_s']:.2f} "
              f"frames/s over {len(frames) - r['bootstrap_frame'] - 11} "
              f"frames")
    print("frame tracked kf n_inl n_new n_cand ba")
    for row in r["log"][::max(1, a.log_every)]:
        f, tr, kf, ninl, nnew, ncand, ba = row
        print(f"{f:5d} {tr:7d} {kf:2d} {ninl:5d} {nnew:5d} {ncand:6d} "
              f"{ba:2d}")
    print(f"ATE-RMSE (Sim3): {r['ate_m']:.4f} m over {r['ate_frames']} "
          f"frames (scale {r['scale']:.3f}), {r['lost']} lost, "
          f"map {r['map_points']} pts, {r['keyframes']} KFs, "
          f"{r['compactions']} compactions")
    return 0


# --------------------------------------------------------------------------- #
# ba
# --------------------------------------------------------------------------- #

def ba_problem(device):
    """(BAProblem, K): the probe's synthetic window of BA_SIZE (P, L, E)
    cameras, points and edges, drawn from
    ``numpy.random.default_rng(0)`` as the reference draws it."""
    from simpleslam_tpu_torch.ops.ba import BAProblem
    P_, L_, E_ = BA_SIZE
    rngb = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    pts = torch.as_tensor(np.stack([rngb.uniform(-5, 5, L_),
                                    rngb.uniform(-3, 3, L_),
                                    rngb.uniform(4, 30, L_)], 1), **f32)
    poses = torch.as_tensor(np.tile(np.eye(4), (P_, 1, 1)), **f32)
    poses[:, 0, 3] = torch.arange(P_, **f32) * 0.3
    cam_idx = torch.as_tensor(rngb.integers(0, P_, E_), dtype=torch.int64,
                              device=device)
    pt_idx = torch.as_tensor(rngb.integers(0, L_, E_), dtype=torch.int64,
                             device=device)
    K = torch.as_tensor([[707.0, 0, 601.0], [0, 707.0, 183.0],
                         [0, 0, 1.0]], **f32)
    pc = torch.einsum("eij,ej->ei", poses[cam_idx][:, :3, :3],
                      pts[pt_idx]) + poses[cam_idx][:, :3, 3]
    uv = (pc[:, :2] / pc[:, 2:3]) * 707.0 + torch.as_tensor([601.0, 183.0],
                                                            **f32)
    uv = uv + torch.as_tensor(rngb.normal(0, 0.5, (E_, 2)), **f32)
    cam_free = torch.ones(P_, dtype=torch.bool, device=device)
    cam_free[0] = False
    return BAProblem(poses=poses, points=pts, cam_idx=cam_idx, pt_idx=pt_idx,
                     uv=uv, e_valid=torch.ones(E_, dtype=torch.bool,
                                               device=device),
                     cam_free=cam_free,
                     pt_free=torch.ones(L_, dtype=torch.bool,
                                        device=device)), K


def probe_ba(device=None, rounds: int = 3, iters=(1, 4, 12)) -> dict:
    """The warm solve's costs and good iterations; ``rounds`` rounds of 5
    solves (solves/s, each on uv moved by 1e-6 px so none repeats
    another); seconds a solve at each ``iters`` LM iteration count, on
    :func:`ba_problem`'s window."""
    from simpleslam_tpu_torch.ops.ba import ba_solve
    from simpleslam_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    prob, Kb = ba_problem(dev)
    out = ba_solve(prob, Kb, huber=2.0, max_iters=12)
    res = {"cost_initial": float(out[2]), "cost_final": float(out[3]),
           "good_iters": int(out[4]), "rounds": [], "s_per_solve": {}}
    for _rep in range(rounds):
        t0 = time.perf_counter()
        tot = sum(ba_solve(prob._replace(uv=prob.uv + 1e-6 * (r + 1)), Kb,
                           huber=2.0, max_iters=12)[3] for r in range(5))
        float(tot)
        dt = time.perf_counter() - t0
        res["rounds"].append({"s": dt, "solves_per_s": 5 / dt})
    for it in iters:
        float(ba_solve(prob, Kb, huber=2.0, max_iters=it)[3])
        t0 = time.perf_counter()
        for _r in range(2):
            float(ba_solve(prob, Kb, huber=2.0, max_iters=it)[3])
        res["s_per_solve"][int(it)] = (time.perf_counter() - t0) / 2
    return res


def cmd_ba(a) -> int:
    """Local-BA solves/s + iteration-count latency scaling."""
    r = probe_ba(a.device)
    print(f"warm: cost {r['cost_initial']:.1f} -> {r['cost_final']:.1f}, "
          f"good iters {r['good_iters']}", flush=True)
    for rep, rd in enumerate(r["rounds"]):
        print(f"round {rep}: 5 solves in {rd['s']:.3f}s -> "
              f"{rd['solves_per_s']:.2f} solves/s", flush=True)
    for it, s in r["s_per_solve"].items():
        print(f"max_iters={it:2d}: {s:.3f}s/solve", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The reference's subcommands and flags, plus ``--device``."""
    p = argparse.ArgumentParser("diagnose")
    sub = p.add_subparsers(dest="cmd", required=True)
    spd = sub.add_parser("desc")
    for name in ("tri", "e2e"):
        sp = sub.add_parser(name)
        sp.add_argument("--learned", action="store_true", default=True)
        sp.add_argument("--classical", dest="learned", action="store_false")
        sp.add_argument("--min_conf", type=float, default=0.7)
        if name == "e2e":
            sp.add_argument("--tri_kf2", action="store_true")
            sp.add_argument("--frames", type=int, default=40)
            sp.add_argument("--yaw", type=float, default=0.3)
            sp.add_argument("--capacity", type=int, default=8192)
            sp.add_argument("--log_every", type=int, default=1,
                            help="print every Nth per-frame log row")
            sp.add_argument("--extra", default="",
                            help="extra run_slam CLI flags, space-separated")
            sp.add_argument("--stage_all", action="store_true",
                            help="upload every frame to the device before "
                                 "the loop, so it times the fused step "
                                 "and not the host-to-device copies")
    sub.add_parser("ba")
    # held-out evaluation: scene seeds >= 100 and the 'boxes' family are
    # outside the training pool
    for sp in (spd, *(s for s in sub.choices.values() if s is not spd)):
        sp.add_argument("--seed", type=int, default=0,
                        help="scene seed (training pool is seeds 0-3)")
        sp.add_argument("--scene", choices=("corridor", "boxes", "photo"),
                        default="corridor")
        sp.add_argument("--device", default=None,
                        help="default: the GPU; 'cpu' for the CPU")
    return p


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    return {"desc": cmd_desc, "tri": cmd_tri,
            "e2e": cmd_e2e, "ba": cmd_ba}[a.cmd](a)


if __name__ == "__main__":
    raise SystemExit(main())
