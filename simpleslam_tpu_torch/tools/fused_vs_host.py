"""The CLI's host and ``--fused`` runs of one command, side by side.

:func:`compare_runs` holds a fused run to the host run of the same
command, with the statistics that ``tests/test_fused.py::
test_fused_matches_host`` bounds: the keyframe schedule, the largest
centre gap before the first keyframe after the bootstrap, the
Sim(3)-aligned shape of the fused centres against the host's (median and
largest distance, the scale's distance from 1), the ATE gap in units of
half the host's ATE (at least 0.05 m) and the map-size ratio.

As a script it renders a corridor sequence (``tools.synth``) and prints
one JSON line per run of ``run_slam.run`` over a list of flag variants and
RANSAC seeds, with each fused run compared to the host run of its seed:

    python -m simpleslam_tpu_torch.tools.fused_vs_host --frames 40 \\
        [--seeds 0,1,2,3] [--device cpu] [--out results.jsonl]

With ``--bootstrap`` it prints the bootstrap's two-view attempts instead
(:func:`bootstrap_probe`), with the device's RANSAC draws and with the
CPU's. With ``--lap`` it renders the reference's loop-closure lap (130
box-field frames at 180x410 on a rounded square, scene seed 5) and prints,
per RANSAC seed and draw source (the device's and the CPU's), the host and
``--fused`` runs of ``LAP_ARGV``: lost frames, closures, ATE and
:func:`compare_closures`:

    python -m simpleslam_tpu_torch.tools.fused_vs_host --lap --seeds 0,1,2,3

The variants (``VARIANTS``) separate what the fused loop's ATE at the
CLI's defaults depends on: the BA window's point slice, the keypoint
budget, the map capacity, the LM iterations; ``sift`` and ``akaze`` are
the other detectors (``--variants sift,akaze --variant_seeds 0,1,2,3``
for their spread over RANSAC seeds).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from simpleslam_tpu_torch.core.trajectory_utils import umeyama_sim3


def _centres(res) -> dict:
    return {f: -p[:3, :3].T @ p[:3, 3]
            for f, p in zip(res.frame_ids, res.poses_cw)}


def compare_runs(host, fused) -> dict:
    """``fused`` (a ``SLAMResult`` of a ``--fused`` run) against ``host``
    (the same command without ``--fused``): ``same_keyframes``,
    ``common`` (frames posed by both), ``posed`` (frames posed by each),
    ``pre_kf`` (largest centre gap over
    the ``n_pre_kf`` frames between the bootstrap's second keyframe and
    the next keyframe), ``median``/``max`` (the Sim(3)-aligned fused
    centres' distance to the host's), ``scale_gap`` (|s - 1|), ``ate_gap``
    (|ATE_f - ATE_h| / (0.5 max(ATE_h, 0.05 m))) and ``landmarks`` (map
    size ratio, fused over host). Distances are in the map's units (the
    bootstrap's baseline is 1)."""
    ch, cf = _centres(host), _centres(fused)
    common = sorted(set(ch) & set(cf))
    boot, first_kf = (list(host.kf_frames) + [np.inf, np.inf])[1:3]
    pre = [f for f in common if boot < f < first_kf]
    A = np.stack([cf[f] for f in common])
    B = np.stack([ch[f] for f in common])
    s, R, t = umeyama_sim3(A, B)
    d = np.linalg.norm(s * A @ R.T + t - B, axis=1)
    return dict(
        same_keyframes=fused.kf_frames == host.kf_frames,
        common=len(common), posed=[len(host.poses_cw), len(fused.poses_cw)],
        pre_kf=max([float(np.linalg.norm(cf[f] - ch[f])) for f in pre]
                   or [float("inf")]),
        n_pre_kf=len(pre),
        median=float(np.median(d)), max=float(d.max()),
        scale_gap=float(abs(s - 1.0)),
        ate_gap=float(abs(fused.ate - host.ate)
                      / (0.5 * max(host.ate, 0.05))),
        landmarks=fused.n_landmarks / host.n_landmarks)


def compare_closures(host, fused) -> dict:
    """Two runs with one accepted closure each (``SLAMResult``s of either
    package): how far apart their candidate and current keyframes' frames
    are, the ratio of their measured scales, the frames both posed, and the
    median and largest distance of the Sim(3)-aligned fused centres from
    the host's (``tests/test_loop.py``'s host-against-fused statistics)."""
    ch, cf = host.closure_events[0], fused.closure_events[0]
    c_h, c_f = _centres(host), _centres(fused)
    common = sorted(set(c_h) & set(c_f))
    A = np.stack([c_f[f] for f in common])
    B = np.stack([c_h[f] for f in common])
    s, R, t = umeyama_sim3(A, B)
    d = np.linalg.norm(s * A @ R.T + t - B, axis=1)
    return {"cand_frames": abs(host.kf_frames[ch.cand_kf]
                               - fused.kf_frames[cf.cand_kf]),
            "cur_frames": abs(host.kf_frames[ch.cur_kf]
                              - fused.kf_frames[cf.cur_kf]),
            "scale_ratio": ch.scale / cf.scale, "common": len(common),
            "median": float(np.median(d)), "max": float(d.max())}


# the reference's loop-closure lap (tests/test_loop.py:477-545): its
# sequence and argv
LAP_SEQUENCE = dict(n_frames=130, seed=5, hw=(180, 410), scene="boxes",
                    trajectory="square")
LAP_ARGV = ["--dataset", "kitti", "--headless", "--no_viz3d",
            "--max_features", "512", "--map_capacity", "4096",
            "--loop_closure", "--loop_confirm", "1"]


# (name, extra flags) of the fused runs; each seed also runs the host
# command of its front-end
VARIANTS = (
    ("orb", []),
    ("orb_ba_whole_map", ["--fused_ba_points", "32768"]),
    ("orb_ba_slice_8192", ["--fused_ba_points", "8192"]),
    ("orb_lm_8", ["--local_ba_max_iters", "8"]),
    ("orb_kp_2048", ["--max_features", "2048"]),
    ("orb_map_8192", ["--map_capacity", "8192"]),
    ("learned", ["--use_lightglue", "--tri_kf2"]),
    ("learned_ba_whole_map", ["--use_lightglue", "--tri_kf2",
                              "--fused_ba_points", "32768"]),
    ("sift", ["--detector", "sift"]),
    ("akaze", ["--detector", "akaze"]),
)


def front_flags(flags: list) -> list:
    """The flags of ``flags`` that choose the front-end (the host run a
    fused variant is compared with runs these alone)."""
    return [f for i, f in enumerate(flags)
            if f in ("--use_lightglue", "--tri_kf2", "--detector")
            or (i and flags[i - 1] == "--detector")]


class HostDrawKey:
    """A ``TorchKey`` whose draws are made on the CPU and then moved to the
    device: the CPU's RANSAC samples, whatever device evaluates them."""

    def __init__(self, key):
        self.key = key

    def fold_in(self, data):
        return HostDrawKey(self.key.fold_in(data))

    def split(self, num=2):
        return tuple(HostDrawKey(k) for k in self.key.split(num))

    def randint(self, shape, high, device):
        high = high.cpu() if hasattr(high, "cpu") else high
        return self.key.randint(shape, high, "cpu").to(device)


def bootstrap_probe(seq, argv, seed: int, device, host_draws: bool = False,
                    n_frames: int = 6) -> list:
    """The host bootstrap over the first ``n_frames`` frames of ``seq``:
    per two-view attempt, the frame, the H and F scores and the F model's
    cheirality count, positive-depth share and parallax (the gates the
    bootstrap holds them to: ``--bootstrap_min_posdepth``,
    ``--bootstrap_min_parallax_deg``), its unit translation ``F_t``, and
    whether it initialised.
    ``host_draws``: RANSAC samples drawn on the CPU (:class:`HostDrawKey`)."""
    from simpleslam_tpu_torch import run_slam
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.core import bootstrap
    from simpleslam_tpu_torch.utils.rng import TorchKey
    cfg = parse_config(argv + ["--seed", str(seed)])
    key = HostDrawKey(TorchKey(cfg.seed)) if host_draws else None
    system = run_slam.SLAMSystem(cfg, seq.K, seq.D,
                                 img_hw=seq.frame(0).shape[:2],
                                 device=device, key=key)
    rows, frame = [], [0]
    evaluate = bootstrap.evaluate_two_view

    def recorded(*a, **kw):
        out = evaluate(*a, **kw)
        rows.append(dict(frame=frame[0], F_t=out["F_t"].tolist(), **{
            k: float(out[k]) for k in ("S_H", "S_F", "ratio_H", "F_n_cheir",
                                       "F_posdepth", "F_parallax")}))
        return out

    bootstrap.evaluate_two_view = recorded
    try:
        prev = None
        for i in range(n_frames):
            frame[0] = i
            prev = system.process_frame(i, seq.frame(i), prev)
            if system.initialised:
                rows[-1]["initialised"] = True
                break
    finally:
        bootstrap.evaluate_two_view = evaluate
    return rows


def _summary(res) -> dict:
    return dict(ate_m=res.ate, keyframes=res.n_keyframes,
                kf_frames=res.kf_frames, lost=res.tracking_lost_count,
                map_points=res.n_landmarks, frames_per_s=res.fps)


def closure_records(res) -> list:
    """A run's accepted closures, with their keyframes' frames."""
    return [dict(cur_kf=e.cur_kf, cand_kf=e.cand_kf,
                 cur_frame=res.kf_frames[e.cur_kf],
                 cand_frame=res.kf_frames[e.cand_kf], scale=e.scale,
                 n_inliers=e.n_inliers, similarity=e.similarity,
                 cost_before=e.cost_before, cost_after=e.cost_after,
                 max_pose_delta=e.max_pose_delta)
            for e in res.closure_events]


def _lap_runs(a, seeds, out) -> None:
    """``--lap``: host and fused runs of LAP_ARGV per seed and draw
    source."""
    from simpleslam_tpu_torch import run_slam
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.tools import synth
    from simpleslam_tpu_torch.utils.rng import TorchKey
    with tempfile.TemporaryDirectory() as tmp:
        base = synth.generate_kitti_sequence(
            os.path.join(tmp, "lap"), device=a.device, **LAP_SEQUENCE)
        os.chdir(tmp)
        for seed in seeds:
            for host_draws in (False, True):
                runs = {}
                for mode in ("host", "fused"):
                    cfg = parse_config(["--base_dir", base] + LAP_ARGV + (
                        ["--fused"] if mode == "fused" else [])
                        + ["--seed", str(seed)])
                    key = HostDrawKey(TorchKey(seed)) if host_draws else None
                    t0 = time.time()
                    runs[mode] = res = run_slam.run(cfg, device=a.device,
                                                    key=key)
                    _emit(out, dict(run="lap", mode=mode, seed=seed,
                                    device=a.device or "cuda",
                                    host_draws=host_draws,
                                    run_s=time.time() - t0,
                                    closures=closure_records(res),
                                    frames_posed=len(res.poses_cw),
                                    **_summary(res)))
                if all(r.loop_closures == 1 for r in runs.values()):
                    _emit(out, dict(run="lap_host_vs_fused", seed=seed,
                                    host_draws=host_draws,
                                    **compare_closures(runs["host"],
                                                       runs["fused"])))


def main(argv=None) -> int:
    from simpleslam_tpu_torch.tools import synth
    p = argparse.ArgumentParser("fused_vs_host")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--hw", type=int, nargs=2, default=list(synth.DEFAULT_HW))
    p.add_argument("--seeds", default="0,1,2,3",
                   help="RANSAC seeds of the plain ORB and learned variants")
    p.add_argument("--variant_seeds", default="0",
                   help="RANSAC seeds of the other variants")
    p.add_argument("--variants", default=",".join(v for v, _ in VARIANTS))
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' for the CPU")
    p.add_argument("--out", default=None, help="also append the lines here")
    p.add_argument("--bootstrap", action="store_true",
                   help="only the bootstrap's two-view attempts of the "
                        "chosen variants' front-ends per seed, with the "
                        "device's and the CPU's RANSAC draws")
    p.add_argument("--lap", action="store_true",
                   help="the loop-closure lap's host and fused runs per "
                        "seed instead (LAP_ARGV), with the device's and "
                        "the CPU's RANSAC draws")
    a = p.parse_args(argv)
    chosen = [v for v in VARIANTS if v[0] in a.variants.split(",")]
    seeds = [int(s) for s in a.seeds.split(",")]
    variant_seeds = [int(s) for s in a.variant_seeds.split(",")]
    cwd = os.getcwd()
    out = open(a.out, "a") if a.out else None
    try:
        if a.lap:
            _lap_runs(a, seeds, out)
        else:
            _runs(a, chosen, seeds, variant_seeds, out)
    finally:
        os.chdir(cwd)
        if out:
            out.close()
    return 0


def _runs(a, chosen, seeds, variant_seeds, out) -> None:
    """:func:`main`'s work, in a temporary directory."""
    from simpleslam_tpu_torch import run_slam
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.tools import synth
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "synth")
        synth.main(["--out", base, "--frames", str(a.frames), "--hw",
                    str(a.hw[0]), str(a.hw[1])]
                   + (["--device", a.device] if a.device else []))
        os.chdir(tmp)                  # run writes its plot where it runs
        readme = ["--dataset", "kitti", "--base_dir", base, "--headless",
                  "--no_viz3d"]
        if a.bootstrap:
            from simpleslam_tpu_torch.data import Sequence
            seq = Sequence.load(parse_config(readme))
            fronts = []
            for _name, flags in chosen:
                if front_flags(flags) not in fronts:
                    fronts.append(front_flags(flags))
            for front in fronts:
                for seed in seeds:
                    for host_draws in (False, True):
                        _emit(out, dict(
                            run="bootstrap", flags=front, seed=seed,
                            device=a.device or "cuda", host_draws=host_draws,
                            attempts=bootstrap_probe(seq, readme + front,
                                                     seed, a.device,
                                                     host_draws)))
            return
        hosts = {}
        for name, flags in chosen:
            plain = name in ("orb", "learned")
            front = front_flags(flags)
            for seed in (seeds if plain else variant_seeds):
                key = (tuple(front), seed)
                if key not in hosts:
                    t0 = time.time()
                    hosts[key] = run_slam.run(parse_config(
                        readme + front + ["--seed", str(seed)]),
                        device=a.device)
                    _emit(out, dict(run="host", flags=front, seed=seed,
                                    run_s=time.time() - t0,
                                    **_summary(hosts[key])))
                t0 = time.time()
                res = run_slam.run(parse_config(
                    readme + flags + ["--fused", "--seed", str(seed)]),
                    device=a.device)
                _emit(out, dict(run=name, flags=flags, seed=seed,
                                run_s=time.time() - t0, **_summary(res),
                                vs_host=compare_runs(hosts[key], res)))


def _emit(out, rec: dict) -> None:
    line = json.dumps(rec, default=float)
    print(line, flush=True)
    if out:
        out.write(line + "\n")


if __name__ == "__main__":
    raise SystemExit(main())
