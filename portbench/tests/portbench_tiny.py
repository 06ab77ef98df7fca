"""Tiny cells for the CPU tests: files written into a directory that the
harness searches before the package, with seeded weights."""
import io
import json
import os

from portbench import harness, run

PAIRS_CFG = {
    "name": "tiny", "source": "test",
    "aliked": {"channels": [8, 8, 16, 16], "desc_dim": 16},
    "lightglue": {"dim": 32, "heads": 2, "head_dim": 16, "layers": 1},
    "image_hw": [64, 96], "max_keypoints": 32, "min_conf": 0.0,
    "weights": None, "seeded_std": 0.1, "reduced": []}
TRAIN_CFG = {
    "name": "tinytrain", "source": "test",
    "aliked": {"channels": [32, 64, 128, 128], "desc_dim": 16},
    "lightglue": {"dim": 32, "heads": 4, "head_dim": 8, "layers": 1},
    # LightGlue's draws wide enough that its attention is not uniform, so
    # the queries' and keys' gradients are not nought
    "image_hw": [64, 96], "weights": None,
    "seeded_std": {"aliked": 0.05, "lightglue": 0.2},
    "reduced": [],
    "train": {"batch_pairs": 2, "points": 16, "lr": 2e-4, "warmup": 100,
              "total_steps": 4000, "scene_views": 4, "scenes": 2,
              "families": ["corridor"]}}
PAIRS_CELL = {
    "name": "tiny.pairs", "config": "tiny", "driver": "pairs", "chips": 1,
    "why": "test",
    "traffic": {"frames": 5, "frames_per_call": 3, "speed_m": 0.5,
                "closure_frac": 0.8, "corner_frames": 24,
                "K": [[55.0, 0.0, 48.0], [0.0, 55.0, 31.0],
                      [0.0, 0.0, 1.0]],
                "sample_calls": 2, "ref_block": 2},
    # the seeded tiny matcher's mutual matches clear their runners-up by
    # 0.001-0.2 nats, and rounding moves its assignment by under 0.005
    "lost_margin": 0.01,
    "trace_calls": 1}
TRAIN_CELL = {
    "name": "tiny.train", "config": "tinytrain", "driver": "train",
    "chips": 1, "why": "test",
    "traffic": {"ring": 4, "check_steps": 3, "ref_block": 1},
    "trace_calls": 1}
REAL = {"tiny.pairs": "lightglue-kitti-2048.pairs-b32",
        "tiny.train": "lightglue-train-2048.b16"}


def write(root, sub, name, obj):
    os.makedirs(os.path.join(root, sub), exist_ok=True)
    with open(os.path.join(root, sub, name + ".json"), "w") as f:
        json.dump(obj, f)


def files(root, bench=None):
    """Tiny cells under ``root`` with the real cells' limits."""
    for cell in (PAIRS_CELL, TRAIN_CELL):
        limits = harness.Files().json("workloads", REAL[cell["name"]])
        write(root, "workloads", cell["name"],
              dict(cell, limits=limits["limits"]))
    write(root, "configs", "tiny", PAIRS_CFG)
    write(root, "configs", "tinytrain", TRAIN_CFG)
    return harness.Files([str(root), harness.PKG],
                         bench={} if bench is None else bench)


def run_cell(f, cell, seed=7, trace=0, seconds=0.2, **kw):
    """(exit code, the result line as a dict or None)."""
    buf = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], files=f,
                  require_cuda=False, device="cpu", out=buf, **kw)
    text = buf.getvalue().strip()
    return rc, (json.loads(text.splitlines()[-1]) if text else None)
