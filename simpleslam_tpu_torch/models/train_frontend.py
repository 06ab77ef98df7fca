"""Train the learned front-end (ALIKED + LightGlue) and write its weights
for the pipeline: the counterpart of
``simpleslam_tpu/models/train_frontend.py``, with the same flags and
defaults plus ``--device``.

    python -m simpleslam_tpu_torch.models.train_frontend --steps 600 \\
        --render_hw 376 1232 --init_from checkpoints/learned_frontend

The default device is the GPU (without one the CLI raises; ``--device cpu``
runs on the CPU). ``--init_from`` warm-starts from the repository's orbax
tree or from a ``.npz`` this CLI wrote. The weights are written as one
``.npz`` of flax paths (``models/checkpoint.py::save_npz_tree``, no orbax),
``checkpoints/learned_frontend_torch.npz`` by default; point
``SLAM_FRONTEND_CKPT`` at it to serve it. ``--families`` alternates the
scene pool's blocks over ``corridor``, ``boxes`` and ``photo``;
``--real_frac`` trains that share of the steps on homography pairs over
the training photographs (``train.PhotoPairPool``). Each step draws its
pool as the reference does: with ``u`` uniform, the photographs where
``u < real_frac``, else the scene pool where ``u < real_frac + (1 -
real_frac) * scene_frac``, else the synthetic homography pairs.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

# pipeline-scale architecture (must match models/pipeline.py)
DESC_DIM = 128
DIM = 256           # 4 heads
N_LAYERS = 9
OUT_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "checkpoints", "learned_frontend_torch.npz")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("train_frontend")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=[144, 256])
    p.add_argument("--points", type=int, default=96)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--out", default=OUT_PATH,
                   help="the .npz the trained weights are written to")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene_views", type=int, default=160,
                   help="Pre-rendered 3-D views in the scene-pair pool")
    p.add_argument("--scene_frac", type=float, default=0.5,
                   help="Fraction of steps trained on scene pairs (real "
                        "viewpoint change + parallax) vs homography pairs")
    p.add_argument("--render_hw", type=int, nargs=2, default=None,
                   help="Render scene views at this resolution and train on "
                        "random --hw crops (e.g. 376 1232 for KITTI)")
    p.add_argument("--families", default="corridor",
                   help="comma-separated scene families for the pair pool "
                        "(corridor,boxes,photo), alternated across scene "
                        "blocks")
    p.add_argument("--scenes", type=int, default=4,
                   help="number of scene blocks in the pair pool")
    p.add_argument("--real_frac", type=float, default=0.0,
                   help="fraction of steps on homography pairs over real "
                        "photographs (train.PhotoPairPool over "
                        "train.train_photo_paths)")
    p.add_argument("--init_from", default=None,
                   help="warm-start from an orbax checkpoint directory or a "
                        ".npz written by this CLI (same pinned topology)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run "
                        "there)")
    return p.parse_args(argv)


def main(argv=None, history: Optional[List[dict]] = None) -> int:
    """Train and write the weights. With ``history``, one record per step
    is appended to it: ``source`` (the pool the step drew: ``photo``,
    ``scene`` or ``synthetic``), ``batch_s`` (host seconds building the
    batch), ``step_ms`` (CUDA events around the step on the GPU, else the host
    clock) and the step's loss terms."""
    a = parse_args(argv)
    from simpleslam_tpu_torch.models import checkpoint
    from simpleslam_tpu_torch.models import train as train_mod
    from simpleslam_tpu_torch.models.pipeline import (from_jax_params,
                                                      to_jax_params)
    from simpleslam_tpu_torch.utils.device import resolve_device
    from simpleslam_tpu_torch.utils.rng import TorchKey

    device = resolve_device(a.device)
    H, W = a.hw
    state_dicts = None
    if a.init_from:
        tree = checkpoint.load_frontend_tree(a.init_from, on_error="raise")
        state_dicts = from_jax_params(tree["aliked"], tree["lightglue"])
    tx, state = train_mod.make_train_state(
        torch.Generator().manual_seed(a.seed), lr=a.lr, desc_dim=DESC_DIM,
        dim=DIM, n_layers=N_LAYERS, total_steps=a.steps, device=device,
        state_dicts=state_dicts)
    if a.init_from:
        print(f"warm-started from {a.init_from}", flush=True)
    step_fn = train_mod.make_train_step(tx, (H, W))

    rhw = tuple(a.render_hw) if a.render_hw else (H, W)
    print(f"rendering scene-pair pool ({a.scene_views} views at {rhw}, "
          f"training on {H}x{W} crops)...", flush=True)
    pool = train_mod.ScenePairPool((H, W), n_views=a.scene_views, seed=a.seed,
                                   render_hw=rhw, n_scenes=a.scenes,
                                   families=tuple(a.families.split(",")),
                                   device=device)
    photo_pool = None
    if a.real_frac > 0:
        photo_pool = train_mod.PhotoPairPool(
            (H, W), train_mod.train_photo_paths(), seed=a.seed, device=device)
        print(f"real-photo pool: {len(photo_pool.imgs)} images/pre-scales "
              f"({a.real_frac:.0%} of steps)", flush=True)
    rng = np.random.default_rng(a.seed + 2)
    key = TorchKey(a.seed + 1)
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    for i in range(a.steps):
        tb = time.perf_counter()
        u = rng.random()
        if photo_pool is not None and u < a.real_frac:
            source = "photo"
            batch = photo_pool.batch(rng, a.batch, a.points)
        elif u < a.real_frac + (1.0 - a.real_frac) * a.scene_frac:
            source = "scene"
            batch = pool.batch(rng, a.batch, a.points)
        else:
            source = "synthetic"
            g = torch.Generator(device=device).manual_seed(
                key.fold_in(i).state & ((1 << 63) - 1))
            batch = train_mod.synthetic_pair_batch(g, a.batch, H, W, a.points)
            batch = {k: v.cpu().numpy() for k, v in batch.items()
                     if k != "Hmats"}
        batch = train_mod.batch_to_device(
            train_mod.photometric_augment(rng, batch), device)
        rec = {"batch_s": time.perf_counter() - tb, "source": source}
        if history is not None and cuda:
            rec["events"] = [torch.cuda.Event(enable_timing=True)
                             for _ in range(2)]
            rec["events"][0].record()
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        if history is not None:
            if cuda:
                rec["events"][1].record()
            else:
                rec["step_ms"] = 1e3 * (time.perf_counter() - ts)
            rec["metrics"] = metrics
            history.append(rec)
        if i % 100 == 0 or i == a.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i:5d}  total {m['total']:.4f}  desc {m['desc']:.4f}"
                  f"  match {m['match']:.4f}  rep {m['rep']:.4f}"
                  f"  peak {m['peak']:.4f}  sig {m['sig']:.4f}"
                  f"  ({time.perf_counter() - t0:.0f}s)", flush=True)
    if history is not None:
        if cuda:
            torch.cuda.synchronize(device)
        for rec in history:
            ev = rec.pop("events", None)
            if ev is not None:
                rec["step_ms"] = ev[0].elapsed_time(ev[1])
            rec["metrics"] = {k: float(v) for k, v in rec["metrics"].items()}

    a_tree, l_tree = to_jax_params(state.models["aliked"].state_dict(),
                                   state.models["lightglue"].state_dict())
    checkpoint.save_npz_tree(a.out, {"aliked": a_tree, "lightglue": l_tree})
    print(f"saved checkpoint to {a.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
