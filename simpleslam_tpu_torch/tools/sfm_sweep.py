"""Where the ORB structure-from-motion's ATE on the card comes from.

    python -m simpleslam_tpu_torch.tools.sfm_sweep [--seeds 0 1 2 3]
        [--modes gpu cpu gpu+cpu_draws gpu+cpu_feats+cpu_draws
         cpu+gpu_feats] [--frames 40]

The port's ``StructureFromMotion`` with ORB at the CLI's defaults over
``chip_smoke.py`` phase 12's sequence (phase 7's corridor: 370x1226,
``tools.synth``'s defaults), one run per (mode, RANSAC seed). The frames
are rendered once, on the GPU when a mode needs it, and every mode is fed
the same frames. The features are extracted once on each device. Modes:

* ``gpu``: every stage on the GPU (phase 12's run);
* ``cpu``: every stage on the CPU;
* ``gpu+cpu_draws``: the GPU, its RANSAC drawing the CPU's minimal sets
  (one seed gives ``torch.Generator`` other numbers on CUDA than on the
  CPU);
* ``gpu+cpu_feats+cpu_draws``: as above, fed the CPU's features, so that
  only the back half's arithmetic runs on the GPU;
* ``cpu+gpu_feats``: the CPU fed the GPU's features.

One JSON line per run: keyframes, landmarks, ATE, RTE rotation, seconds.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from simpleslam_tpu_torch.config import parse_config
from simpleslam_tpu_torch.tools import synth
from simpleslam_tpu_torch.tools.sfm import StructureFromMotion
from simpleslam_tpu_torch.utils.rng import TorchKey

MODES = ("gpu", "cpu", "gpu+cpu_draws", "gpu+cpu_feats+cpu_draws",
         "cpu+gpu_feats")


class CpuDrawKey:
    """A :class:`TorchKey` whose draws are made on the CPU and moved to the
    device that asks for them."""

    def __init__(self, key: TorchKey):
        self.key = key

    def fold_in(self, data):
        return CpuDrawKey(self.key.fold_in(data))

    def split(self, num=2):
        return tuple(CpuDrawKey(k) for k in self.key.split(num))

    def randint(self, shape, high, device):
        if isinstance(high, torch.Tensor):
            high = high.cpu()
        return self.key.randint(shape, high, "cpu").to(device)


def _feature_source(mode: str) -> str:
    """The device whose features a mode is fed."""
    run_dev, *feed = mode.split("+")
    for f in feed:
        if f.endswith("_feats"):
            return f[:-len("_feats")]
    return run_dev


def main(argv=None) -> int:
    p = argparse.ArgumentParser("sfm_sweep")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    p.add_argument("--frames", type=int, default=40)
    a = p.parse_args(argv)
    on_gpu = any("gpu" in m for m in a.modes)
    srcs = {m: _feature_source(m) for m in a.modes}
    T_wc = synth.make_trajectory(a.frames, speed=0.5, yaw_rate_deg=0.25)
    scene = synth.CorridorScene(seed=0, device=None if on_gpu else "cpu")
    frames = [scene.render(T) for T in T_wc]

    def sfm_on(device, seed, key=None):
        cfg = parse_config(["--dataset", "kitti", "--headless",
                            "--seed", str(seed)])
        return StructureFromMotion(cfg, synth.DEFAULT_K, device=device,
                                   key=key)

    feats = {}
    for name, dev in (("gpu", None), ("cpu", "cpu")):
        if name in srcs.values():
            sfm = sfm_on(dev, 0)
            sfm.add_frames([f.to(sfm.device) for f in frames])
            feats[name] = sfm._extract_all()
    for seed in a.seeds:
        for mode in a.modes:
            key = CpuDrawKey(TorchKey(seed)) if "cpu_draws" in mode else None
            t0 = time.time()
            sfm = sfm_on("cpu" if mode.startswith("cpu") else None, seed,
                         key)
            given = [f.map(lambda t: t.to(sfm.device))
                     for f in feats[srcs[mode]]]
            sfm._extract_all = lambda: given
            r = sfm.run(gt_T=T_wc[:, :3, :4])
            print(json.dumps({"mode": mode, "seed": seed,
                              "kf_frames": r.kf_frames,
                              "landmarks": r.n_landmarks, "ate_m": r.ate,
                              "rte_rot_deg": r.rte_rot_deg,
                              "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
