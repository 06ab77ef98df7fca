"""Per-branch FLOP accounting for the fused step (the counterpart of
``simpleslam_tpu/tools/fused_cost.py``).

Prints ONE JSON line with the FLOPs of one fused step per frame class:

  {"static": F, "skip": F_skip, "eval": F_eval, "kf": F_kf}

  skip   -- a tracked frame that is not a keyframe candidate (no keyframe
            match, no burst);
  eval   -- a tracked candidate evaluated (the keyframe match) but not
            promoted;
  kf     -- a tracked keyframe burst (insert, triangulate, local BA);
  static -- every arm in one step: PnP and its wide retry, keyframe and
            global relocalisation, the essential-matrix fallback, then the
            burst with map compaction (``force_branch="static"``). No
            frame costs more; it is the port's counterpart of the
            reference's XLA count of the unforced program, which counts
            both sides of every ``lax.cond``.

A benchmark weights the classes by the frame counts of a timed run (log
columns 1 'kf' and 6 'considered') to get the executed FLOPs per frame.
The port's 'skip', 'eval' and 'kf' count no recovery arm (the reference's
forced programs keep both sides of the tracking conds): a frame that
needed the wide retry or a relocalisation did more than its class.

How the port counts, and why it differs from the reference:

* The reference lowers each forced program on an abstract state and reads
  XLA's cost analysis. PyTorch has no such analysis, so the tool runs one
  forced step (``build_fused_step(force_branch=...)``) per class under
  ``torch.utils.flop_counter.FlopCounterMode``.
* A state of zeros would send SVD and ``eigh`` into degenerate inputs whose
  host status checks can raise, so the tool renders the spec's corridor
  (``tools/synth.py``, seed 0, the bench trajectory), bootstraps a host
  ``SLAMSystem`` on it, builds the state with ``state_from_host`` and
  counts each forced step on the next frame, each on a clone of that
  state.
* The counter cannot see a launch of the CUDA attention kernel (a ctypes
  call), so LightGlue's attention is counted by its formula,
  ``4 BH Nq Nk d`` per call (the two products), in place of whatever the
  counter saw inside the call (the plain twin's same two products on the
  CPU, nothing on the GPU). The count is therefore the same on both
  devices.
* FlopCounterMode counts matrix products, convolutions and the SDPA
  family, not elementwise work, SVD, ``eigh`` or sorting. The port's
  numbers are therefore lower than XLA's for the same step and are not
  comparable with them; compare them only with each other.

Runs on the GPU unless ``--device cpu`` asks for the CPU.

Usage: python -m simpleslam_tpu_torch.tools.fused_cost '<json spec>'
       [--device cpu]
  spec = {"argv": [...config argv...], "hw": [H, W], "n_kp": N,
          "desc_dim": D, "desc_dtype": "float32", "K": [[...]] (optional),
          "log_capacity": 1024 (optional)}
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

CLASSES = ("static", "skip", "eval", "kf")      # FusedStep.FORCED's keys
MAX_BOOT_FRAMES = 12        # rendered frames the bootstrap may take


def spec_K(spec: dict) -> np.ndarray:
    """The spec's intrinsics, or the reference tool's default camera."""
    H, W = int(spec["hw"][0]), int(spec["hw"][1])
    return np.asarray(spec.get("K") or [[707.0, 0, W / 2.0],
                                        [0, 707.0, H / 2.0], [0, 0, 1.0]],
                      np.float64)


def bootstrap(spec: dict, device):
    """(cfg, system, prev_feats, next frame): a host ``SLAMSystem`` on
    ``device`` bootstrapped on the spec's rendered corridor, and the frame
    after the bootstrap. Raises if it does not bootstrap within
    MAX_BOOT_FRAMES."""
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.run_slam import SLAMSystem
    from simpleslam_tpu_torch.tools.synth import (SCENE_FAMILIES,
                                                  make_trajectory)

    cfg = parse_config(list(spec["argv"]))
    hw = (int(spec["hw"][0]), int(spec["hw"][1]))
    K = spec_K(spec)
    T = make_trajectory(MAX_BOOT_FRAMES + 1, speed=0.5, yaw_rate_deg=0.3)
    scene = SCENE_FAMILIES["corridor"](seed=0, hw=hw, K=K, device=device)
    system = SLAMSystem(cfg, K, None, img_hw=hw, device=device)
    prev = system.process_frame(0, scene.render(T[0]).cpu().numpy(), None)
    i = 1
    while i < MAX_BOOT_FRAMES and not system.initialised:
        prev = system.process_frame(i, scene.render(T[i]).cpu().numpy(),
                                    prev)
        i += 1
    if not system.initialised:
        raise RuntimeError(f"no bootstrap within {MAX_BOOT_FRAMES} frames "
                           f"at {hw}")
    return cfg, system, prev, scene.render(T[i])


def count_classes(fc, system, state, img, detail: Optional[dict] = None
                  ) -> dict:
    """The FLOPs of one forced step per class on ``img`` after ``state``
    (each step on a clone: ``state`` is left as it was), on the system's
    device. ``detail``: see :func:`branch_flops`."""
    from torch.utils.flop_counter import FlopCounterMode

    from simpleslam_tpu_torch.core.fused import build_fused_step
    from simpleslam_tpu_torch.models import lightglue

    match_fn = getattr(system.matcher, "fn_fast", None) or system.matcher.fn
    attention = lightglue.masked_attention
    out = {}
    for name in CLASSES:
        step = build_fused_step(fc, system.K, system.detector.fn, match_fn,
                                system.device, force_branch=name)
        calls, seen = [], []

        def counted_attention(q, k, v, mask_k):
            calls.append((int(q.shape[0]), int(q.shape[1]),
                          int(k.shape[1]), int(q.shape[2])))
            with FlopCounterMode(display=False) as inner:
                o = attention(q, k, v, mask_k)
            seen.append(inner.get_total_flops())
            return o

        lightglue.masked_attention = counted_attention
        try:
            with FlopCounterMode(display=False) as counter:
                step(state.clone(), img)
        finally:
            lightglue.masked_attention = attention
        attn = sum(4 * bh * nq * nk * d for bh, nq, nk, d in calls)
        out[name] = float(counter.get_total_flops() - sum(seen) + attn)
        if detail is not None:
            ops = counter.get_flop_counts().get("Global", {})
            detail[name] = {"ops": {str(k): int(v) for k, v in ops.items()},
                            "attention": int(attn),
                            "attention_seen": int(sum(seen)),
                            "attention_calls": calls}
    return out


def branch_flops(spec: dict, device=None,
                 detail: Optional[dict] = None) -> dict:
    """{"static", "skip", "eval", "kf"} -> FLOPs of one forced step, with
    the trained tree, on ``device`` (None: the GPU, raises without one).
    ``detail``: a dict that receives, per class, the counter's FLOPs by
    op (``ops``), LightGlue's attention by formula (``attention``), what
    the counter saw inside the attention calls (``attention_seen``) and
    each call's (BH, Nq, Nk, d) (``attention_calls``)."""
    from simpleslam_tpu_torch.core.fused import (make_fused_config,
                                                 state_from_host)
    from simpleslam_tpu_torch.utils.device import resolve_device

    cfg, system, prev, img = bootstrap(spec, resolve_device(device))
    n_kp, desc_dim = (int(s) for s in prev.desc.shape)
    want = (int(spec.get("n_kp", n_kp)), int(spec.get("desc_dim", desc_dim)),
            str(spec.get("desc_dtype", "float32")))
    got = (n_kp, desc_dim, str(prev.desc.dtype).replace("torch.", ""))
    if want != got:
        raise ValueError(f"spec (n_kp, desc_dim, desc_dtype) {want} but the "
                         f"front-end gives {got}")
    fc = make_fused_config(cfg, system.img_hw, n_kp=n_kp, desc_dim=desc_dim,
                           log_capacity=int(spec.get("log_capacity", 1024)))
    return count_classes(fc, system, state_from_host(system, fc, prev), img,
                         detail)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("fused_cost")
    p.add_argument("spec", help="the JSON spec (see the module docstring)")
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' for the CPU")
    a = p.parse_args(argv)
    print(json.dumps(branch_flops(json.loads(a.spec), a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
