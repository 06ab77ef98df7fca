#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``simpleslam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (found on PATH or under /usr/local/cuda) and
the repository checkout; imports only the port, torch, numpy, scipy and the
standard library. Every phase prints one flushed JSON line with its seconds;
any failure raises and exits nonzero, and no result line is printed.

Phases:
  1. env      versions, the card's name and power limit;
  2. build    nvcc builds the port's CUDA source;
  3. kernel   the masked-attention kernel against its plain PyTorch version
              at (BH=4, N=256) with a fully masked head and at the main
              path's (BH=4, N=2048), float32 and bfloat16 inputs; times of
              the kernel, the plain version and SDPA (a yardstick only);
  4. frontend ALIKED (2048 keypoints) + LightGlue (9 layers) at full width
              with seeded weights on two 376x1232 frames, once through the
              kernel (each call also held to the plain version on its own
              inputs), once through the plain attention and once through a
              deliberately wrong attention (one tile of live keys masked
              out, a reading only), compared on the final descriptors;
  5. slam     the main path: ``SLAMSystem.process_frame`` with the learned
              front-end over 10 frames; the kernel's launch count is read
              around this phase only;
  6. oracle   the geometric back half over 40 frames, with the front-end
              replaced (here only) by an oracle that projects a seeded
              point cloud: bootstrap, PnP tracking, keyframes,
              triangulation and local BA on the card, scored by ATE;
  7. kernels  one JSON line, one entry per kernel.
The line before the last is ``nvidia-smi``'s name and power limit; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

KITTI_K = np.array([[707.0912, 0.0, 601.8873], [0.0, 707.0912, 183.1104],
                    [0.0, 0.0, 1.0]])
HW = (376, 1232)
N_KP = 2048
ATTN_TOL = 2e-5        # float32 kernel vs float32 plain: summation order only
# Phase 4 holds the kernel to the plain version twice. First on the inputs
# of each of the 36 attention calls of a full-width LightGlue forward, to
# ATTN_TOL scaled by the call's largest |v| where that exceeds 1: the output
# is a softmax-weighted average of v and carries its scale (|v| reaches 10
# there; the kernel's error read 3.0e-6 to 6.6e-6 of max|v| on an H100).
# Then on the forward's final descriptors (final_proj outputs), whose
# largest relative error over valid keypoints must stay within DESC_TOL: the
# bf16 projections between attention calls turn float32 rounding into
# bf16-level steps, and the kernel read 0.0063 there. Gross faults read
# 0.24-1.09 (CPU, N = 256,
# tests/test_torch_models.py::test_descriptor_check_separates_wrong_attention);
# a fault confined to one key tile of 32 is diluted at this level (its
# control, keys 128-191 masked out, read 0.014), which is why the per-call
# check comes first.
DESC_TOL = 5e-2
# ATE bound of phase 6 (metres, Sim(3)-aligned, 39 m of trajectory). Sound
# runs read 0.0346 m on an H100 on every run, 0.022-0.059 m while BA's sums
# still used atomic adds, and 0.026-0.039 m on the CPU (rounding differs
# across devices and thread counts, and the run amplifies it). Faults,
# over 20 frames on the CPU
# (tests/test_torch_slam.py::test_oracle_check_catches_broken_back_half):
# a local BA that writes keyframe poses to the wrong frames tracks every
# frame and reads 2.4 m, caught by this bound alone; no local BA (0.017 m)
# and no triangulation (0.10 m) are caught by the count of local BA solves.
ORACLE_ATE_MAX = 0.1


def log(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                      **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# synthetic inputs (numpy/scipy, seeded)
# --------------------------------------------------------------------------- #

def texture(seed: int, hw, pad: int = 64) -> np.ndarray:
    """Smooth random texture, (H + 2 pad, W + 2 pad) uint8."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    H, W = hw[0] + 2 * pad, hw[1] + 2 * pad
    img = sum(gaussian_filter(rng.uniform(0, 1, (H, W)), s) * w
              for s, w in ((1.5, 1.0), (4.0, 2.0), (12.0, 4.0)))
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def shifted_frame(tex: np.ndarray, hw, dx: int, dy: int, pad: int = 64):
    """The window of ``tex`` moved by (dx, dy) pixels."""
    return np.ascontiguousarray(tex[pad + dy: pad + dy + hw[0],
                                    pad + dx: pad + dx + hw[1]])


def umeyama_ate(est_cw: np.ndarray, gt_wc: np.ndarray) -> float:
    """ATE-RMSE of camera centres after a Sim(3) (Umeyama) alignment."""
    est = -np.einsum("nji,nj->ni", est_cw[:, :3, :3], est_cw[:, :3, 3])
    gt = gt_wc[:, :3, 3]
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max((e ** 2).sum() / len(est), 1e-12)
    aligned = s * est @ R.T + (mu_g - s * R @ mu_e)
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))


# --------------------------------------------------------------------------- #
# the oracle front-end of phase 6 (test scaffolding, not part of the port)
# --------------------------------------------------------------------------- #

class OracleFrontEnd:
    """Detector + matcher stand-in: projects a seeded 3-D point cloud along
    a known forward trajectory. Each frame keeps the ``n_kp`` visible
    landmarks of lowest id (so tracks persist), with 0.5 px pixel noise and
    a fixed random unit descriptor per landmark plus small noise. Matching
    is by landmark id; the id rides in ``Features.scores``."""

    def __init__(self, device, n_frames: int, n_kp: int = N_KP, hw=HW,
                 seed: int = 0, speed: float = 1.0,
                 yaw_deg_per_frame: float = 0.25):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.learned = True
        self.n_kp, self.hw = n_kp, hw
        rng = np.random.default_rng(seed)
        n_pts = 30000
        self.points = np.column_stack([rng.uniform(-15, 15, n_pts),
                                       rng.uniform(-5, 1.6, n_pts),
                                       rng.uniform(3, 70, n_pts)])
        desc = rng.normal(size=(n_pts, 128))
        self.desc = desc / np.linalg.norm(desc, axis=1, keepdims=True)
        T_wc, yaw, pos = [], 0.0, np.zeros(3)
        for _ in range(n_frames):
            T = np.eye(4)
            c, s = math.cos(yaw), math.sin(yaw)
            T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            T[:3, 3] = pos
            T_wc.append(T)
            yaw += math.radians(yaw_deg_per_frame)
            pos = pos + T[:3, :3] @ np.array([0.0, 0.0, speed])
        self.T_wc = np.stack(T_wc)
        self.rng = rng
        self.frame = 0

    def fn(self, gray):
        """Features of frame ``self.frame`` (the image itself is unused)."""
        from simpleslam_tpu_torch.core.types import Features
        T_cw = np.linalg.inv(self.T_wc[self.frame])
        Xc = self.points @ T_cw[:3, :3].T + T_cw[:3, 3]
        z = Xc[:, 2]
        uv = Xc[:, :2] / np.maximum(z, 1e-9)[:, None] * \
            [KITTI_K[0, 0], KITTI_K[1, 1]] + KITTI_K[:2, 2]
        H, W = self.hw
        vis = (z > 1.0) & (uv[:, 0] >= 8) & (uv[:, 0] < W - 8) \
            & (uv[:, 1] >= 8) & (uv[:, 1] < H - 8)
        ids = np.flatnonzero(vis)[: self.n_kp]
        kp = uv[ids] + self.rng.normal(scale=0.5, size=(len(ids), 2))
        d = self.desc[ids] + 0.05 * self.rng.normal(size=(len(ids), 128))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return Features.from_arrays(kp, d, scores=ids.astype(np.float32),
                                    n_pad=self.n_kp, device=self.device)

    def match(self, f0, f1):
        from simpleslam_tpu_torch.core.types import Matches
        id0 = f0.scores.cpu().numpy().astype(np.int64)
        id1 = f1.scores.cpu().numpy().astype(np.int64)
        v0, v1 = f0.valid.cpu().numpy(), f1.valid.cpu().numpy()
        pos1 = {int(i): j for j, i in enumerate(id1) if v1[j]}
        pairs = [(i, pos1[int(a)]) for i, a in enumerate(id0)
                 if v0[i] and int(a) in pos1]
        i0 = np.array([p[0] for p in pairs], np.int64)
        i1 = np.array([p[1] for p in pairs], np.int64)
        return Matches.from_arrays(i0, i1, np.ones(len(pairs), np.float32),
                                   m_pad=self.n_kp, device=self.device)


def run_oracle_phase(device, n_frames: int = 40, n_kp: int = N_KP,
                     seed: int = 0) -> dict:
    """Phase 6: SLAMSystem.process_frame over the oracle's frames."""
    from simpleslam_tpu_torch.config import SLAMConfig
    from simpleslam_tpu_torch.run_slam import SLAMSystem

    oracle = OracleFrontEnd(device, n_frames, n_kp=n_kp, seed=seed)
    cfg = SLAMConfig(use_lightglue=True, max_features=n_kp, seed=seed)
    system = SLAMSystem(cfg, KITTI_K, None, img_hw=HW, device=device,
                        weights=None)
    system.detector = oracle
    system.matcher = type("OracleMatcher", (), {"fn": staticmethod(
        oracle.match)})()
    img = np.zeros(HW, np.uint8)
    prev = None
    for i in range(n_frames):
        oracle.frame = i
        prev = system.process_frame(i, img, prev)
    poses = np.stack(system.world_map.poses) if system.world_map.poses \
        else np.zeros((0, 4, 4))
    ids = system.frame_ids
    return {
        "bootstrap_frame": ids[1] if len(ids) > 1 else None,
        "frames_tracked": len(ids),
        "keyframes": len(system.kfs),
        "map_points": len(system.world_map),
        "lost": system.tracking_lost_count,
        "local_ba_solves": system.local_ba_solves,
        "ate_m": umeyama_ate(poses, oracle.T_wc[ids]) if len(ids) > 2
        else float("nan"),
        "finite": bool(np.isfinite(poses).all()),
        "consistent": len(poses) == len(ids) and ids == sorted(set(ids)),
    }


def oracle_ok(res: dict) -> bool:
    """Phase 6's verdict on :func:`run_oracle_phase`'s result."""
    return bool(res["finite"] and res["consistent"] and res["lost"] == 0
                and res["keyframes"] >= 3 and res["local_ba_solves"] >= 1
                and res["ate_m"] <= ORACLE_ATE_MAX)


def desc_rel_err(a, b, valid) -> float:
    """Largest relative L2 error of descriptor rows ``a`` against ``b``
    over the rows where ``valid``."""
    rel = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-12)
    return rel[valid].max().item()


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #

def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def attention_inputs(seed, BH, N, device, dtype, dead_head=None):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(BH, N, 64, generator=g) for _ in range(3))
    mask = torch.rand(BH, N, generator=g) > 0.3
    if dead_head is not None:
        mask[dead_head] = False
    return [t.to(device, dtype) for t in (q, k, v)] + [mask.to(device)]


# --------------------------------------------------------------------------- #
# main
# --------------------------------------------------------------------------- #

def main() -> None:
    t_all = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    from simpleslam_tpu_torch.models import lightglue as lg_mod
    from simpleslam_tpu_torch.models.pipeline import (LearnedExtractor,
                                                      LearnedMatcher)
    from simpleslam_tpu_torch.ops import attention
    from simpleslam_tpu_torch.utils import cuda_build
    dev = torch.device("cuda")

    # 1. env -----------------------------------------------------------------
    t0 = time.time()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi)

    # 2. build ---------------------------------------------------------------
    t0 = time.time()
    out = cuda_build.build(attention.SOURCE)
    ptxas = [ln.strip() for ln in out.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", t0, source=attention.SOURCE, ptxas=ptxas)

    # 3. kernel vs plain -------------------------------------------------------
    t0 = time.time()
    checks = {}
    for name, N, dtype, dead in (("n256_f32_dead_head", 256, torch.float32, 1),
                                 ("n2048_f32", 2048, torch.float32, None),
                                 ("n2048_bf16", 2048, torch.bfloat16, None)):
        q, k, v, m = attention_inputs(7, 4, N, dev, dtype, dead)
        got = attention.cuda_masked_attention(q, k, v, m)
        torch.cuda.synchronize()
        want = attention.plain_masked_attention(q, k, v, m)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name}: kernel output not finite")
        live = m.any(1)
        err = (got - want).abs()[live].max().item()
        if err > ATTN_TOL:
            raise RuntimeError(f"{name}: max abs error {err} > {ATTN_TOL}")
        checks[name] = err
    q, k, v, m = attention_inputs(8, 4, 2048, dev, torch.float32)
    ms = time_ms(lambda: attention.cuda_masked_attention(q, k, v, m))
    plain_ms = time_ms(lambda: attention.plain_masked_attention(q, k, v, m))
    sdpa_mask = m[:, None, None, :]
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(q[:, None], k[:, None],
                                                      v[:, None],
                                                      attn_mask=sdpa_mask))
    BH, N, d = 4, 2048, 64
    flops = 4.0 * N * N * d * BH
    nbytes = 4 * BH * N * d * 4 + BH * N
    bound_ops_ms = flops / 67e12 * 1e3       # float32 CUDA-core peak
    bound_bytes_ms = nbytes / 3.35e12 * 1e3
    log("kernel", t0, max_abs_err=checks, ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=max(bound_ops_ms, bound_bytes_ms),
        bound_bf16_tensor_core_ms=flops / 989e12 * 1e3)

    # 4. front-end at full width ------------------------------------------------
    t0 = time.time()
    tex = texture(1, HW)
    f0_img = shifted_frame(tex, HW, 0, 0)
    f1_img = shifted_frame(tex, HW, 6, 2)
    ext = LearnedExtractor(N_KP, seed=0, device=dev)
    mat = LearnedMatcher(ext, seed=1, n_layers=9)
    feats = [ext.fn(torch.as_tensor(im, device=dev).float())
             for im in (f0_img, f1_img)]
    for f in feats:
        if f.kpts.shape != (N_KP, 2) or not torch.isfinite(f.kpts).all():
            raise RuntimeError("ALIKED output malformed")
    args = (feats[0].kpts[None], feats[0].desc[None], feats[0].valid[None],
            feats[1].kpts[None], feats[1].desc[None], feats[1].valid[None],
            HW)
    call_errs = []

    def checked_attention(q, k, v, m):
        """The kernel, held to the plain version on each call's inputs."""
        out = attention.masked_attention(q, k, v, m)
        want = attention.plain_masked_attention(q, k, v, m)
        err = (out - want).abs()[m.any(1)].max().item()
        v_max = v.float().abs().max().item()
        call_errs.append((err / max(1.0, v_max), err, v_max, str(q.dtype)))
        return out

    def wrong_attention(q, k, v, m):
        m = m.clone()
        m[:, 128:192] = False
        return attention.plain_masked_attention(q, k, v, m)

    def forward(attn):
        """P and the final descriptors of both images."""
        outs = []
        hook = mat.model.final_proj.register_forward_hook(
            lambda _m, _i, o: outs.append(o[0].float()))
        lg_mod.masked_attention = attn
        try:
            with torch.no_grad():
                P = mat.model(*args)[0][0]
        finally:
            lg_mod.masked_attention = attention.masked_attention
            hook.remove()
        return P, torch.cat(outs)

    n_before = attention.cuda_masked_attention.launches
    P_kernel, D_kernel = forward(attention.masked_attention)
    n_fwd = attention.cuda_masked_attention.launches - n_before
    P_plain, D_plain = forward(attention.plain_masked_attention)
    forward(checked_attention)
    _, D_wrong = forward(wrong_attention)
    valid = torch.cat([feats[0].valid, feats[1].valid])
    worst = max(call_errs)
    d_err = desc_rel_err(D_kernel, D_plain, valid)
    d_control = desc_rel_err(D_wrong, D_plain, valid)
    p_err = (P_kernel - P_plain).abs().max().item()
    if not (torch.isfinite(P_kernel).all() and n_fwd == 36
            and len(call_errs) == 36 and worst[0] <= ATTN_TOL
            and d_err <= DESC_TOL):
        raise RuntimeError(f"LightGlue kernel vs plain: worst call (error "
                           f"/ max(1, max|v|), error, max|v|, q dtype) "
                           f"{worst} (tolerance {ATTN_TOL}), descriptor "
                           f"error {d_err} "
                           f"(tolerance {DESC_TOL}), launches per forward "
                           f"{n_fwd}")
    lg_ms = time_ms(lambda: mat.model(*args), iters=5, warmup=1)
    log("frontend", t0, keypoints=[int(f.valid.sum()) for f in feats],
        attn_call_worst=worst, desc_rel_err=d_err,
        desc_rel_err_key_tile_dropped=d_control, P_max_abs_err=p_err,
        P_max=P_plain.max().item(), launches_per_forward=n_fwd,
        lightglue_forward_ms=lg_ms)

    # 5. slam, learned (the main path) -------------------------------------------
    t0 = time.time()
    from simpleslam_tpu_torch.config import SLAMConfig
    from simpleslam_tpu_torch.run_slam import SLAMSystem
    cfg = SLAMConfig(use_lightglue=True, max_features=N_KP)
    system = SLAMSystem(cfg, KITTI_K, None, img_hw=HW)
    attention.cuda_masked_attention.launches = 0
    prev = None
    frame_s = []
    for i in range(10):
        tf = time.time()
        prev = system.process_frame(i, shifted_frame(tex, HW, 3 * i, i), prev)
        torch.cuda.synchronize()
        frame_s.append(time.time() - tf)
    launches = attention.cuda_masked_attention.launches
    poses = np.stack(system.world_map.poses) if system.world_map.poses \
        else np.zeros((0, 4, 4))
    calls = system.matcher.calls
    ok = (np.isfinite(poses).all()
          and len(system.world_map.poses) == len(system.frame_ids)
          and system.frame_ids == sorted(set(system.frame_ids))
          and torch.isfinite(prev.kpts).all().item()
          and calls > 0 and launches >= 36 * calls)
    log("slam", t0, frames=10, match_calls=calls, kernel_launches=launches,
        initialised=system.initialised, frames_posed=len(system.frame_ids),
        frame_ms=[round(1e3 * s, 1) for s in frame_s],
        stages={k: round(v, 3) for k, v in system.timer.totals.items()})
    if not ok:
        raise RuntimeError("learned SLAM phase produced inconsistent output")

    # 6. slam, geometric back half (oracle front-end) -----------------------------
    t0 = time.time()
    res = run_oracle_phase(dev, n_frames=40)
    log("oracle", t0, **res)
    if not oracle_ok(res):
        raise RuntimeError(f"oracle phase failed: {res}")

    # 7. kernels -------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "masked_attention",
        "route": "cuda",
        "source": "simpleslam_tpu_torch/csrc/masked_attention.cu",
        "replaces": "simpleslam_tpu/ops/pallas/attention.py:32",
        "launches": launches,
        "max_abs_err": max(checks.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bound_ops_ms, bound_bytes_ms),
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms
        else "bytes",
        "library_ms": library_ms,
    }]}), flush=True)
    log("total", t_all)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
