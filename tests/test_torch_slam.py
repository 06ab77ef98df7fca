"""The slice as a whole: ``SLAMSystem.process_frame`` of the port against the
JAX package's, with the learned front-end and the trained weights
(``checkpoints/learned_frontend``, converted in memory by
``from_jax_params``), plus the import, device and oracle-phase checks.

Fixture: the reference's ``tools/synth`` corridor, rendered in memory at
160x512 (FOV-preserving intrinsics), 10 frames at 1 m/frame, scene seed 0,
``max_features=384``, RANSAC seed 0 -- chosen by running the reference
first: it bootstraps at frame 1, keyframes at frame 7 (triangulation +
local BA) and tracks every frame.

RANSAC draws are injected: the port draws through a key backed by
``jax.random``, so both systems sample the same minimal sets. Three runs go
over the frames in lockstep:

* ``ref``: the JAX package;
* ``port``: the port, with its own networks;
* ``follow``: the port's geometry fed the reference's features, matches and
  F-RANSAC match filter (``filter_matches_ransac``). Everything else --
  bootstrap, PnP tracking, keyframes, triangulation, local BA -- is the
  port's, and its poses and map size must follow the reference's over
  every frame.

Why the F-RANSAC filter is shared in ``follow``: its weighted 8-point refit
(the smallest eigenvector of a float32 Gram matrix) is ill-conditioned in
forward motion, so float rounding alone moves inliers that sit near the
threshold -- in the reference itself as much as between the packages
(``test_f_filter_differs_within_reference_float_sensitivity``). At the
first keyframe those inliers decide which landmarks are triangulated, and
local BA (only keyframe 0 fixed, so the scale gauge is free) carries the
difference into every later pose. So ``port``, which runs its own filter,
is held to the reference's decisions and to the reference's accuracy, and
``follow`` to the reference's numbers.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.config import SLAMConfig as JConfig
from simpleslam_tpu.core.frontend import filter_matches_ransac as j_filter
from simpleslam_tpu.core.types import Features as JFeatures
from simpleslam_tpu.core.types import Matches as JMatches
from simpleslam_tpu.models.pipeline import _load_repo_checkpoint
from simpleslam_tpu.ops.epipolar import find_fundamental as j_find_fundamental
from simpleslam_tpu.run_slam import SLAMSystem as JSystem
from simpleslam_tpu.tools.synth import (DEFAULT_HW, DEFAULT_K, CorridorScene,
                                        make_trajectory)
from simpleslam_tpu.tools.trajectory_eval import ate_rmse
from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.models.pipeline import from_jax_params
from simpleslam_tpu_torch.ops.epipolar import find_fundamental
from simpleslam_tpu_torch import run_slam
from simpleslam_tpu_torch.core.ba import local_bundle_adjustment
from simpleslam_tpu_torch.run_slam import SLAMSystem

HW = (160, 512)
N_FRAMES = 10
MAX_FEATURES = 384
SEED = 0
FOLLOW_POSE_TOL = 2e-3   # max |T_cw| entry gap, float32 rounding
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class JaxKey:
    """The port's key interface backed by ``jax.random``."""

    def __init__(self, key):
        self.key = key

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, int(data)))

    def split(self, num=2):
        return tuple(JaxKey(k) for k in jax.random.split(self.key, num))

    def randint(self, shape, high, device):
        r = jax.random.randint(self.key, tuple(shape), 0,
                               jnp.maximum(jnp.int32(int(high)), 1))
        return torch.as_tensor(np.array(r), dtype=torch.int64,
                               device=device)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor():
    K = DEFAULT_K.copy()
    K[0] *= HW[1] / DEFAULT_HW[1]
    K[1] *= HW[0] / DEFAULT_HW[0]
    scene = CorridorScene(seed=0, hw=HW, K=K)
    T_wc = make_trajectory(N_FRAMES, speed=1.0)
    return K, T_wc, [scene.render(T) for T in T_wc]


@pytest.fixture(scope="module")
def weights():
    ck = _load_repo_checkpoint(on_error="raise")
    return from_jax_params(jax.tree.map(np.asarray, ck["aliked"]),
                           jax.tree.map(np.asarray, ck["lightglue"]))


def _summary(system, T_wc):
    ids = list(system.frame_ids)
    ate = ate_rmse(np.stack(system.world_map.poses), T_wc[ids])[0] \
        if len(ids) > 2 else float("nan")
    return dict(boot=ids[1] if len(ids) > 1 else None,
                kfs=[kf.frame_idx for kf in system.kfs],
                lost=system.tracking_lost_count, ate=ate, ids=ids,
                poses=np.stack(system.world_map.poses) if ids
                else np.zeros((0, 4, 4)))


def _to_torch(f):
    return Features(*(torch.as_tensor(np.array(getattr(f, k)))
                      for k in ("kpts", "desc", "scores", "valid")))


def _to_jax(f):
    return JFeatures(*(jnp.asarray(getattr(f, k).numpy())
                       for k in ("kpts", "desc", "scores", "valid")))


def _matches_to_torch(m):
    return Matches(*(torch.as_tensor(np.array(getattr(m, k)))
                     .to(torch.int64 if k.startswith("idx") else None)
                     for k in ("idx0", "idx1", "score", "valid")))


class _ReferenceFrontEnd:
    """Hands the reference system's detector and matcher to the port."""
    learned = True
    device = torch.device("cpu")

    def __init__(self, ref):
        self.ref = ref

    def fn(self, gray):
        return _to_torch(self.ref.detector.fn(jnp.asarray(gray.numpy())))


class _ReferenceMatcher:
    def __init__(self, ref):
        self.ref = ref

    def fn(self, f0, f1):
        return _matches_to_torch(self.ref.matcher.fn(_to_jax(f0),
                                                     _to_jax(f1)))


class _ReferenceFilter:
    """The reference's ``filter_matches_ransac`` in the port's signature;
    records each call's correspondences for the float-sensitivity test."""

    def __init__(self):
        self.cases = []

    def __call__(self, f0, f1, m, thresh, key=None, n_hyp=256):
        p0, p1 = f0.kpts[m.idx0], f1.kpts[m.idx1]
        self.cases.append((p0.numpy(), p1.numpy(), m.valid.numpy(),
                           float(thresh), key.key))
        jm = JMatches(*(jnp.asarray(getattr(m, k).numpy())
                        for k in ("idx0", "idx1", "score", "valid")))
        return _matches_to_torch(j_filter(_to_jax(f0), _to_jax(f1), jm,
                                          thresh, key=key.key, n_hyp=n_hyp))


@pytest.fixture(scope="module")
def runs(corridor, weights):
    """The three lockstep runs of the module docstring."""
    K, T_wc, frames = corridor
    ref = JSystem(JConfig(use_lightglue=True, max_features=MAX_FEATURES,
                          seed=SEED), K, None, img_hw=HW)
    cfg = SLAMConfig(use_lightglue=True, max_features=MAX_FEATURES, seed=SEED)
    port, follow = (SLAMSystem(cfg, K, None, img_hw=HW, device="cpu",
                               key=JaxKey(jax.random.PRNGKey(SEED)),
                               weights=weights) for _ in range(2))
    follow.detector = _ReferenceFrontEnd(ref)
    follow.matcher = _ReferenceMatcher(ref)
    ref_filter = _ReferenceFilter()
    prev_ref = prev_port = prev_follow = None
    trace = []
    for i, img in enumerate(frames):
        prev_ref = ref.process_frame(i, img, prev_ref)
        prev_port = port.process_frame(i, img, prev_port)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(frontend, "filter_matches_ransac", ref_filter)
            prev_follow = follow.process_frame(i, img, prev_follow)
        gap = max((float(np.abs(a - b).max()) for a, b in
                   zip(ref.world_map.poses, follow.world_map.poses)),
                  default=0.0)
        trace.append(dict(frame=i, gap=gap, n_ref=len(ref.world_map),
                          n_follow=len(follow.world_map),
                          ids_ref=list(ref.frame_ids),
                          ids_follow=list(follow.frame_ids)))
    return dict(ref=_summary(ref, T_wc), port=_summary(port, T_wc),
                follow=_summary(follow, T_wc), trace=trace,
                filter_cases=ref_filter.cases)


def test_slice_structure_matches_reference(runs):
    ref, port = runs["ref"], runs["port"]
    assert ref["boot"] is not None and ref["lost"] == 0, ref
    assert len(ref["kfs"]) >= 3, ref  # the back half ran
    assert port["boot"] == ref["boot"], (port, ref)
    assert len(port["kfs"]) == len(ref["kfs"]), (port, ref)
    assert all(abs(a - b) <= 1 for a, b in zip(port["kfs"], ref["kfs"]))
    assert port["lost"] == 0, port
    assert port["ids"] == ref["ids"]


def _ate_before_first_keyframe(run, T_wc):
    first_kf = run["kfs"][2]
    ids = [i for i in run["ids"] if i < first_kf]
    return ate_rmse(run["poses"][:len(ids)], T_wc[ids])[0]


def test_slice_ate_matches_reference(runs, corridor):
    """Up to the first keyframe after the bootstrap the port's ATE is the
    reference's within 20%; over the whole run (past local BA, see the
    module docstring) it is no more than 20% above it."""
    T_wc = corridor[1]
    ref = _ate_before_first_keyframe(runs["ref"], T_wc)
    port = _ate_before_first_keyframe(runs["port"], T_wc)
    assert abs(port - ref) <= 0.2 * ref, (port, ref)
    assert np.isfinite(runs["port"]["ate"]), runs["port"]
    assert runs["port"]["ate"] <= 1.2 * runs["ref"]["ate"], \
        (runs["port"]["ate"], runs["ref"]["ate"])


def test_back_half_follows_reference(runs):
    """Fed the reference's front-end, the port's bootstrap, tracking,
    keyframes, triangulation and local BA give the reference's map size
    and poses at every frame, and its ATE within 20%."""
    ref, follow = runs["ref"], runs["follow"]
    assert follow["kfs"] == ref["kfs"] and follow["lost"] == 0, \
        (follow, ref)
    for t in runs["trace"]:
        assert t["ids_follow"] == t["ids_ref"], t
        assert t["n_follow"] == t["n_ref"], t
        assert t["gap"] < FOLLOW_POSE_TOL, t
    assert abs(follow["ate"] - ref["ate"]) <= 0.2 * ref["ate"], \
        (follow["ate"], ref["ate"])


def test_f_filter_differs_within_reference_float_sensitivity(runs):
    """On every F-RANSAC call of the follow run (same correspondences, same
    draws), the port's inlier set differs from the reference's by at most
    twice as much as the reference's own set moves when its pixels move by
    1e-4 px: identical where the reference's set does not move, and of the
    same size as the reference's own float sensitivity where it does."""
    rng = np.random.default_rng(0)
    cases = runs["filter_cases"]
    assert len(cases) >= 10
    for p0, p1, valid, thresh, key in cases:
        if valid.sum() < 8:
            continue
        _, ref, _ = j_find_fundamental(key, jnp.asarray(p0), jnp.asarray(p1),
                                       jnp.asarray(valid), thresh)
        ref = np.asarray(ref)
        _, got, _ = find_fundamental(JaxKey(key), torch.as_tensor(p0),
                                     torch.as_tensor(p1),
                                     torch.as_tensor(valid), thresh)
        d_port = int((got.numpy() != ref).sum())
        d_self = 0
        for _ in range(3):
            q0 = (p0 + rng.normal(scale=1e-4, size=p0.shape)).astype(
                np.float32)
            _, moved, _ = j_find_fundamental(key, jnp.asarray(q0),
                                             jnp.asarray(p1),
                                             jnp.asarray(valid), thresh)
            d_self = max(d_self, int((np.asarray(moved) != ref).sum()))
        assert d_port <= 2 * d_self, (d_port, d_self, int(valid.sum()))


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def test_oracle_phase_on_cpu():
    """Phase 6 of chip_smoke.py on the CPU: the geometric back half
    (bootstrap, PnP tracking, keyframes, triangulation, local BA) over 40
    frames of a seeded point cloud, held to the smoke's own check."""
    chip_smoke = _chip_smoke()
    res = chip_smoke.run_oracle_phase("cpu", n_frames=40)
    assert chip_smoke.oracle_ok(res), res
    assert res["bootstrap_frame"] == 2 and res["keyframes"] >= 6, res


def _writeback_to_wrong_frames(world_map, K, kfs, **kw):
    """Local BA that writes keyframe k's pose into frame k."""
    saved, world_map.keyframe_indices = world_map.keyframe_indices, []
    try:
        return local_bundle_adjustment(world_map, K, kfs, **kw)
    finally:
        world_map.keyframe_indices = saved


@pytest.mark.parametrize("fault, patch", [
    ("no_local_ba", lambda *a, **k: False),
    ("no_triangulation", lambda *a, **k: []),
    ("writeback_to_wrong_frames", _writeback_to_wrong_frames),
])
def test_oracle_check_catches_broken_back_half(fault, patch, monkeypatch):
    """Phase 6's check fails for a back half with a fault, over 20 frames
    (two local BAs). A wrong write-back tracks every frame, so only the
    ATE bound catches it."""
    chip_smoke = _chip_smoke()
    target = {"no_local_ba": "local_bundle_adjustment",
              "no_triangulation": "triangulate_between_kfs_2view",
              "writeback_to_wrong_frames": "local_bundle_adjustment"}[fault]
    monkeypatch.setattr(run_slam, target, patch)
    res = chip_smoke.run_oracle_phase("cpu", n_frames=20)
    assert not chip_smoke.oracle_ok(res), res
    if fault == "writeback_to_wrong_frames":
        assert res["lost"] == 0 and res["ate_m"] > chip_smoke.ORACLE_ATE_MAX


def test_import_pulls_in_nothing_of_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import simpleslam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in ('jax', 'flax', 'orbax', 'cv2', 'PIL', 'yaml',"
        " 'simpleslam_tpu', 'zstandard', 'tensorstore') if m in"
        " sys.modules]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_slam_system_needs_a_device_without_cuda(monkeypatch, corridor):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K = corridor[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SLAMSystem(SLAMConfig(use_lightglue=True), K)
    lens = SLAMSystem(SLAMConfig(), K, D=np.array([0.1, 0.0, 0.0, 0.0]),
                      img_hw=HW, device="cpu")
    mapx, mapy = lens._undistort_maps
    assert mapx.shape == mapy.shape == HW
    assert lens.K.dtype == np.float64 and not np.allclose(lens.K, K)
    assert np.array_equal(lens._K_t.numpy(), lens.K.astype(np.float32))
    for name in ("sift", "akaze"):
        system = SLAMSystem(SLAMConfig(detector=name), K, device="cpu")
        assert system.detector.device == torch.device("cpu")


@pytest.mark.parametrize("argv", [
    [],
    ["--use_lightglue", "--max_features", "2048", "--min_conf", "0.5",
     "--tri_kf2", "--no_reloc", "--kf_cooldown", "3"],
    # bench.py's argv for the fused main path, and the fused loop's flags
    ["--dataset", "kitti", "--headless", "--no_viz3d", "--max_features",
     "2048", "--map_capacity", "8192", "--use_lightglue", "--tri_kf2",
     "--fused_ba_points", "2048", "--local_ba_max_iters", "8"],
    ["--fused_sync_every", "16", "--map_evict_age", "8",
     "--global_reloc_after", "5", "--global_reloc_min_sim", "0.4",
     "--loop_grid", "3", "--assoc_wide_factor", "3", "--mvt_rep_err", "1.5",
     "--loop_closure", "--no_global_reloc"],
    # global BA's flags
    ["--gba_enable", "--gba_every", "7", "--gba_max_points", "500",
     "--gba_max_iters", "12", "--gba_fix_first", "0"],
    # loop closure's flags and the fused loop's rescue
    ["--loop_closure", "--fused_rescue_after", "12", "--loop_min_sim", "0.6",
     "--loop_gap_kfs", "9", "--loop_min_inliers", "20",
     "--loop_ransac_thresh", "0.2", "--loop_max_scale", "8",
     "--loop_weight", "2", "--loop_topk", "3", "--loop_pgo_iters", "10",
     "--loop_min_inlier_frac", "0.05", "--loop_confirm", "1",
     "--loop_confirm_window", "6", "--loop_confirm_strong", "0.2",
     "--loop_drift_frac_max", "0.4"],
    # the README's CLI flags
    ["--dataset", "kitti", "--base_dir", "/data/synth", "--headless",
     "--no_viz3d", "--fused", "--prefetch", "2", "--stage_all", "--matcher",
     "flann"],
    # saved state, localisation-only, thumbnails and the detectors
    ["--resume", "a.npz", "--save_state", "b.npz", "--localize_only",
     "--kf_thumb_hw", "320", "180", "--detector", "sift"],
    ["--detector", "akaze"],
    # the landmark fusion radius (no driver reads it in either package)
    ["--merge_radius", "0.2"],
    # the local-BA reprojection overlays
    ["--viz_ba"],
    # the mesh size (no driver reads it) and the profiler trace
    ["--mesh_devices", "4", "--trace_dir", "x"],
])
def test_config_matches_reference(argv):
    """Every field of the port's config parses as the reference's field of
    the same name does."""
    import dataclasses
    from simpleslam_tpu.config import parse_config as jparse
    from simpleslam_tpu_torch.config import parse_config
    port, ref = parse_config(argv), jparse(argv)
    assert dataclasses.asdict(port) == {
        f.name: getattr(ref, f.name) for f in dataclasses.fields(port)}


@pytest.mark.parametrize("argv", [["--pad_features", "512"],
                                  ["--fps", "5"],
                                  ["--compute_dtype", "bfloat16"]])
def test_config_rejects_flags_of_unported_paths(argv):
    """The TPU package's keypoint padding and compute dtype have no reader
    in the port, and ``--fps`` none in either package: the parser refuses
    them instead of ignoring them."""
    from simpleslam_tpu.config import parse_config as jparse
    from simpleslam_tpu_torch.config import parse_config
    jparse(argv)
    with pytest.raises(SystemExit):
        parse_config(argv)
