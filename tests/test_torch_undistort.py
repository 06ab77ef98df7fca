"""Lens undistortion of the port against the JAX package on the CPU: the
six distortion functions of ``ops/projection.py``, ``SLAMSystem`` with a
distortion vector (the maps, the new camera matrix, the host's
``preprocess``) in lockstep with the JAX ``SLAMSystem``, and the fused
step with the maps against the JAX fused step.

Fixture: ``bench.py``'s small corridor (180x410, its intrinsics and argv)
seen through ``tests/test_calibrate.py``'s lens
D = (-0.25, 0.08, 1e-3, -5e-4, 0): each frame is a pinhole render widened
by 64 px on every side, sampled at ``chip_smoke.lens_map``'s float64
inverse of the lens model (independent of ``ops/projection.py``).

Run as a script, it takes the JAX package's reading of phase 10 (a) of
``chip_smoke.py`` on the CPU: ``bench.py``'s fused main path (host
bootstrap, then the fused step with the maps) over the distorted corridor:

    JAX_PLATFORMS=cpu python tests/test_torch_undistort.py [--small]
        [--frames N] [--seeds 0,1]
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

D_LENS = chip_smoke.LENS_D
DIST_TOL = 1e-4       # px, distort / undistort
MAP_TOL = 1e-3        # px, the rectify maps
NEWK_TOL = 1e-4       # the new camera matrix, entries
REMAP_F_TOL = 1e-4    # float remap, grey levels
REMAP_U8_SHARE = 1e-3  # uint8 remap: share of pixels off by at most 1
FOLLOW_POSE_TOL = 2e-3  # as tests/test_torch_slam.py's follow run
# The reference bootstraps at frame 1 and makes its first keyframe after
# that at frame 7. Up to frame 6 the pair follows to float noise; at frame
# 7 the fused step from the reference's state triangulates 128 landmarks
# against the reference's 129 (one at a gate) and its local BA then moves
# the pose by up to 0.11 m of translation (CPU): keyframes are held without
# a lens by tests/test_torch_fused.py and tests/test_torch_slam.py.
N_FRAMES = 7
SMALL_MARGIN = 64


def distorted_corridor(small: bool, n_frames: int):
    """``bench.py``'s corridor (the JAX package's renderer) seen through
    the lens: (hw, K, argv, T_wc, frames)."""
    import simpleslam_tpu.tools.synth as jsynth
    hw, K, argv = chip_smoke.bench_setup(small)
    margin = SMALL_MARGIN if small else chip_smoke.LENS_MARGIN
    chw, cK = chip_smoke.pinhole_canvas(K, hw, margin)
    mapx, mapy = chip_smoke.lens_map(K, D_LENS, hw, margin)
    T = jsynth.make_trajectory(n_frames, speed=0.5, yaw_rate_deg=0.3)
    scene = jsynth.CorridorScene(seed=0, hw=chw, K=cK)
    frames = np.stack([chip_smoke.distort_frame(
        np.asarray(scene.render(T[i])), mapx, mapy)
        for i in range(n_frames)])
    return hw, K, argv, T, frames


def jax_distorted_reading(small: bool, n_frames: int, seed: int = 0) -> dict:
    """The JAX package's fused main path with ``D`` over the distorted
    corridor: bootstrap frame, keyframes, lost frames, Sim(3) ATE."""
    import jax.numpy as jnp
    from simpleslam_tpu.config import parse_config
    from simpleslam_tpu.core.fused import (build_fused_step,
                                           make_fused_config,
                                           state_from_host)
    from simpleslam_tpu.run_slam import SLAMSystem
    from simpleslam_tpu.tools.trajectory_eval import ate_rmse

    t0 = time.time()
    hw, K, argv, T, frames = distorted_corridor(small, n_frames)
    cfg = parse_config(argv + ["--seed", str(seed)])
    system = SLAMSystem(cfg, K, D_LENS, img_hw=hw)
    prev = system.process_frame(0, frames[0], None)
    start = 1
    while start < n_frames and not system.initialised:
        prev = system.process_frame(start, frames[start], prev)
        start += 1
    fc = make_fused_config(cfg, hw, n_kp=int(prev.kpts.shape[0]),
                           desc_dim=int(np.asarray(prev.desc).shape[1]),
                           log_capacity=1024)
    match_fn = getattr(system.matcher, "fn_fast", None) or system.matcher.fn
    step = build_fused_step(fc, system.K, system.detector.fn, match_fn,
                            system._undistort_maps)
    state = state_from_host(system, fc, prev)
    boot_poses = np.stack([np.asarray(p) for p in system.world_map.poses])
    boot_ids = list(system.frame_ids)
    for i in range(start, n_frames):
        state = step(state, jnp.asarray(frames[i]))
    n = n_frames - start
    flags = np.asarray(state.log_flags)[:n]
    est = np.concatenate([boot_poses, np.asarray(state.log_pose)[:n]])
    ids = boot_ids + list(range(start, n_frames))
    return {"frames": n_frames, "hw": list(hw), "seed": seed,
            "newK": np.asarray(system.K).tolist(),
            "bootstrap_frame": start - 1, "keyframes": int(state.kf_count),
            "lost": int(n - flags[:, 0].sum()),
            "map_points": int(state.n_points),
            "ate_m": float(ate_rmse(est, T[ids])[0]),
            "seconds": time.time() - t0}


# --------------------------------------------------------------------------- #
# the CPU tests
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor():
    return distorted_corridor(True, N_FRAMES)


def _jt(a):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(a, np.float32))


def _tt(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("n_coef", [4, 5])
def test_projection_functions_match_reference(corridor, n_coef):
    """distort / undistort (D as 4 or 5 coefficients, with and without
    ``P``), the new camera matrix, the maps, and the remap of a float and a
    uint8 (BGR and grey) frame."""
    from simpleslam_tpu.ops import projection as jproj
    from simpleslam_tpu_torch.ops import projection as proj
    hw, K, _argv, _T, frames = corridor
    H, W = hw
    D = D_LENS[:n_coef]
    rng = np.random.default_rng(n_coef)
    uv = np.column_stack([rng.uniform(0, W, 200), rng.uniform(0, H, 200)])
    ref = np.asarray(jproj.distort_points(_jt(uv), _jt(K), _jt(D)))
    got = proj.distort_points(_tt(uv), _tt(K), _tt(D)).numpy()
    assert np.abs(got - ref).max() <= DIST_TOL
    for P in (None, K):
        ref = np.asarray(jproj.undistort_points(
            _jt(uv), _jt(K), _jt(D), P=None if P is None else _jt(P)))
        got = proj.undistort_points(_tt(uv), _tt(K), _tt(D),
                                    P=None if P is None else _tt(P)).numpy()
        scale = 1.0 if P is None else 1.0 / K[0, 0]
        assert np.abs(got - ref).max() * scale <= DIST_TOL / K[0, 0]
    lift = proj.undistort_points(_tt(uv), _tt(K)).numpy()
    assert np.abs(lift - np.asarray(jproj.undistort_points(
        _jt(uv), _jt(K)))).max() <= DIST_TOL / K[0, 0]

    newK_ref = jproj.optimal_new_camera_matrix(_jt(K), _jt(D), (W, H))
    newK = proj.optimal_new_camera_matrix(_tt(K), _tt(D), (W, H))
    assert np.abs(newK.numpy() - np.asarray(newK_ref)).max() <= NEWK_TOL
    mx_r, my_r = jproj.undistort_rectify_map(_jt(K), _jt(D), newK_ref, (W, H))
    mx, my = proj.undistort_rectify_map(_tt(K), _tt(D),
                                        _tt(np.asarray(newK_ref)), (W, H))
    assert mx.shape == (H, W) and my.shape == (H, W)
    assert np.abs(mx.numpy() - np.asarray(mx_r)).max() <= MAP_TOL
    assert np.abs(my.numpy() - np.asarray(my_r)).max() <= MAP_TOL
    mx_r, my_r = np.asarray(mx_r), np.asarray(my_r)

    grey = frames[0].astype(np.float32) + rng.uniform(0, 1, frames[0].shape
                                                      ).astype(np.float32)
    ref = np.asarray(jproj.remap_bilinear(_jt(grey), _jt(mx_r), _jt(my_r)))
    got = proj.remap_bilinear(_tt(grey), _tt(mx_r), _tt(my_r)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= REMAP_F_TOL
    bgr = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    bgr[..., 1] = frames[0]
    for img in (bgr, frames[0]):
        import jax.numpy as jnp
        ref = np.asarray(jproj.remap_bilinear(jnp.asarray(img), _jt(mx_r),
                                              _jt(my_r)))
        got = proj.remap_bilinear(torch.as_tensor(img), _tt(mx_r),
                                  _tt(my_r)).numpy()
        assert got.dtype == np.uint8 and got.shape == img.shape
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= REMAP_U8_SHARE


def test_remap_zeroes_each_outside_tap():
    """BORDER_CONSTANT: a map half a pixel outside each border blends the
    edge pixel with 0; a map further out gives 0."""
    from simpleslam_tpu_torch.ops.projection import remap_bilinear
    img = torch.full((4, 5), 200.0)
    mapx = torch.tensor([[-0.5, 4.5, 2.0, 2.0, -2.0]])
    mapy = torch.tensor([[1.0, 1.0, -0.5, 3.5, 1.0]])
    out = remap_bilinear(img, mapx, mapy)
    assert out.tolist() == [[100.0, 100.0, 100.0, 100.0, 0.0]]
    u8 = remap_bilinear(img.to(torch.uint8), mapx + 0.25, mapy)
    assert u8.dtype == torch.uint8 and u8.tolist() == [[150, 50, 100, 100,
                                                        0]]


def _orb_argv(argv):
    """bench.py's small argv with the ORB front-end (the learned one's
    JAX compiles would cost minutes here)."""
    return [a for a in argv if a != "--use_lightglue"]


@pytest.fixture(scope="module")
def host_runs(corridor):
    """The JAX SLAMSystem and the port's ("follow": the reference's ORB
    features, matcher and F-RANSAC filter, its RANSAC draws) with the lens,
    frame by frame; then, from the reference's bootstrap, the JAX fused
    step with the maps and the port's fused step on the same frames."""
    import jax
    import jax.numpy as jnp
    from simpleslam_tpu.config import parse_config as jparse
    from simpleslam_tpu.core.fused import build_fused_step as j_build
    from simpleslam_tpu.core.fused import make_fused_config as j_config
    from simpleslam_tpu.core.fused import state_from_host as j_state
    from simpleslam_tpu.run_slam import SLAMSystem as JSystem
    from test_torch_fused import _to_port_state
    from test_torch_slam import (JaxKey, _ReferenceFilter,
                                 _ReferenceFrontEnd, _ReferenceMatcher)
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.core import frontend
    from simpleslam_tpu_torch.core.fused import (build_fused_step,
                                                 make_fused_config)
    from simpleslam_tpu_torch.run_slam import SLAMSystem
    from simpleslam_tpu.ops.epipolar import \
        find_fundamental as j_fundamental
    from simpleslam_tpu_torch.ops import epipolar

    def _reference_fundamental(key, p0, p1, valid, thresh, n_hyp=256):
        F, inl, ok = j_fundamental(key.key, jnp.asarray(p0.numpy()),
                                   jnp.asarray(p1.numpy()),
                                   jnp.asarray(valid.numpy()), thresh,
                                   n_hyp=n_hyp)
        return tuple(torch.as_tensor(np.array(a)) for a in (F, inl, ok))

    hw, K, argv, T, frames = corridor
    argv = _orb_argv(argv)
    ref = JSystem(jparse(argv), K, D_LENS, img_hw=hw)
    cfg = parse_config(argv)
    follow = SLAMSystem(cfg, K, D_LENS, img_hw=hw, device="cpu",
                        key=JaxKey(jax.random.PRNGKey(cfg.seed)))
    follow.detector = _ReferenceFrontEnd(ref)
    follow.matcher = _ReferenceMatcher(ref)
    rows, steps = [], []
    prev_r = prev_f = fused = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(frontend, "filter_matches_ransac", _ReferenceFilter())
        mp.setattr(epipolar, "find_fundamental", _reference_fundamental)
        for i in range(len(frames)):
            pre_r = ref.preprocess(frames[i])
            pre_f = follow.preprocess(frames[i]).numpy()
            if fused is not None:
                jstep, jst, pstep, pst = fused
                forced = pstep(_to_port_state(jst, key),
                               torch.as_tensor(frames[i]))
                jst = jstep(jst, jnp.asarray(frames[i]))
                pst = pstep(pst, torch.as_tensor(frames[i]))
                fused = (jstep, jst, pstep, pst)
                r = len(steps)
                steps.append(dict(
                    frame=i, j_pose=np.asarray(jst.log_pose[r]),
                    p_pose=pst.log_pose[r].numpy(),
                    f_pose=forced.log_pose[r].numpy(),
                    j_flags=np.asarray(jst.log_flags[r]),
                    p_flags=pst.log_flags[r].numpy(),
                    f_flags=forced.log_flags[r].numpy(),
                    j_kf=int(jst.kf_count), p_kf=int(pst.kf_count),
                    f_kf=int(forced.kf_count), j_pts=int(jst.n_points),
                    p_pts=int(pst.n_points), f_pts=int(forced.n_points)))
            boot = not ref.initialised
            prev_r = ref.process_frame(i, frames[i], prev_r)
            prev_f = follow.process_frame(i, frames[i], prev_f)
            gap = max((float(np.abs(a - b).max()) for a, b in
                       zip(ref.world_map.poses, follow.world_map.poses)),
                      default=0.0)
            rows.append(dict(frame=i, pre_r=pre_r, pre_f=pre_f, gap=gap,
                             ids_r=list(ref.frame_ids),
                             ids_f=list(follow.frame_ids),
                             n_r=len(ref.world_map),
                             n_f=len(follow.world_map)))
            if boot and ref.initialised:
                # the fused steps start from the reference's bootstrap
                jfc = j_config(ref.cfg, hw, n_kp=int(prev_r.kpts.shape[0]),
                               desc_dim=int(np.asarray(prev_r.desc).shape[1]),
                               log_capacity=64)
                jst = j_state(ref, jfc, prev_r)
                key = JaxKey(jnp.array(ref._base_key))
                pfc = make_fused_config(cfg, hw, jfc.n_kp, jfc.desc_dim,
                                        log_capacity=64)
                jstep = j_build(jfc, ref.K, ref.detector.fn,
                                ref.matcher.fn, ref._undistort_maps)
                pstep = build_fused_step(pfc, follow.K, follow.detector.fn,
                                         follow.matcher.fn, "cpu",
                                         follow._undistort_maps)
                fused = (jstep, jst, pstep, _to_port_state(jst, key))
    return dict(ref=ref, follow=follow, rows=rows, steps=steps)


def test_system_builds_maps_and_new_k(host_runs):
    ref, follow = host_runs["ref"], host_runs["follow"]
    assert follow._undistort_maps is not None
    assert np.abs(follow.K - ref.K).max() <= NEWK_TOL
    assert np.array_equal(follow._K_t.numpy(),
                          follow.K.astype(np.float32))
    for m_r, m_f in zip(ref._undistort_maps, follow._undistort_maps):
        assert np.abs(m_f.numpy() - np.asarray(m_r)).max() <= MAP_TOL


def test_host_follows_reference(host_runs):
    """Each frame: the preprocessed (undistorted uint8) frame equal but for
    at most 1 level on REMAP_U8_SHARE of its pixels; the posed frames, the
    map size and the poses (FOLLOW_POSE_TOL) the reference's."""
    rows = host_runs["rows"]
    for r in rows:
        diff = np.abs(r["pre_f"].astype(int) - r["pre_r"].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= REMAP_U8_SHARE, \
            r["frame"]
        assert r["ids_f"] == r["ids_r"] and r["n_f"] == r["n_r"], r["frame"]
        assert r["gap"] < FOLLOW_POSE_TOL, (r["frame"], r["gap"])
    assert rows[-1]["ids_r"] == list(range(N_FRAMES))
    assert rows[-1]["n_r"] > 100

def test_fused_step_with_maps_follows_reference(host_runs):
    """From the reference's bootstrap, on every later frame, the port's
    fused step with the maps gives the reference's step
    (tests/test_torch_fused.py's checks), from the reference's state before
    it and on its own state."""
    from test_torch_fused import _same_step
    steps = host_runs["steps"]
    assert len(steps) == N_FRAMES - 2
    for r in steps:
        _same_step(r, "f")
        _same_step(r, "p")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", default="0",
                    help="comma-separated RANSAC seeds, one reading each")
    a = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps({"package": "jax", **jax_distorted_reading(
            a.small, a.frames, seed)}), flush=True)
