"""The fused main path of the port against the JAX package's, on
``bench.py``'s corridor at its small size (180x410, 512 keypoints, map
capacity 2048, ``--tri_kf2``), with the trained weights:

* (e) ``ba_solve(point_major_obs=4)`` against the reference's on one
  problem (poses to 1e-4, points to 1e-3 m at 5-15 m depth, float32 over
  8 LM steps), and equal to the port's generic edge layout;
* (f) the port's fused step against the JAX package's fused step, fed the
  reference's front-end, F-RANSAC filter and RANSAC draws ("follow", as in
  ``tests/test_torch_slam.py``): on every frame, one port step from the
  reference's state before it (converted tensor for tensor) gives the
  reference's flags, counts, keyframe count and map size, and its pose to
  ``FOLLOW_POSE_TOL`` (``FOLLOW_BA_POSE_TOL`` after local BA on a later
  keyframe); run on its own state from the reference's bootstrap, the
  port's step follows to float noise up to the first keyframe and takes
  the same decisions on every frame;
* (g) the port's host driver against the port's fused loop, mirroring
  ``tests/test_fused.py::test_fused_matches_host``: the same keyframe
  schedule, pre-keyframe poses within 0.02 m, Sim(3) shape band, ATE band.

Run as a script, it takes the JAX package's reading of ``bench.py``'s
fused main path on the CPU (host bootstrap, then the fused step over the
remaining corridor frames; ``bench_e2e_fused``'s setup without the
timing) and prints its ATE and lost frames, the accuracy ``chip_smoke.py``
holds the card to:

    JAX_PLATFORMS=cpu python tests/test_torch_fused.py [--small] [--frames N]
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


def corridor_setup(small: bool):
    """``bench_e2e_fused``'s sizes, intrinsics and argv, as the smoke's
    main path takes them."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.bench_setup(small)


def jax_corridor_reading(small: bool, n_frames: int, seed: int = 0) -> dict:
    """The JAX package's fused main path on the corridor with RANSAC seed
    ``seed``: bootstrap frame, keyframes, lost frames, map points, Sim(3)
    ATE, and the ATE through the first keyframe of the fused loop."""
    import jax
    import jax.numpy as jnp
    from simpleslam_tpu.config import parse_config
    from simpleslam_tpu.core.fused import (build_fused_step,
                                           make_fused_config,
                                           state_from_host)
    from simpleslam_tpu.run_slam import SLAMSystem
    from simpleslam_tpu.tools.synth import CorridorScene, make_trajectory
    from simpleslam_tpu.tools.trajectory_eval import ate_rmse

    t0 = time.time()
    hw, K, argv = corridor_setup(small)
    T = make_trajectory(n_frames, speed=0.5, yaw_rate_deg=0.3)
    scene = CorridorScene(seed=0, hw=hw, K=K)
    frames = np.stack([scene.render(T[i]) for i in range(n_frames)])
    cfg = parse_config(argv + ["--seed", str(seed)])
    system = SLAMSystem(cfg, K, None, img_hw=hw)
    prev = system.process_frame(0, frames[0], None)
    start = 1
    while start < n_frames and not system.initialised:
        prev = system.process_frame(start, frames[start], prev)
        start += 1
    fc = make_fused_config(cfg, hw, n_kp=int(prev.kpts.shape[0]),
                           desc_dim=int(np.asarray(prev.desc).shape[1]),
                           log_capacity=1024)
    match_fn = getattr(system.matcher, "fn_fast", None) or system.matcher.fn
    step = build_fused_step(fc, system.K, system.detector.fn, match_fn, None)
    state = state_from_host(system, fc, prev)
    boot_poses = np.stack([np.asarray(p) for p in system.world_map.poses])
    boot_ids = list(system.frame_ids)
    for i in range(start, n_frames):
        state = step(state, jnp.asarray(frames[i]))
    n = n_frames - start
    flags = np.asarray(state.log_flags)[:n]
    est = np.concatenate([boot_poses, np.asarray(state.log_pose)[:n]])
    ids = boot_ids + list(range(start, n_frames))
    kf_rows = np.flatnonzero(flags[:, 1] > 0.5)
    n_pre = len(boot_ids) + (int(kf_rows[0]) + 1 if len(kf_rows) else n)
    return {"frames": n_frames, "hw": list(hw), "seed": seed,
            "bootstrap_frame": start - 1,
            "keyframes": int(state.kf_count),
            "lost": int(n - flags[:, 0].sum()),
            "map_points": int(state.n_points),
            "ate_m": float(ate_rmse(est, T[ids])[0]),
            "ate_first_kf_m": float(ate_rmse(est[:n_pre], T[ids[:n_pre]])[0]),
            "seconds": time.time() - t0}



# --------------------------------------------------------------------------- #
# the CPU tests
# --------------------------------------------------------------------------- #

N_FRAMES = 14
SEED = 0
# One step from the same state runs the same arithmetic on the same inputs:
# pose entries agree to float32 rounding (local BA's 8 float32 LM steps on
# the first keyframe: 1.2e-3, CPU).
FOLLOW_POSE_TOL = 2e-3
# Local BA on a later keyframe optimises a longer window whose scale only
# the fixed keyframe and the damping hold: from the same state the two
# packages' float32 LM steps land 1.1e-2 apart in the pose entries on the
# second keyframe (CPU), with every count equal.
FOLLOW_BA_POSE_TOL = 2e-2


def _centre(T):
    return -T[:3, :3].T @ T[:3, 3]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor():
    import simpleslam_tpu.tools.synth as jsynth
    hw, K, argv = corridor_setup(True)
    T = jsynth.make_trajectory(N_FRAMES, speed=0.5, yaw_rate_deg=0.3)
    scene = jsynth.CorridorScene(seed=SEED, hw=hw, K=K)
    frames = np.stack([scene.render(T[i]) for i in range(N_FRAMES)])
    return hw, K, argv, T, frames


def test_point_major_ba_matches_reference():
    import jax.numpy as jnp
    from simpleslam_tpu.ops.ba import BAProblem as JProblem
    from simpleslam_tpu.ops.ba import ba_solve as j_ba_solve
    from simpleslam_tpu_torch.ops.ba import BAProblem, ba_solve
    rng = np.random.default_rng(0)
    P, L, O = 6, 300, 4
    K = np.array([[400, 0, 200], [0, 400, 150], [0, 0, 1.]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    poses[:, 0, 3] = 0.3 * np.arange(P)
    poses[:, 2, 3] = -0.5 * np.arange(P)
    X = np.column_stack([rng.uniform(-4, 4, L), rng.uniform(-2, 2, L),
                         rng.uniform(5, 15, L)]).astype(np.float32)
    cam_idx = rng.integers(0, P, L * O)
    pt_idx = np.repeat(np.arange(L), O)
    valid = rng.random(L * O) < 0.8
    pc = np.einsum("eij,ej->ei", poses[cam_idx][:, :3, :3], X[pt_idx]) \
        + poses[cam_idx][:, :3, 3]
    uv = (pc[:, :2] / pc[:, 2:] * 400 + [200, 150]
          + rng.normal(scale=0.5, size=(L * O, 2))).astype(np.float32)
    X0 = (X + rng.normal(scale=0.05, size=X.shape)).astype(np.float32)
    P0 = poses.copy()
    P0[1:, :3, 3] += rng.normal(scale=0.02, size=(P - 1, 3))
    cam_free = np.arange(P) >= 2
    args = (P0, X0, cam_idx, pt_idx, uv, valid, cam_free, np.ones(L, bool))
    ref = j_ba_solve(JProblem(*(jnp.asarray(a.astype(np.int32)
                                            if a.dtype == np.int64 else a)
                                for a in args)),
                     jnp.asarray(K), max_iters=8, point_major_obs=O)
    prob = BAProblem(*(torch.as_tensor(a) for a in args))
    got = ba_solve(prob, torch.as_tensor(K), max_iters=8, point_major_obs=O)
    assert np.abs(got[0].numpy() - np.asarray(ref[0])).max() <= 1e-4
    assert np.abs(got[1].numpy() - np.asarray(ref[1])).max() <= 1e-3
    assert abs(float(got[3]) - float(ref[3])) <= 1e-5 * float(ref[3])
    assert int(got[4]) == int(ref[4])
    generic = ba_solve(prob, torch.as_tensor(K), max_iters=8)
    assert torch.equal(generic[0], got[0]) and torch.equal(generic[1], got[1])
    assert int(generic[4]) == int(got[4])
    with pytest.raises(ValueError, match="E == L\\*O"):
        ba_solve(prob, torch.as_tensor(K), point_major_obs=3)


def _to_port_state(jstate, key):
    """The JAX package's FusedState as the port's, tensor for tensor."""
    from simpleslam_tpu_torch.core.fused import FusedState
    kw = {}
    for f in FusedState.__dataclass_fields__:
        v = np.asarray(getattr(jstate, f)) if f != "key" else None
        if f == "key":
            kw[f] = key
        elif f in ("frame_no", "log_n"):
            kw[f] = int(v)
        else:
            t = torch.as_tensor(np.array(v))
            kw[f] = t.long() if t.dtype == torch.int32 else t
    return FusedState(**kw)


@pytest.fixture(scope="module")
def follow_runs(corridor):
    """The JAX fused step and the port's, in lockstep from one bootstrap."""
    import jax.numpy as jnp
    from simpleslam_tpu.config import parse_config as jparse
    from simpleslam_tpu.core.fused import build_fused_step as j_build
    from simpleslam_tpu.core.fused import make_fused_config as j_config
    from simpleslam_tpu.core.fused import state_from_host as j_state
    from simpleslam_tpu.ops.epipolar import find_fundamental as j_fundamental
    from simpleslam_tpu.run_slam import SLAMSystem as JSystem
    from test_torch_slam import JaxKey, _ReferenceFrontEnd, _ReferenceMatcher
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.core.fused import (build_fused_step,
                                                 make_fused_config)
    from simpleslam_tpu_torch.ops import epipolar

    hw, K, argv, T, frames = corridor
    jcfg = jparse(argv)
    ref = JSystem(jcfg, K, None, img_hw=hw)
    prev = ref.process_frame(0, frames[0], None)
    start = 1
    while not ref.initialised:
        prev = ref.process_frame(start, frames[start], prev)
        start += 1
    jfc = j_config(jcfg, hw, n_kp=int(prev.kpts.shape[0]),
                   desc_dim=int(np.asarray(prev.desc).shape[1]),
                   log_capacity=64)
    jstep = j_build(jfc, ref.K, ref.detector.fn, ref.matcher.fn, None)
    jst = j_state(ref, jfc, prev)
    pstate = _to_port_state(jst, JaxKey(jnp.array(ref._base_key)))
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in vars(pstate).items()
              if torch.is_tensor(v)}
    pfc = make_fused_config(parse_config(argv), hw, jfc.n_kp, jfc.desc_dim,
                            log_capacity=64)
    assert pfc._asdict() == {k: v for k, v in jfc._asdict().items()
                             if k in pfc._fields}
    detector, matcher = _ReferenceFrontEnd(ref), _ReferenceMatcher(ref)
    pstep = build_fused_step(pfc, K, detector.fn, matcher.fn, "cpu")

    def ref_fundamental(key, p0, p1, valid, thresh, n_hyp=256):
        F, inl, ok = j_fundamental(key.key, jnp.asarray(p0.numpy()),
                                   jnp.asarray(p1.numpy()),
                                   jnp.asarray(valid.numpy()), thresh,
                                   n_hyp=n_hyp)
        return (torch.as_tensor(np.array(F)), torch.as_tensor(np.array(inl)),
                torch.as_tensor(np.array(ok)))

    fstep = build_fused_step(pfc, K, detector.fn, matcher.fn, "cpu")
    key = JaxKey(jnp.array(ref._base_key))
    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(epipolar, "find_fundamental", ref_fundamental)
        for i in range(start, N_FRAMES):
            forced = fstep(_to_port_state(jst, key), torch.as_tensor(frames[i]))
            jst = jstep(jst, jnp.asarray(frames[i]))
            pstate = pstep(pstate, torch.as_tensor(frames[i]))
            r = i - start
            rows.append(dict(
                frame=i, j_pose=np.asarray(jst.log_pose[r]),
                p_pose=pstate.log_pose[r].numpy(),
                f_pose=forced.log_pose[r].numpy(),
                j_flags=np.asarray(jst.log_flags[r]),
                p_flags=pstate.log_flags[r].numpy(),
                f_flags=forced.log_flags[r].numpy(),
                j_kf=int(jst.kf_count), p_kf=int(pstate.kf_count),
                f_kf=int(forced.kf_count),
                j_pts=int(jst.n_points), p_pts=int(pstate.n_points),
                f_pts=int(forced.n_points)))
    return dict(start=start, rows=rows, reads=pstep.host_reads, T=T,
                shapes=shapes, fc=pfc, jfc=jfc, jstate=jst, ref=ref, key=key)


def _same_step(r, p, pose_tol=FOLLOW_POSE_TOL):
    """Row ``r``'s port step (prefix ``p``: free-running or forced) against
    the reference's: tracked, keyframe, ba_ran and considered equal, the
    keyframe count, the new points and the map size equal, n_inl and n_cand
    within 2, pose entries to ``pose_tol``."""
    flags, jf = r[p + "_flags"], r["j_flags"]
    assert np.array_equal(flags[[0, 1, 5, 6]], jf[[0, 1, 5, 6]]), r
    assert r[p + "_kf"] == r["j_kf"] and flags[0] == 1.0, r
    assert np.abs(flags[[2, 4]] - jf[[2, 4]]).max() <= 2, r
    assert flags[3] == jf[3] and r[p + "_pts"] == r["j_pts"], r
    gap = np.abs(r[p + "_pose"] - r["j_pose"]).max()
    assert gap < pose_tol, (p, r["frame"], gap)


def test_fused_step_follows_reference(follow_runs):
    """Every frame, the port's step from the reference's state before it
    (converted tensor for tensor) gives the reference's step; run on its own
    state, the port's step follows the reference's to float noise up to the
    first keyframe after the bootstrap. Past that keyframe the free-running
    pair parts: local BA's float32 rounding differs by ~1e-3 between the
    packages, and this corridor turns it into a different PnP inlier set a
    frame or a few later (module docstring of ``tests/test_torch_main_path.py``)."""
    rows = follow_runs["rows"]
    assert len(rows) >= 10
    first_kf = next(r["frame"] for r in rows if r["j_flags"][1] > 0.5)
    assert sum(r["j_flags"][1] > 0.5 for r in rows) >= 2
    for r in rows:
        later_ba = r["frame"] > first_kf and r["j_flags"][5] > 0.5
        _same_step(r, "f", FOLLOW_BA_POSE_TOL if later_ba
                   else FOLLOW_POSE_TOL)
        if r["frame"] <= first_kf:
            _same_step(r, "p")
        # free-running, every frame: the same decisions and keyframe count
        assert np.array_equal(r["p_flags"][[0, 1, 5, 6]],
                              r["j_flags"][[0, 1, 5, 6]]), r
        assert r["p_kf"] == r["j_kf"], r
    # two reads per frame, more on keyframe candidates and keyframes
    assert 2 * len(rows) <= follow_runs["reads"] <= 6 * len(rows)


def test_abstract_state_has_the_step_shapes(follow_runs):
    """``abstract_state`` has the shapes and dtypes of a state converted
    from the reference's bootstrap (with the port's int64 indices)."""
    from simpleslam_tpu_torch.core.fused import abstract_state
    st = abstract_state(follow_runs["fc"])
    got = {k: (tuple(v.shape), v.dtype) for k, v in vars(st).items()
           if torch.is_tensor(v)}
    assert got == follow_runs["shapes"]


def test_fused_loop_matches_host(corridor):
    """The port's host driver and its fused loop on the same frames,
    weights and seeds (``tests/test_fused.py::test_fused_matches_host``'s
    checks)."""
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.core.trajectory_utils import umeyama_sim3
    from simpleslam_tpu_torch.run_slam import SLAMSystem, run_fused_loop
    from simpleslam_tpu_torch.tools.trajectory_eval import ate_rmse
    hw, K, argv, T, frames = corridor
    cfg = parse_config(argv)

    def bootstrapped():
        s = SLAMSystem(cfg, K, None, img_hw=hw, device="cpu")
        prev = s.process_frame(0, frames[0], None)
        i = 1
        while not s.initialised:
            prev = s.process_frame(i, frames[i], prev)
            i += 1
        return s, prev, i

    host, prev, start = bootstrapped()
    for i in range(start, N_FRAMES):
        prev = host.process_frame(i, frames[i], prev)
    fused, prev, start = bootstrapped()
    state, step = run_fused_loop(cfg, fused, list(frames[start:]), prev,
                                 start)
    kf_h = [kf.frame_idx for kf in host.kfs]
    kf_f = [kf.frame_idx for kf in fused.kfs]
    assert kf_f == kf_h and len(kf_h) >= 3
    assert fused.frame_ids == host.frame_ids == list(range(N_FRAMES))
    assert fused.tracking_lost_count == 0 == host.tracking_lost_count
    ch = {f: -p[:3, :3].T @ p[:3, 3]
          for f, p in zip(host.frame_ids, host.world_map.poses)}
    cf = {f: -p[:3, :3].T @ p[:3, 3]
          for f, p in zip(fused.frame_ids, fused.world_map.poses)}
    first_kf = kf_h[2]
    d_pre = [np.linalg.norm(cf[f] - ch[f]) for f in ch if 1 < f < first_kf]
    assert len(d_pre) >= 3 and max(d_pre) < 0.02, d_pre
    A = np.stack([cf[f] for f in sorted(ch)])
    B = np.stack([ch[f] for f in sorted(ch)])
    s, R, t = umeyama_sim3(A, B)
    d = np.linalg.norm(s * A @ R.T + t - B, axis=1)
    assert np.median(d) < 0.6 and d.max() < 2.0, d
    assert abs(s - 1.0) < 0.15, s
    ate_h = ate_rmse(np.stack(host.world_map.poses), T[host.frame_ids])[0]
    ate_f = ate_rmse(np.stack(fused.world_map.poses), T[fused.frame_ids])[0]
    assert abs(ate_f - ate_h) < 0.5 * max(ate_h, 0.05), (ate_f, ate_h)
    assert len(fused.world_map) > 0.5 * len(host.world_map)
    assert int(state.n_points) == len(fused.world_map)


def test_fused_loop_raises_for_loop_closure_and_without_a_device(
        corridor, monkeypatch):
    """The fused loop with the closer on runs without a GPU only with
    ``device="cpu"`` (loop closure itself no longer raises: it is held by
    ``tests/test_torch_loop.py``); without that device, every entry point
    raises."""
    from simpleslam_tpu_torch import run_slam
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.run_slam import SLAMSystem
    hw, K, argv, _T, _frames = corridor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_slam.run(parse_config(argv + ["--loop_closure", "--fused"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SLAMSystem(parse_config(argv), K, img_hw=hw)
    from simpleslam_tpu_torch.core.fused import (build_fused_step,
                                                 make_fused_config)
    fc = make_fused_config(parse_config(argv), hw, 512, 128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fused_step(fc, K, None, None)


def test_sync_archive_and_host_correction_match_reference(follow_runs):
    """On the lockstep run's last state with 40 of the bootstrap's
    landmarks evicted on the device: ``sync_to_host`` gives the
    reference's host map (the evicted landmarks archived with their
    (keyframe, keypoint) pairs, live ids, positions to 1e-6 m, poses,
    keyframes); then, after the same rigid rewrite of both host maps (as a
    closure's), ``apply_host_correction`` gives the reference's positions,
    ring poses, ``Tcw``, ``Tcw_prev`` (1e-5) and ``ba_floor_kf``."""
    import copy
    from types import SimpleNamespace
    import jax.numpy as jnp
    from simpleslam_tpu.core.fused import apply_host_correction as j_apply
    from simpleslam_tpu.core.fused import sync_to_host as j_sync
    from simpleslam_tpu_torch.core.fused import (apply_host_correction,
                                                 sync_to_host)
    from test_torch_loop import port_keyframes, port_map
    ref, jst = follow_runs["ref"], follow_runs["jstate"]
    alive, pid = np.array(jst.alive), np.array(jst.pid)
    host_pids = set(ref.world_map.point_ids())
    rows = [r for r in range(int(jst.n_points))
            if alive[r] and int(pid[r]) in host_pids][:40]
    assert len(rows) == 40
    alive[rows] = False
    jst = jst.replace(alive=jnp.asarray(alive))
    pst = _to_port_state(jst, follow_runs["key"])

    def system(port):
        return SimpleNamespace(
            world_map=port_map(ref.world_map) if port
            else copy.deepcopy(ref.world_map),
            kfs=port_keyframes(ref.kfs) if port else list(
                copy.copy(kf) for kf in ref.kfs),
            frame_ids=list(ref.frame_ids), tracking_lost_count=0,
            last_kf_frame_no=ref.last_kf_frame_no,
            device=torch.device("cpu"))

    js, ps = system(False), system(True)
    jh = j_sync(js, jst, follow_runs["jfc"])
    ph = sync_to_host(ps, pst, follow_runs["fc"])
    jm, pm = js.world_map, ps.world_map
    evicted = {int(pid[r]) for r in rows}
    assert evicted <= set(jm.archived) and list(pm.archived) == \
        list(jm.archived)
    for p, (pos, obs, created) in jm.archived.items():
        assert np.abs(pm.archived[p][0] - pos).max() <= 1e-6
        assert pm.archived[p][1:] == (obs, created)
    assert pm.point_ids() == jm.point_ids()
    assert np.abs(pm.get_point_array() - jm.get_point_array()).max() <= 1e-6
    assert ps.frame_ids == js.frame_ids
    np.testing.assert_allclose(np.stack(pm.poses), np.stack(jm.poses),
                               atol=1e-6)
    assert [k.frame_idx for k in ps.kfs] == [k.frame_idx for k in js.kfs]

    # the same rigid rewrite of both host maps
    W = np.eye(4)
    W[:3, :3] = np.array([[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1.0]])
    W[:3, 3] = [0.3, -0.2, 0.5]
    Winv = np.linalg.inv(W)
    for m, kfs in ((jm, js.kfs), (pm, ps.kfs)):
        rows_m = np.fromiter(m._row.values(), np.int64, len(m))
        m._positions[rows_m] = m._positions[rows_m] @ W[:3, :3].T + W[:3, 3]
        m.poses = [T @ Winv for T in m.poses]
        for kf in kfs:
            kf.pose = np.asarray(kf.pose) @ Winv
    j_new = j_apply(jst, js, follow_runs["jfc"], jh)
    p_new = apply_host_correction(pst, ps, follow_runs["fc"], ph)
    for name in ("positions", "kf_pose", "Tcw", "Tcw_prev"):
        np.testing.assert_allclose(getattr(p_new, name).numpy(),
                                   np.asarray(getattr(j_new, name)),
                                   atol=1e-5, err_msg=name)
    assert int(p_new.ba_floor_kf) == int(j_new.ba_floor_kf) == \
        int(pst.kf_count)
    assert not torch.equal(p_new.positions, pst.positions)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", default="0",
                    help="comma-separated RANSAC seeds, one reading each")
    ap.add_argument("--port", action="store_true",
                    help="also the port's reading of the same frames (CPU)")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)        # as in the tests: the rounding is the same
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps({"package": "jax", **jax_corridor_reading(
            a.small, a.frames, seed)}), flush=True)
        if a.port:
            import chip_smoke
            from simpleslam_tpu_torch.models.pipeline import \
                trained_state_dicts
            r = chip_smoke.run_main_path(
                "cpu", small=a.small, n_frames=a.frames, seed=seed,
                weights=trained_state_dicts(on_error="raise"))
            print(json.dumps({"package": "port", "seed": seed, **{
                k: r[k] for k in ("bootstrap_frame", "keyframes", "lost",
                                  "map_points", "ate_m", "ate_first_kf_m")}}),
                flush=True)
