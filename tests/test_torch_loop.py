"""Loop closure and global BA of the port against the JAX package, on the
CPU: the Sim(3) ops, the Sim(3) RANSAC with the reference's draws, the
pose-graph solve, global BA, the landmark archive, ``LoopCloser`` on the
reference's constructed loop world (``tests/test_loop.py``'s
``loop_world``, built by ``chip_smoke.loop_world``), its confirmation
gate, the fused loop's host-assisted rescue and the boxes scene. The
sync's archive and ``apply_host_correction`` are held in
``tests/test_torch_fused.py`` (they reuse its lockstep state), a fused run
with periodic syncs in ``tests/test_torch_loop_fused.py``.

RANSAC draws are injected (``JaxKey``), so both packages sample the same
minimal sets. Tolerances are stated per test.
"""
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.core.keyframe import Keyframe as JKeyframe
from simpleslam_tpu.core.map import Map as JMap
from simpleslam_tpu.core.types import Features as JFeatures
from simpleslam_tpu.ops import pgo as jpgo
from simpleslam_tpu.ops import sim3 as jsim3
from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core.keyframe import Keyframe
from simpleslam_tpu_torch.core.loop import LoopCloser, _s_comp, _s_from_se3, \
    _s_inv
from simpleslam_tpu_torch.core.map import Map
from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.ops import pgo, sim3

from test_torch_slam import JaxKey

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the smoke's constructed world)

SIM3_TOL = 1e-5          # float32 group ops, absolute
RANSAC_S_TOL = 1e-4      # the refitted Sim3 from the same draws
PGO_COST_RTOL = 1e-3
PGO_NODE_TOL = 1e-3
GBA_POSE_TOL = 1e-4      # tests/test_torch_geometry.py's BA tolerances
GBA_POINT_TOL = 1e-3
GBA_COST_RTOL = 1e-3
LOOP_POSE_TOL = 1e-3     # metres: rewritten poses and landmarks
LOOP_SCALE_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x, np.float64)


def _sim3_gap(a, b) -> float:
    return max(float(np.abs(_np(x) - _np(y)).max()) for x, y in zip(a, b))


def _port_sim3(S):
    return sim3.Sim3(*(torch.as_tensor(np.array(x, np.float32)) for x in S))


# --------------------------------------------------------------------------- #
# converters: the reference's keyframes and map as the port's
# --------------------------------------------------------------------------- #

def port_features(f) -> Features:
    return Features(*(torch.as_tensor(np.array(getattr(f, k)))
                      for k in ("kpts", "desc", "scores", "valid")))


def port_keyframes(kfs):
    return [Keyframe(idx=k.idx, frame_idx=k.frame_idx, path="",
                     feats=port_features(k.feats),
                     pose=np.array(k.pose, np.float64)) for k in kfs]


def port_map(jm) -> Map:
    """The reference's map as the port's: the same pids in the same order,
    observations, archive, trajectory and version."""
    m = Map()
    for pid in jm.points:
        mp = jm.points[pid]
        m.upsert_point(pid, np.array(mp.position), colour=np.array(mp.colour),
                       keyframe_idx=mp.keyframe_idx)
        for (k, kp, d) in mp.observations:
            m.points[pid].add_observation(k, kp, d)
    m._next_pid = jm._next_pid
    m.archived = {p: (np.array(pos), list(obs), c)
                  for p, (pos, obs, c) in jm.archived.items()}
    m.archive_cap = jm.archive_cap
    m.poses = [np.array(T) for T in jm.poses]
    m.keyframe_indices = list(jm.keyframe_indices)
    m.version = jm.version
    return m


def reference_objects(w: dict):
    """``chip_smoke.loop_world``'s arrays as the reference's keyframes and
    map (the same construction as ``chip_smoke.loop_world_objects``)."""
    N = chip_smoke.LOOP_N_KF
    kfs, wm = [], JMap()
    for k in range(N):
        feats = JFeatures(kpts=jnp.asarray(w["kpts"][k]),
                          desc=jnp.asarray(w["desc"][k]),
                          scores=jnp.ones(chip_smoke.LOOP_N_PAD, jnp.float32),
                          valid=jnp.asarray(w["valid"][k]))
        kfs.append(JKeyframe(idx=k, frame_idx=k, path="", feats=feats,
                             pose=w["poses"][k].copy(), thumb=b""))
        wm.add_pose(w["poses"][k].copy(), is_keyframe=True)
    pids = []
    for X, kf in ((w["X_gt"], 0), (w["X_drift"], N - 1)):
        ids = wm.add_points(X, keyframe_idx=kf)
        for kp_i, pid in enumerate(ids):
            wm.points[pid].add_observation(kf, kp_i, w["lm_desc"][kp_i])
        pids.append(np.asarray(ids))
    return kfs, wm, pids[0], pids[1]


def _reference_matcher():
    from simpleslam_tpu.core.frontend import Matcher
    from simpleslam_tpu.ops.matching import bf_match
    return Matcher(name="l2", fn=lambda f0, f1: bf_match(f0, f1))


def _reference_cfg(**kw):
    from simpleslam_tpu.config import SLAMConfig as JConfig
    cfg = JConfig()
    cfg.loop_closure = True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _port_cfg(**kw):
    cfg = SLAMConfig(loop_closure=True)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


# --------------------------------------------------------------------------- #
# ops/sim3.py
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("theta_mag,sigma_mag", [
    (1e-9, 1e-9), (1e-9, 0.5), (1.2, 1e-9), (1.2, 0.5), (3.0, 1.0),
    (1e-5, 1e-5), (1e-5, 0.7), (0.9, 1e-5),
])
def test_sim3_ops_match_reference(theta_mag, sigma_mag):
    """exp, log, compose, inverse, act, the SE(3) and matrix forms,
    identity and the weighted Umeyama fit on
    ``tests/test_sim3.py``'s corner cases (the small-angle and small-sigma
    branches of calcW): SIM3_TOL absolute in float32."""
    rng = np.random.default_rng(1)
    phi = rng.normal(size=3)
    phi = phi / np.linalg.norm(phi) * theta_mag
    xi = np.concatenate([rng.normal(size=3), phi, [sigma_mag]]).astype(
        np.float32)
    xi_b = (rng.normal(size=7) * 0.7).astype(np.float32)
    X = rng.normal(size=(10, 3)).astype(np.float32)
    A_j, B_j = jsim3.exp(jnp.asarray(xi)), jsim3.exp(jnp.asarray(xi_b))
    A, B = sim3.exp(torch.as_tensor(xi)), sim3.exp(torch.as_tensor(xi_b))
    assert _sim3_gap(A, A_j) <= SIM3_TOL
    np.testing.assert_allclose(sim3.log(A).numpy(), np.asarray(
        jsim3.log(A_j)), atol=SIM3_TOL)
    np.testing.assert_allclose(sim3.log(A).numpy(), xi, atol=SIM3_TOL)
    assert _sim3_gap(sim3.compose(A, B), jsim3.compose(A_j, B_j)) <= SIM3_TOL
    np.testing.assert_allclose(sim3.to_matrix(A).numpy(),
                               np.asarray(jsim3.to_matrix(A_j)), atol=SIM3_TOL)
    T = sim3.to_se3(A)
    np.testing.assert_allclose(T.numpy(), np.asarray(jsim3.to_se3(A_j)),
                               atol=SIM3_TOL)
    assert _sim3_gap(sim3.from_se3(T), jsim3.from_se3(jnp.asarray(
        T.numpy()))) <= SIM3_TOL
    assert _sim3_gap(sim3.identity((2,)), jsim3.identity((2,))) == 0.0
    assert _sim3_gap(sim3.inverse(A), jsim3.inverse(A_j)) <= SIM3_TOL
    np.testing.assert_allclose(
        sim3.act(A, torch.as_tensor(X)).numpy(),
        np.asarray(jsim3.act(A_j, jnp.asarray(X))), atol=SIM3_TOL)
    Y = np.asarray(jsim3.act(A_j, jnp.asarray(X))) + rng.normal(
        scale=0.01, size=X.shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, 10).astype(np.float32)
    got = sim3.umeyama(torch.as_tensor(X), torch.as_tensor(Y),
                       torch.as_tensor(w))
    want = jsim3.umeyama(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w))
    assert _sim3_gap(got, want) <= SIM3_TOL


@pytest.mark.parametrize("thresh_src", [0.1, 0.05])
def test_sim3_ransac_matches_reference_draws(thresh_src):
    """With the reference's draws, the same inlier set and count, and the
    refitted Sim3 within RANSAC_S_TOL; outliers and padding included."""
    rng = np.random.default_rng(4)
    X = (rng.normal(size=(128, 3)) * 3).astype(np.float32)
    S_true = jsim3.exp(jnp.asarray([0.3, 0.1, -0.2, 0.1, 0.2, 0.05, 0.2],
                                   jnp.float32))
    Y = np.asarray(jsim3.act(S_true, jnp.asarray(X))) + rng.normal(
        scale=0.01, size=X.shape).astype(np.float32)
    Y[:25] += rng.normal(size=(25, 3)).astype(np.float32) * 2
    valid = np.arange(128) < 100
    key = jax.random.PRNGKey(3)
    S_j, inl_j, n_j, ok_j = jsim3.sim3_ransac_3d3d(
        key, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(valid), 0.1,
        thresh_src)
    S, inl, n, ok = sim3.sim3_ransac_3d3d(
        JaxKey(key), torch.as_tensor(X), torch.as_tensor(Y),
        torch.as_tensor(valid), 0.1, thresh_src)
    assert bool(ok) == bool(ok_j) and bool(ok)
    assert int(n) == int(n_j) >= 60
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    assert _sim3_gap(S, S_j) <= RANSAC_S_TOL


# --------------------------------------------------------------------------- #
# ops/pgo.py
# --------------------------------------------------------------------------- #

def test_pgo_solve_matches_reference():
    """``tests/test_pgo.py``'s drifted circle with one loop edge: the
    initial and final robust costs within PGO_COST_RTOL relative, the nodes
    within PGO_NODE_TOL, the loop closed; and ``sequential_edges`` of the
    initial nodes within SIM3_TOL."""
    from test_pgo import _drifted_problem
    prob, _T_gt, _n0 = _drifted_problem()
    ref = jpgo.pgo_solve(prob, huber=10.0, max_iters=30)
    port_prob = pgo.PGOProblem(
        nodes=_port_sim3(prob.nodes),
        edge_i=torch.as_tensor(np.array(prob.edge_i)).long(),
        edge_j=torch.as_tensor(np.array(prob.edge_j)).long(),
        meas=_port_sim3(prob.meas),
        e_valid=torch.as_tensor(np.array(prob.e_valid)),
        e_weight=torch.as_tensor(np.array(prob.e_weight)),
        node_free=torch.as_tensor(np.array(prob.node_free)))
    nodes, c0, c1, n_good = pgo.pgo_solve(port_prob, huber=10.0,
                                          max_iters=30)
    for got, want in ((c0, ref[1]), (c1, ref[2])):
        assert abs(float(got) - float(want)) <= PGO_COST_RTOL * float(want)
    assert float(c1) < 0.05 * float(c0) and n_good >= 3
    assert _sim3_gap(nodes, ref[0]) <= PGO_NODE_TOL
    _i, _j, meas = pgo.sequential_edges(port_prob.nodes)
    assert _sim3_gap(meas, jpgo.sequential_edges(prob.nodes)[2]) <= SIM3_TOL


# --------------------------------------------------------------------------- #
# core/ba.py::global_bundle_adjustment
# --------------------------------------------------------------------------- #

def _ba_world():
    """Five keyframes sideways along x, 150 points at 5-15 m each seen by
    three to five keyframes (0.5 px noise), poses and points perturbed:
    (K, T_true, keyframe poses, keyframe pixels, points, observations)."""
    rng = np.random.default_rng(0)
    K = np.array([[400.0, 0, 200], [0, 400.0, 150], [0, 0, 1]])
    n_kf, n_pts = 5, 150
    T = np.tile(np.eye(4), (n_kf, 1, 1))
    T[:, 0, 3] = -0.4 * np.arange(n_kf)
    T[:, 2, 3] = 0.2 * np.arange(n_kf)
    X = np.column_stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts),
                         rng.uniform(5, 15, n_pts)])
    uv = np.zeros((n_kf, 256, 2), np.float32)
    obs = []
    for p in range(n_pts):
        for k in sorted(rng.choice(n_kf, rng.integers(3, 6), replace=False)):
            c = T[k, :3, :3] @ X[p] + T[k, :3, 3]
            uv[k, p] = c[:2] / c[2] * 400 + [200, 150] + rng.normal(
                scale=0.5, size=2)
            obs.append((p, int(k)))
    T0 = T.copy()
    T0[1:, :3, 3] += rng.normal(scale=0.02, size=(n_kf - 1, 3))
    X0 = X + rng.normal(scale=0.05, size=X.shape)
    return K, T0, uv, X0, obs


def _ba_cost(K, poses, X, uv, obs, huber=2.0) -> float:
    """Huber reprojection cost over the observations."""
    total = 0.0
    for p, k in obs:
        c = poses[k][:3, :3] @ X[p] + poses[k][:3, 3]
        r = np.linalg.norm(c[:2] / c[2] * K[0, 0] + K[:2, 2] - uv[k, p])
        total += r * r if r <= huber else 2 * huber * r - huber * huber
    return total


def test_global_bundle_adjustment_matches_reference():
    """Every keyframe but the first free: poses within GBA_POSE_TOL,
    points within GBA_POINT_TOL, the final cost within GBA_COST_RTOL
    relative, keyframe 0 unmoved, the trajectory written back."""
    from simpleslam_tpu.core.ba import global_bundle_adjustment as j_gba
    from simpleslam_tpu_torch.core.ba import global_bundle_adjustment
    K, T0, uv, X0, obs = _ba_world()
    desc = np.eye(8, dtype=np.float32)[0]
    worlds = []
    for make_map, make_feats, make_kf in (
            (JMap, lambda u: JFeatures(jnp.asarray(u), jnp.zeros((256, 8)),
                                       jnp.ones(256), jnp.ones(256, bool)),
             lambda k, f: JKeyframe(k, k, "", f, T0[k].copy(), b"")),
            (Map, lambda u: Features(torch.as_tensor(u),
                                     torch.zeros((256, 8)), torch.ones(256),
                                     torch.ones(256, dtype=torch.bool)),
             lambda k, f: Keyframe(k, k, "", f, T0[k].copy()))):
        wm = make_map()
        kfs = [make_kf(k, make_feats(uv[k])) for k in range(len(T0))]
        for k in range(len(T0)):
            wm.add_pose(T0[k].copy(), is_keyframe=True)
        ids = wm.add_points(X0, keyframe_idx=0)
        for p, k in obs:
            wm.points[ids[p]].add_observation(k, p, desc)
        worlds.append((wm, kfs))
    (jm, jk), (pm, pk) = worlds
    assert j_gba(jm, K, jk, max_iters=10)
    assert global_bundle_adjustment(pm, K, pk, max_iters=10)
    jposes = np.stack([kf.pose for kf in jk])
    pposes = np.stack([kf.pose for kf in pk])
    assert np.abs(pposes - jposes).max() <= GBA_POSE_TOL
    np.testing.assert_array_equal(pposes[0], T0[0])
    assert np.abs(pm.get_point_array() - jm.get_point_array()).max() \
        <= GBA_POINT_TOL
    np.testing.assert_array_equal(np.stack(pm.poses), pposes)
    c_ref = _ba_cost(K, jposes, jm.get_point_array(), uv, obs)
    c_port = _ba_cost(K, pposes, pm.get_point_array(), uv, obs)
    assert abs(c_port - c_ref) <= GBA_COST_RTOL * c_ref
    assert c_ref < 0.5 * _ba_cost(K, T0, X0, uv, obs)


# --------------------------------------------------------------------------- #
# core/map.py: the archive
# --------------------------------------------------------------------------- #

def test_archive_point_matches_reference():
    """``archive_point`` at ``archive_cap`` 10 (the oldest 10%, at least
    one, by creation keyframe, go past the cap): the same archive, live
    set and version bumps as the reference's; descriptors dropped."""
    pts = np.random.default_rng(2).normal(size=(30, 3))
    maps = [JMap(), Map()]
    for m in maps:
        m.archive_cap = 10
        ids = []
        for i in range(30):
            ids += m.add_points(pts[i:i + 1], keyframe_idx=int(i * 7 % 11))
        for i, pid in enumerate(ids):
            for k in range(i % 3):
                m.points[pid].add_observation(k, i, np.ones(4, np.float32))
        for pid in ids[::2] + [999] + ids[1:12:2]:
            m.archive_point(pid)
    ref, port = maps
    assert list(port.archived) == list(ref.archived)
    for pid, (pos, obs, created) in ref.archived.items():
        p_pos, p_obs, p_created = port.archived[pid]
        np.testing.assert_array_equal(p_pos, pos)
        assert p_obs == obs and p_created == created
    assert port.point_ids() == ref.point_ids()
    assert port.version == ref.version and len(port.archived) <= 10


# --------------------------------------------------------------------------- #
# core/loop.py: LoopCloser on the constructed loop world
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def loop_runs():
    """The reference's and the port's ``on_new_keyframe`` on the loop world
    (seed 7) and on its variant with the old region archived (seed 13),
    each with PRNGKey(3)'s draws."""
    from simpleslam_tpu.core.loop import LoopCloser as JLoopCloser
    out = {}
    for archived in (False, True):
        w = chip_smoke.loop_world(13 if archived else 7)
        jk, jm, j_old, _ = reference_objects(w)
        pk, pm, p_old, _ = chip_smoke.loop_world_objects(w, "cpu")
        if archived:
            for pid in j_old:
                jm.archive_point(pid)
            for pid in p_old:
                pm.archive_point(pid)
        key = jax.random.PRNGKey(3)
        ref = JLoopCloser(_reference_cfg(), chip_smoke.LOOP_K,
                          _reference_matcher()).on_new_keyframe(
            jk, jm, chip_smoke.LOOP_HW, key)
        got = LoopCloser(_port_cfg(), chip_smoke.LOOP_K,
                         chip_smoke.l2_matcher()).on_new_keyframe(
            pk, pm, chip_smoke.LOOP_HW, JaxKey(key))
        out[archived] = dict(ref=ref, got=got, jk=jk, jm=jm, pk=pk, pm=pm,
                             w=w, old=p_old)
    return out


@pytest.mark.parametrize("archived", [False, True])
def test_loop_closer_matches_reference(loop_runs, archived):
    """The same closure (keyframe 19 onto 0), ``n_inliers`` within 1, the
    scale within LOOP_SCALE_RTOL, the PGO costs within PGO_COST_RTOL; the
    rewritten keyframe poses, trajectory, live and archived landmarks
    within LOOP_POSE_TOL; and the reference's own assertions."""
    r = loop_runs[archived]
    ref, got = r["ref"], r["got"]
    assert ref is not None and got is not None
    assert (got.cur_kf, got.cand_kf) == (ref.cur_kf, ref.cand_kf) \
        == (chip_smoke.LOOP_N_KF - 1, 0)
    assert abs(got.n_inliers - ref.n_inliers) <= 1
    assert abs(got.scale - ref.scale) <= LOOP_SCALE_RTOL * ref.scale
    for a, b in ((got.cost_before, ref.cost_before),
                 (got.cost_after, ref.cost_after)):
        assert abs(a - b) <= PGO_COST_RTOL * b + 1e-6
    for kp, kj in zip(r["pk"], r["jk"]):
        assert np.abs(kp.pose - kj.pose).max() <= LOOP_POSE_TOL
    assert max(np.abs(a - b).max() for a, b in zip(r["pm"].poses,
                                                    r["jm"].poses)) \
        <= LOOP_POSE_TOL
    assert np.abs(r["pm"].get_point_array()
                  - r["jm"].get_point_array()).max() <= LOOP_POSE_TOL
    assert list(r["pm"].archived) == list(r["jm"].archived)
    for pid, (pos, _o, _c) in r["jm"].archived.items():
        assert np.abs(r["pm"].archived[pid][0] - pos).max() <= LOOP_POSE_TOL
    res = {"closed": True, "cur_kf": got.cur_kf, "cand_kf": got.cand_kf,
           "cost_before": got.cost_before, "cost_after": got.cost_after,
           "dup_median_m": float(np.median(np.linalg.norm(
               r["pm"].get_point_array()[-chip_smoke.LOOP_N_LM:]
               - r["w"]["X_gt"], axis=1))),
           "pinned_max_m": float(np.max(np.linalg.norm(
               (np.stack([r["pm"].archived[p][0] for p in r["old"]])
                if archived else r["pm"].get_point_array()[
                    :chip_smoke.LOOP_N_LM]) - r["w"]["X_gt"], axis=1)))}
    assert chip_smoke.constructed_closure_ok(res), res


# --------------------------------------------------------------------------- #
# the confirmation gate (tests/test_loop.py:378-419, both packages)
# --------------------------------------------------------------------------- #

def _se3(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _roty(deg):
    th = np.radians(deg)
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


class _StubKF:
    def __init__(self, pose, n_valid=1000, n_pad=1024):
        self.pose = np.asarray(pose, np.float64)
        self.feats = SimpleNamespace(valid=np.arange(n_pad) < n_valid)


def _gate_closer(port: bool):
    """A LoopCloser of either package with the map rewrite stubbed out,
    on the reference's gate configuration."""
    if port:
        base, cfg = LoopCloser, _port_cfg(
            loop_confirm=2, loop_confirm_strong=0.15, loop_confirm_window=12,
            loop_min_inlier_frac=0.0)
    else:
        from simpleslam_tpu.core.loop import LoopCloser as base
        cfg = _reference_cfg(loop_confirm=2, loop_confirm_strong=0.15,
                             loop_confirm_window=12, loop_min_inlier_frac=0.0)

    class GateCloser(base):
        def __init__(self):
            super().__init__(cfg, chip_smoke.LOOP_K, None)
            self.close_calls = []

        def close(self, kfs, world_map, cur, cand, S):
            self.close_calls.append((cur, cand))
            return 1.0, 0.1, 0.5

    return GateCloser()


def _gate_verification(port: bool, kfs, cur, cand, corr=None, base_cur=None):
    """A verification S(cur <- cand) whose implied drift correction is
    ``corr`` (default: the true correction E; with ``base_cur``, E
    transported from that keyframe through odometry), as either package's
    ``Sim3``."""
    E = (_roty(5.0), np.array([1.0, 0.0, 0.5]), 1.2)
    if base_cur is not None:
        G = _s_comp(_s_from_se3(kfs[cur].pose),
                    _s_inv(_s_from_se3(kfs[base_cur].pose)))
        corr = _s_comp(G, _s_comp(E, _s_inv(G)))
    Mhat = _s_comp(_s_from_se3(kfs[cur].pose),
                   _s_inv(_s_from_se3(kfs[cand].pose)))
    R, t, s = _s_comp(corr if corr is not None else E, Mhat)
    return (sim3 if port else jsim3).Sim3(R=R, t=t, s=np.float64(s))


# each case: the gate calls (cur, cand, inliers, drift correction or the
# keyframe E is transported from)
_GATE_CASES = {
    "consistent": [(20, 2, 30, {}),
                   (22, 11, 30, {"corr": (_roty(40.0),
                                          np.array([5.0, 0.0, -3.0]), 0.4)}),
                   (23, 5, 30, {"base_cur": 20})],
    "strong": [(20, 2, 300, {})],
    "expires": [(5, 1, 30, {}), (19, 3, 30, {"base_cur": 5})],
}


def _gate_trace(port: bool, case: str) -> list:
    """After each call of ``case``: (closed, close calls, pending keyframes,
    closures' inliers)."""
    kfs = [_StubKF(_se3(_roty(3 * k), [0.1 * k, 0, 2.0 * k]))
           for k in range(30)]
    lc, trace = _gate_closer(port), []
    for cur, cand, n_inl, kw in _GATE_CASES[case]:
        S = _gate_verification(port, kfs, cur, cand, **kw)
        out = lc._gate_and_apply(kfs, None, cur, cand, 0.9, (S, n_inl, 10.0))
        trace.append((out is not None, list(lc.close_calls),
                      [p["cur"] for p in lc._pending],
                      [c.n_inliers for c in lc.closures]))
    return trace


@pytest.mark.parametrize("case", list(_GATE_CASES))
def test_confirmation_gate(case):
    """The reference's three gate cases through both packages' LoopCloser:
    the same decisions after every call. A verification in the ambiguous
    band waits; an inconsistent second one waits too; an
    odometry-consistent one on a later keyframe closes (``consistent``).
    Strong evidence closes at once (``strong``). A pending verification
    older than the window does not confirm (``expires``)."""
    got, ref = _gate_trace(True, case), _gate_trace(False, case)
    assert got == ref
    expected = {
        "consistent": [(False, [], [20], []), (False, [], [20, 22], []),
                       (True, [(23, 5)], [], [30])],
        "strong": [(True, [(20, 2)], [], [300])],
        "expires": [(False, [], [5], []), (False, [], [19], [])],
    }[case]
    assert got == expected


# --------------------------------------------------------------------------- #
# run_slam._host_assist_reloc
# --------------------------------------------------------------------------- #

def _reference_rescue_inputs():
    """``chip_smoke.rescue_inputs``'s lost streak for the reference."""
    from simpleslam_tpu.config import parse_config
    from simpleslam_tpu.core.fused import abstract_state, make_fused_config
    from simpleslam_tpu.core.loop import LoopCloser as JLoopCloser
    from simpleslam_tpu.run_slam import SLAMSystem as JSystem
    host = chip_smoke.rescue_host()
    cfg = parse_config(["--max_features", "128", "--map_capacity",
                        str(len(host["pid"])), "--loop_closure"])
    system = JSystem(cfg, chip_smoke.LOOP_K, img_hw=chip_smoke.LOOP_HW)
    system.matcher = _reference_matcher()
    system.kfs, system.world_map, old, _ = reference_objects(
        chip_smoke.loop_world(7))
    for pid in old:
        system.world_map.archive_point(pid)
    system.loop_closer = JLoopCloser(cfg, chip_smoke.LOOP_K, system.matcher)
    fc = make_fused_config(cfg, chip_smoke.LOOP_HW, chip_smoke.LOOP_N_PAD, 64)
    return cfg, system, abstract_state(fc), fc, host


def test_host_assist_reloc_matches_reference():
    """With the reference's draws: the same relocalised pose (within
    LOOP_POSE_TOL), the archived region re-injected into the same device
    rows with the same ids, positions, descriptors and counters, and the
    same host map afterwards; nothing happens below the streak."""
    from simpleslam_tpu.run_slam import _host_assist_reloc as j_rescue
    from simpleslam_tpu_torch.run_slam import _host_assist_reloc
    jcfg, jsys, jstate, jfc, jhost = _reference_rescue_inputs()
    pcfg, psys, pstate, pfc, phost = chip_smoke.rescue_inputs(
        "cpu", JaxKey(jax.random.PRNGKey(0)))
    ref = j_rescue(jcfg, jsys, jstate, jfc, jhost)
    got = _host_assist_reloc(pcfg, psys, pstate, pfc, phost)
    assert ref is not None and got is not None
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(ref.Tcw),
                               atol=LOOP_POSE_TOL)
    np.testing.assert_array_equal(got.Tcw_prev.numpy(), got.Tcw.numpy())
    for name in ("alive", "pid", "n_desc", "obs_kf", "obs_n", "last_seen",
                 "n_points", "lost_streak"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(ref.positions), atol=1e-6)
    np.testing.assert_allclose(got.desc_ring.numpy(),
                               np.asarray(ref.desc_ring), atol=1e-6)
    assert int(pstate.n_points) == 0        # the input state is unchanged
    assert chip_smoke.rescue_ok({
        "rescued": True, "n_points": int(got.n_points),
        "pose_err": float(np.abs(got.Tcw.numpy() - np.eye(4)).max()),
        "restored": len(psys.world_map) - chip_smoke.LOOP_N_LM,
        "archived_left": len(psys.world_map.archived)})
    assert psys.world_map.point_ids() == jsys.world_map.point_ids()
    assert list(psys.world_map.archived) == list(jsys.world_map.archived)
    for p in jsys.world_map.point_ids():
        assert [o[:2] for o in psys.world_map.points[p].observations] == \
            [o[:2] for o in jsys.world_map.points[p].observations]
    # one lost frame short of the streak (24): no rescue
    for host in (jhost, phost):
        host["log_flags"][10, 0] = 1.0
    assert j_rescue(jcfg, jsys, jstate, jfc, jhost) is None
    assert _host_assist_reloc(pcfg, psys, pstate, pfc, phost) is None


# --------------------------------------------------------------------------- #
# tools/synth.py::BoxScene
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("lap", [False, True])
def test_box_scene_renders_like_reference(lap):
    """``BoxScene.render_with_geometry`` at 90x205 (the default field, and
    the lap's 160-box field around the square path): the grey image within
    1e-4 on [0, 1], hit points and depths within 1e-9 m."""
    import simpleslam_tpu.tools.synth as jsynth
    from simpleslam_tpu_torch.tools import synth
    hw = (90, 205)
    K = jsynth.DEFAULT_K.copy()
    K[0] *= hw[1] / jsynth.DEFAULT_HW[1]
    K[1] *= hw[0] / jsynth.DEFAULT_HW[0]
    T = jsynth.make_square_loop_trajectory(130)
    kw = dict(path=T[:, :3, 3], n_boxes=160) if lap else {}
    ref = jsynth.BoxScene(seed=5, hw=hw, K=K, **kw)
    port = synth.BoxScene(seed=5, hw=hw, K=K, device="cpu", **kw)
    for i in (0, 40, 77):
        img, hit, depth = ref.render_with_geometry(T[i])
        p_img, p_hit, p_depth = port.render_with_geometry(T[i])
        assert np.abs(p_img.numpy() / 255.0 - img / 255.0).max() <= 1e-4
        assert np.abs(p_hit.numpy() - hit).max() <= 1e-9
        fin = np.isfinite(depth)
        np.testing.assert_array_equal(np.isfinite(p_depth.numpy()), fin)
        assert np.abs(p_depth.numpy()[fin] - depth[fin]).max() <= 1e-9
    assert "boxes" in synth.SCENE_FAMILIES


if __name__ == "__main__":
    # The boxes lap of chip_smoke.py's phase 8 (b) on the CPU, one JSON line
    # per run, then the host-against-fused closure statistics of each
    # package and seed. The frames are the JAX package's render, as its own
    # test renders them (``--render port``: the port's, which differs from
    # it in 6 pixels by one grey level over the 130 frames). The port draws
    # its RANSAC samples as the reference does (a JaxKey of ``--seed``), or
    # with ``--port_draws torch`` from a TorchKey on the CPU: the CPU-draw
    # runs of ``tools.fused_vs_host --lap`` on the card. ``--no_closer``
    # adds the runs without ``--loop_closure``; ``--base DIR`` renders the
    # frames into DIR once and reuses them in later calls:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_loop.py \
    #       [--seeds 0,1] [--modes host,fused] [--packages ref,port] \
    #       [--port_draws jax|torch] [--render ref|port] [--no_closer] \
    #       [--base DIR]
    import argparse
    import json
    import logging
    import tempfile
    import time
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--modes", default="host,fused")
    ap.add_argument("--packages", default="ref,port")
    ap.add_argument("--port_draws", choices=("jax", "torch"), default="jax")
    ap.add_argument("--render", choices=("ref", "port"), default="ref")
    ap.add_argument("--no_closer", action="store_true")
    ap.add_argument("--base", default=None)
    a = ap.parse_args()
    logging.disable(logging.INFO)
    from simpleslam_tpu.config import parse_config as jparse
    from simpleslam_tpu.run_slam import run as jrun
    from simpleslam_tpu_torch import run_slam
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.tools.fused_vs_host import (
        LAP_ARGV, LAP_SEQUENCE, closure_records, compare_closures)
    from simpleslam_tpu_torch.utils.rng import TorchKey
    if a.render == "ref":
        from simpleslam_tpu.tools.synth import generate_kitti_sequence
        render = {}
    else:
        from simpleslam_tpu_torch.tools.synth import generate_kitti_sequence
        render = {"device": "cpu"}

    closers = [True, False] if a.no_closer else [True]
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.abspath(a.base) if a.base else os.path.join(tmp,
                                                                   "lap")
        if not os.path.isfile(os.path.join(base, "kitti", "poses",
                                           "05.txt")):
            generate_kitti_sequence(base, **LAP_SEQUENCE, **render)
        os.chdir(tmp)                  # run writes its plot where it runs
        for seed in (int(x) for x in a.seeds.split(",")):
            results = {}
            for pkg in a.packages.split(","):
                for mode in a.modes.split(","):
                    for closer in closers:
                        argv = ["--base_dir", base, "--seed", str(seed)] + [
                            x for x in LAP_ARGV
                            if closer or x != "--loop_closure"] + (
                            ["--fused"] if mode == "fused" else [])
                        t0 = time.time()
                        key = JaxKey(jax.random.PRNGKey(seed)) \
                            if a.port_draws == "jax" else TorchKey(seed)
                        res = jrun(jparse(argv)) if pkg == "ref" else \
                            run_slam.run(parse_config(argv), device="cpu",
                                         key=key)
                        if closer:
                            results[pkg, mode] = res
                        print(json.dumps({
                            "package": pkg, "mode": mode, "seed": seed,
                            "closer": closer, "render": a.render,
                            "draws": "jax" if pkg == "ref" else a.port_draws,
                            "seconds": time.time() - t0,
                            "closures": closure_records(res),
                            "ate_m": res.ate,
                            "lost": res.tracking_lost_count,
                            "posed": len(res.poses_cw),
                            "keyframes": res.n_keyframes},
                            default=float), flush=True)
            for pkg in a.packages.split(","):
                h, f = results.get((pkg, "host")), results.get((pkg, "fused"))
                if h is not None and f is not None and \
                        h.loop_closures == f.loop_closures == 1:
                    print(json.dumps({"package": pkg, "seed": seed,
                                      "host_vs_fused": compare_closures(h, f)},
                                     default=float), flush=True)
