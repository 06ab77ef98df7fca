"""The library surface that no driver path reads, in the port against the
JAX package on the CPU: N-view triangulation (``ops/triangulation.py``:
``triangulate_n_view``, ``multi_view_triangulation``,
``MultiViewTriangulator``), landmark fusion
(``core/map.py::Map.fuse_closeby_duplicate_landmarks`` over
``_pairs_within_radius``) and the PnP host helpers (``ops/pnp.py``),
mirroring ``tests/test_triangulation.py:90-170``, ``tests/test_map.py:
73-117`` and ``tests/test_pnp.py:114-145`` on the same seeded inputs.

Tolerances: float32 geometry within 1e-4 of the scale of the result
(two float32 SVDs, rounded in other orders); where gates decide (``None``
or not, which tracks survive, which landmarks fuse) the decisions are
equal; the fusion, numpy in both packages, is exact; ``refine_pose_pnp``
with the reference's ``PRNGKey(0)`` draws injected: R and t within 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.core import map as jmap
from simpleslam_tpu.ops import pnp as jpnp
from simpleslam_tpu.ops import se3 as jse3
from simpleslam_tpu.ops import triangulation as jtri
from simpleslam_tpu_torch.core import map as tmap
from simpleslam_tpu_torch.ops import pnp as tpnp
from simpleslam_tpu_torch.ops import triangulation as ttri

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


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
        return torch.as_tensor(np.asarray(r), dtype=torch.int64,
                               device=device)


def _pose_wc(tx=0.0, ty=0.0, tz=0.0):
    T = np.eye(4)
    T[:3, 3] = [tx, ty, tz]
    return T


def _project(Kl, T_wc, X):
    pc = (np.linalg.inv(T_wc) @ np.append(X, 1))[:3]
    return (Kl @ pc)[:2] / pc[2]


def _close(a, b, tol=1e-4):
    if a is None or b is None:
        assert a is None and b is None
        return
    assert np.abs(np.asarray(a) - np.asarray(b)).max() \
        <= tol * max(1.0, np.abs(b).max())


def test_triangulate_n_view_matches_reference():
    rng = np.random.default_rng(0)
    Kl = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    T_cw = np.stack([np.linalg.inv(_pose_wc(0.8 * v, 0.3 * v, 0.1 * v))
                     for v in range(4)]).astype(np.float32)
    Ps = Kl @ T_cw[:, :3, :]
    X = np.stack([rng.uniform(-1, 1, 20), rng.uniform(-1, 1, 20),
                  rng.uniform(4, 8, 20)], 1)
    uvs = np.stack([[_project(Kl, np.linalg.inv(T), x) for T in T_cw]
                    for x in X]).astype(np.float32)
    uvs += rng.normal(0, 0.5, uvs.shape).astype(np.float32)
    valid = rng.uniform(size=(20, 4)) < 0.8
    valid[:, :2] = True
    want = jax.vmap(jtri.triangulate_n_view)(
        jnp.asarray(np.broadcast_to(Ps, (20, 4, 3, 4))), jnp.asarray(uvs),
        jnp.asarray(valid))
    got = ttri.triangulate_n_view(
        torch.as_tensor(np.broadcast_to(Ps, (20, 4, 3, 4)).copy()),
        torch.as_tensor(uvs), torch.as_tensor(valid))
    _close(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), X, atol=0.2)
    one = ttri.triangulate_n_view(torch.as_tensor(Ps), torch.as_tensor(uvs[0]))
    _close(one.numpy(), np.asarray(jtri.triangulate_n_view(
        jnp.asarray(Ps), jnp.asarray(uvs[0]))))


def test_multi_view_triangulation_matches_reference():
    """``tests/test_triangulation.py``'s noise-free, gate and noisy cases
    through both packages."""
    Kl = np.array([[500.0, 0, 320], [0, 500.0, 320], [0, 0, 1]])
    poses = [_pose_wc(0, 0, 0), _pose_wc(1, 0, 0), _pose_wc(0, 1, 0)]
    X_gt = np.array([2.0, 1.5, 8.0])
    uvs = [_project(Kl, T, X_gt) for T in poses]
    cases = [
        (poses, np.float32(uvs), dict(min_depth=0.5, max_depth=50.0,
                                      max_rep_err=0.5)),
        (poses[:2], np.float32(uvs[:2]), dict(min_depth=10.0, max_depth=50.0,
                                              max_rep_err=2.0)),
        (poses[:2], np.float32([uvs[0] + 30.0, uvs[1]]),
         dict(min_depth=0.5, max_depth=50.0, max_rep_err=1.0)),
        (poses[:1], np.float32(uvs[:1]), {}),
    ]
    rng = np.random.default_rng(42)
    Kn = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    line = [_pose_wc(t) for t in np.linspace(0, 1, 5)]
    for _ in range(12):
        Xn = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                       rng.uniform(4, 6)])
        cases.append((line, np.float32([_project(Kn, T, Xn)
                                        + rng.normal(0, 0.4, 2)
                                        for T in line]),
                      dict(min_depth=0.1, max_depth=10.0, max_rep_err=2.0)))
    n_ok = 0
    for i, (P, uv, kw) in enumerate(cases):
        Kc = Kl if i < 4 else Kn
        want = jtri.multi_view_triangulation(Kc, P, uv, **kw)
        got = ttri.multi_view_triangulation(Kc, P, uv, device="cpu", **kw)
        _close(got, want)
        n_ok += got is not None
    assert n_ok == 13                       # the three gates fired


@pytest.mark.parametrize("min_views", [2, 3])
def test_multiview_triangulator_matches_reference(min_views):
    Kl = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    rng = np.random.default_rng(7)
    poses = [_pose_wc(t) for t in np.linspace(0, 1, 5)]
    pts = np.stack([rng.uniform(-1, 1, 30), rng.uniform(-1, 1, 30),
                    rng.uniform(4, 6, 30)], 1)
    img = rng.integers(0, 256, (480, 640, 3), np.uint8)
    frames = []
    for f, T in enumerate(poses):
        kps = [_project(Kl, T, X) + rng.normal(0, 0.3, 2) for X in pts]
        kps[5] = kps[4] + 0.01                    # a duplicate landmark
        kps[9] = kps[9] + 40.0 * (f % 2)          # a track failing its gate
        descs = [rng.integers(0, 256, 32, np.uint8) for _ in pts]
        frames.append((f, T, kps, {j: j for j in range(len(pts))}, img,
                       descs))
    kw = dict(min_views=min_views, merge_radius=0.01, max_rep_err=2.0,
              min_depth=0.1, max_depth=10.0)
    ref, port = jtri.MultiViewTriangulator(Kl, **kw), \
        ttri.MultiViewTriangulator(Kl, device="cpu", **kw)
    m_ref, m_port = jmap.Map(), tmap.Map()
    out = []
    for tri, m in ((ref, m_ref), (port, m_port)):
        ids = []
        for k, fr in enumerate(frames):
            tri.add_keyframe(*fr)
            if k in (min_views - 1, 4):          # two rounds of triangulation
                ids += tri.triangulate_ready_tracks(m)
        out.append(ids)
    assert out[0] == out[1] and 20 <= len(out[0]) < 30
    assert m_port.point_ids() == m_ref.point_ids()
    assert 5 not in m_port.points and 4 in m_port.points     # fused
    _close(m_port.get_point_array(), m_ref.get_point_array())
    np.testing.assert_allclose(m_port.get_color_array(),
                               m_ref.get_color_array(), atol=1e-6)
    for pid in m_ref.point_ids():
        a, b = m_port.points[pid].observations, m_ref.points[pid].observations
        assert [(f, kp) for f, kp, _ in a] == [(f, kp) for f, kp, _ in b]


def _fuse_both(pts, radius):
    out = []
    for mod in (jmap, tmap):
        m = mod.Map()
        m.add_points(np.asarray(pts, np.float64))
        m.fuse_closeby_duplicate_landmarks(radius)
        out.append((m.point_ids(), m.get_point_array()))
    (ids_r, p_r), (ids_t, p_t) = out
    assert ids_t == ids_r
    np.testing.assert_array_equal(p_t, p_r)
    return ids_t, p_t


def test_fuse_closeby_duplicate_landmarks_matches_reference():
    ids, p = _fuse_both([[0.0, 0, 0], [0.04, 0, 0], [1.0, 0, 0], [5, 5, 5]],
                        0.05)
    assert ids == [0, 2, 3]
    np.testing.assert_allclose(p[0], [0.02, 0, 0], atol=1e-12)
    ids, _ = _fuse_both([[0.0, 0, 0], [0.04, 0, 0], [0.08, 0, 0]], 0.05)
    assert ids == [0, 2]                          # the greedy chain order
    assert _fuse_both([[0.0, 0, 0]], 0.1)[0] == [0]
    m = tmap.Map()
    m.fuse_closeby_duplicate_landmarks(0.1)
    assert len(m) == 0
    # a map of a few thousand points, clustered so that chains form, with
    # negative cells (the hash's two's complement) on both sides of zero
    rng = np.random.default_rng(3)
    centres = rng.uniform(-20, 20, (1500, 3))
    pts = np.concatenate([centres, centres + rng.normal(0, 0.04, (1500, 3)),
                          rng.uniform(-20, 20, (1000, 3))])
    ids, p = _fuse_both(pts, 0.1)
    assert 2500 < len(ids) < 3900
    # the spatial hash against brute force
    sub = rng.uniform(-1, 1, (300, 3))
    got = tmap._pairs_within_radius(sub, 0.15)
    d = np.linalg.norm(sub[:, None] - sub[None, :], axis=-1)
    ii, jj = np.nonzero(np.triu(d < 0.15, k=1))
    assert got == sorted(zip(ii.tolist(), jj.tolist())) == \
        jmap._pairs_within_radius(sub, 0.15)
    # k_of packs cells as the reference's inner k_of does
    assert tmap.k_of((-1, 2, -3)) == \
        (0x1FFFFF << 42) | (2 << 21) | (0x1FFFFF - 2)


K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])


def _scene(rng, n=80, rot_scale=0.3, noise_px=0.0):
    """``tests/test_pnp.py::_scene`` (no outliers)."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 10, n)], 1)
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * rot_scale
    t = rng.normal(size=3) * 0.5
    T = np.asarray(jse3.rt_to_T(jse3.so3_exp(jnp.asarray(w, jnp.float32)),
                                jnp.asarray(t, jnp.float32)))
    Xc = X @ T[:3, :3].T + T[:3, 3]
    Xc[:, 2] = np.abs(Xc[:, 2]) + 2.0
    X = (Xc - T[:3, 3]) @ T[:3, :3]
    uv = Xc @ K.T
    uv = uv[:, :2] / uv[:, 2:3]
    if noise_px:
        uv = uv + rng.normal(scale=noise_px, size=uv.shape)
    return X, uv, T


def test_refine_pose_pnp_matches_reference_with_its_draws():
    rng = np.random.default_rng(4)
    X, uv, T = _scene(rng, n=40, noise_px=0.5)
    R_ref, t_ref = jpnp.refine_pose_pnp(K, X, uv, ransac_px=2.0)
    R, t = tpnp.refine_pose_pnp(K, X, uv, ransac_px=2.0,
                                key=JaxKey(jax.random.PRNGKey(0)),
                                device="cpu")
    _close(R, R_ref)
    _close(t, t_ref)
    assert np.linalg.norm(t - T[:3, 3]) < 0.15
    R_own, t_own = tpnp.refine_pose_pnp(K, X, uv, device="cpu")
    assert np.linalg.norm(t_own - T[:3, 3]) < 0.15
    assert tpnp.refine_pose_pnp(K, X[:3], uv[:3], device="cpu") == \
        jpnp.refine_pose_pnp(K, X[:3], uv[:3]) == (None, None)


def test_associate_landmarks_and_projection_match_reference():
    T_wc = np.eye(4)
    T_wc[0, 3] = 1.0
    X = np.array([[1.0, 0, 5.0], [1.5, 0, 5.0], [-50.0, 0, -5.0],
                  [1.2, 0.3, 6.0]])
    uv_ref = jpnp.project_points_wc(K, T_wc, X)
    uv = tpnp.project_points_wc(K, T_wc, X, device="cpu")
    _close(uv, uv_ref)
    assert (uv[2] == -1).all()
    kps = [uv_ref[0], uv_ref[1] + 1.0, uv_ref[3] + 7.0]
    for rad in (5.0, 8.0):
        want = jpnp.associate_landmarks(K, T_wc, X, kps, search_rad=rad)
        got = tpnp.associate_landmarks(K, T_wc, X, kps, search_rad=rad,
                                       device="cpu")
        assert got[2] == want[2]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert tpnp.associate_landmarks(K, T_wc, np.zeros((0, 3)), kps,
                                    device="cpu")[2] == []
    assert tpnp.project_points_wc(K, T_wc, np.zeros((0, 3)),
                                  device="cpu").shape == (0, 2)


@pytest.mark.parametrize("binary", [False, True])
def test_reproject_and_match_host_matches_reference(binary):
    from simpleslam_tpu.core.types import Features as JFeatures
    from simpleslam_tpu_torch.core.types import Features
    rng = np.random.default_rng(5)
    C, N, D = 64, 48, 32 if binary else 16
    X = np.stack([rng.uniform(-2, 2, C), rng.uniform(-1.5, 1.5, C),
                  rng.uniform(4, 10, C)], 1)
    uv = X @ K.T
    uv = uv[:, :2] / uv[:, 2:3]
    kpts = (uv[:N] + rng.normal(scale=1.0, size=(N, 2))).astype(np.float32)
    if binary:
        descs = rng.integers(0, 256, (C, D), np.uint8)
    else:
        descs = rng.normal(size=(C, D)).astype(np.float32)
        descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    maps = []
    for mod in (jmap, tmap):
        m = mod.Map(desc_dim=D, desc_dtype=descs.dtype)
        ids = m.add_points(X)
        for pid in ids:
            m.points[pid].add_observation(0, pid, descs[pid])
        maps.append(m)
    want = jpnp.reproject_and_match_2d3d_host(
        maps[0], K, np.eye(4), JFeatures(
            kpts=jnp.asarray(kpts), desc=jnp.asarray(descs[:N]),
            scores=jnp.ones(N), valid=jnp.ones(N, bool)),
        640, 480, radius_px=8.0, max_l2=0.5)
    got = tpnp.reproject_and_match_2d3d_host(
        maps[1], K, np.eye(4), Features(
            kpts=torch.as_tensor(kpts), desc=torch.as_tensor(descs[:N]),
            scores=torch.ones(N), valid=torch.ones(N, dtype=torch.bool)),
        640, 480, radius_px=8.0, max_l2=0.5)
    assert got.mp_ids == want.mp_ids and got.kp_indices == want.kp_indices
    assert len(got.mp_ids) >= N - 4
    np.testing.assert_array_equal(got.pts3d, want.pts3d)
    np.testing.assert_array_equal(got.pts2d, want.pts2d)


def test_draw_reprojection_debug_matches_reference():
    img = np.random.default_rng(0).integers(0, 256, (60, 80), np.uint8)
    meas = np.array([[10.0, 12.0], [40.0, 30.0], [70.0, 50.0]])
    proj = meas + [[2.0, -1.0], [0.0, 3.0], [-4.0, 0.0]]
    mask = np.array([True, False, True])
    for m in (None, mask):
        np.testing.assert_array_equal(
            tpnp.draw_reprojection_debug(img, meas, proj, m),
            jpnp.draw_reprojection_debug(img, meas, proj, m))
