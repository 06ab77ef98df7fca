"""Geometry parity: the port's ops against the JAX package's on the CPU.

Inputs come from numpy with a seed and go through both. RANSAC entry points
draw through a key backed by ``jax.random`` (below), so the port draws the
reference's minimal sets exactly. Tolerances: float32 geometry to ~1e-4
relative; models (H, F, E, SVD-derived) compared up to sign and scale;
inlier masks compared outright (a point within float noise of the
threshold may flip, so at most 0.5% of them may differ).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.ops import ba as jba
from simpleslam_tpu.ops import epipolar as jepi
from simpleslam_tpu.ops import p3p as jp3p
from simpleslam_tpu.ops import pnp as jpnp
from simpleslam_tpu.ops import ransac as jransac
from simpleslam_tpu.ops import se3 as jse3
from simpleslam_tpu.ops import triangulation as jtri
from simpleslam_tpu_torch.ops import ba as tba
from simpleslam_tpu_torch.ops import epipolar as tepi
from simpleslam_tpu_torch.ops import p3p as tp3p
from simpleslam_tpu_torch.ops import pnp as tpnp
from simpleslam_tpu_torch.ops import ransac as transac
from simpleslam_tpu_torch.ops import se3 as tse3
from simpleslam_tpu_torch.ops import triangulation as ttri
from simpleslam_tpu_torch.utils.rng import TorchKey, frame_key

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL = 1e-4
K = np.array([[707.0912, 0, 601.8873], [0, 707.0912, 183.1104], [0, 0, 1]],
             np.float32)


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


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_masks_close(a, b, frac=0.005):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    assert (a != b).sum() <= max(1, int(frac * a.size)), (a != b).sum()


def assert_up_to_scale(a, b, rtol=1e-3):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    if a @ b < 0:
        b = -b
    np.testing.assert_allclose(a, b, atol=rtol)


def _poses(rng, n_poses):
    w = rng.normal(size=(n_poses, 6)).astype(np.float32) * 0.3
    return np.asarray(jse3.se3_exp(jnp.asarray(w)))


# --------------------------------------------------------------------------- se3

def test_se3_roundtrips_match_reference():
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(16, 6)) * 0.5).astype(np.float32)
    xi[0, 3:] = 0.0                       # small-angle branch
    T_j = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    T_t = n(tse3.se3_exp(t(xi)))
    np.testing.assert_allclose(T_t, T_j, atol=RTOL)
    np.testing.assert_allclose(n(tse3.se3_log(t(T_j))),
                               np.asarray(jse3.se3_log(jnp.asarray(T_j))),
                               atol=RTOL)
    np.testing.assert_allclose(n(tse3.T_inverse(t(T_j))),
                               np.asarray(jse3.T_inverse(jnp.asarray(T_j))),
                               atol=RTOL)
    q_j = np.asarray(jse3.rotmat_to_quat(jnp.asarray(T_j[:, :3, :3])))
    q_t = n(tse3.rotmat_to_quat(t(T_j[:, :3, :3])))
    np.testing.assert_allclose(q_t, q_j, atol=RTOL)
    assert (q_t[:, 3] >= 0).all()
    np.testing.assert_allclose(n(tse3.quat_to_rotmat(t(q_j))),
                               np.asarray(jse3.quat_to_rotmat(
                                   jnp.asarray(q_j))), atol=RTOL)
    np.testing.assert_allclose(
        n(tse3.rotation_angle_deg(t(T_j[:, :3, :3]))),
        np.asarray(jse3.rotation_angle_deg(jnp.asarray(T_j[:, :3, :3]))),
        atol=1e-2)
    X = rng.normal(size=(16, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        n(tse3.transform_points(t(T_j), t(X))),
        np.asarray(jse3.transform_points(jnp.asarray(T_j), jnp.asarray(X))),
        atol=RTOL * 10)


def test_key_derivations_match_jax_and_torch_key_is_deterministic():
    base = jax.random.PRNGKey(3)
    jk = frame_key(JaxKey(base), 7, 2)
    want = jax.random.fold_in(jax.random.fold_in(base, 7), 2)
    assert np.array_equal(np.asarray(jk.key), np.asarray(want))
    a = TorchKey(5).fold_in(7).randint((64,), 10, torch.device("cpu"))
    b = TorchKey(5).fold_in(7).randint((64,), 10, torch.device("cpu"))
    c = TorchKey(5).fold_in(8).randint((64,), 10, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 10
    k1, k2 = TorchKey(1).split()
    assert k1.state != k2.state


@pytest.mark.parametrize("n_valid", [0, 5, 300])
def test_sample_minimal_sets_draws_reference_sets(n_valid):
    rng = np.random.default_rng(n_valid)
    valid = np.zeros(512, bool)
    valid[rng.choice(512, n_valid, replace=False)] = True
    key = jax.random.PRNGKey(11)
    idx_j, ok_j = jransac.sample_minimal_sets(key, jnp.asarray(valid), 8, 64)
    idx_t, ok_t = transac.sample_minimal_sets(JaxKey(key), t(valid), 8, 64)
    # with no valid entry the reference returns the out-of-range index M,
    # which its gathers clamp to M - 1; the port clamps it up front
    assert np.array_equal(n(idx_t), np.minimum(np.asarray(idx_j), 511))
    assert np.array_equal(n(ok_t), np.asarray(ok_j))


# ----------------------------------------------------------------- two-view

def _two_view(seed, n_pts=300, planar=False, outliers=0.2, noise=0.5):
    rng = np.random.default_rng(seed)
    if planar:
        X = np.column_stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts),
                             np.full(n_pts, 10.0)])
    else:
        X = np.column_stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts),
                             rng.uniform(6, 25, n_pts)])
    ang = math.radians(3.0)
    R = np.array([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                  [-math.sin(ang), 0, math.cos(ang)]])
    tvec = np.array([-0.6, 0.05, -0.3])
    Kd = K.astype(np.float64)

    def proj(Xc):
        uv = Xc @ Kd.T
        return uv[:, :2] / uv[:, 2:]

    p0 = proj(X) + rng.normal(scale=noise, size=(n_pts, 2))
    p1 = proj(X @ R.T + tvec) + rng.normal(scale=noise, size=(n_pts, 2))
    bad = rng.uniform(size=n_pts) < outliers
    p1[bad] += rng.uniform(-60, 60, size=(bad.sum(), 2))
    valid = np.ones(n_pts, bool)
    valid[-7:] = False
    return p0.astype(np.float32), p1.astype(np.float32), valid


@pytest.mark.parametrize("which", ["homography", "fundamental"])
def test_find_h_and_f_match_reference(which):
    p0, p1, valid = _two_view(1, planar=(which == "homography"))
    key = jax.random.PRNGKey(4)
    fj = getattr(jepi, f"find_{which}")
    ft = getattr(tepi, f"find_{which}")
    Mj, inl_j, ok_j = fj(key, jnp.asarray(p0), jnp.asarray(p1),
                         jnp.asarray(valid), 2.0, n_hyp=128)
    Mt, inl_t, ok_t = ft(JaxKey(key), t(p0), t(p1), t(valid), 2.0, n_hyp=128)
    assert bool(ok_t) == bool(ok_j)
    assert_masks_close(n(inl_t), inl_j)
    assert_up_to_scale(n(Mt), Mj)


def test_find_essential_and_recover_pose_match_reference():
    p0, p1, valid = _two_view(2)
    key = jax.random.PRNGKey(5)
    Ej, inl_j, ok_j = jepi.find_essential(key, jnp.asarray(p0),
                                          jnp.asarray(p1), jnp.asarray(valid),
                                          jnp.asarray(K), 2.0, n_hyp=128)
    Et, inl_t, ok_t = tepi.find_essential(JaxKey(key), t(p0), t(p1),
                                          t(valid), t(K), 2.0, n_hyp=128)
    assert bool(ok_t) == bool(ok_j)
    assert_masks_close(n(inl_t), inl_j)
    assert_up_to_scale(n(Et), Ej)
    Rj, tj, gj, nj = jepi.recover_pose_essential(
        Ej, jnp.asarray(p0), jnp.asarray(p1), inl_j, jnp.asarray(K))
    Rt, tt, gt, nt = tepi.recover_pose_essential(
        t(np.asarray(Ej)), t(p0), t(p1), t(np.asarray(inl_j)), t(K))
    np.testing.assert_allclose(n(Rt), np.asarray(Rj), atol=1e-3)
    np.testing.assert_allclose(n(tt), np.asarray(tj), atol=1e-3)
    assert_masks_close(n(gt), gj)


def test_refine_essential_and_decompose_homography_match_reference():
    p0, p1, valid = _two_view(3, outliers=0.0)
    fx = K[0, 0]
    p0n = (p0 - K[:2, 2]) / fx
    p1n = (p1 - K[:2, 2]) / fx
    w = valid.astype(np.float32)
    E0 = np.asarray(jepi.fit_essential(jnp.asarray(p0n), jnp.asarray(p1n),
                                       jnp.asarray(w)))
    Ej = jepi.refine_essential_sampson(jnp.asarray(E0), jnp.asarray(p0n),
                                       jnp.asarray(p1n), jnp.asarray(w))
    Et = tepi.refine_essential_sampson(t(E0), t(p0n), t(p1n), t(w))
    assert_up_to_scale(n(Et), Ej, rtol=1e-3)

    p0, p1, valid = _two_view(4, planar=True, outliers=0.0, noise=0.0)
    H = np.asarray(jepi.fit_homography(jnp.asarray(p0), jnp.asarray(p1)))
    Rs_j, ts_j, ns_j = jepi.decompose_homography(jnp.asarray(H),
                                                 jnp.asarray(K))
    Rs_t, ts_t, ns_t = tepi.decompose_homography(t(H), t(K))
    # candidates may come in another order or sign convention: every port
    # candidate must be one of the reference's
    for Rt_, tt_ in zip(n(Rs_t), n(ts_t)):
        d = [np.abs(Rt_ - Rj_).max() + min(np.abs(tt_ - tj_).max(),
                                           np.abs(tt_ + tj_).max())
             for Rj_, tj_ in zip(np.asarray(Rs_j), np.asarray(ts_j))]
        assert min(d) < 2e-3, d


def test_triangulation_and_gates_match_reference():
    rng = np.random.default_rng(6)
    T0 = np.eye(4, dtype=np.float32)
    T1 = _poses(rng, 1)[0] * 0 + np.eye(4, dtype=np.float32)
    T1[:3, 3] = [-0.8, 0.0, 0.1]
    X = np.column_stack([rng.uniform(-5, 5, 200), rng.uniform(-2, 2, 200),
                         rng.uniform(0.2, 120, 200)]).astype(np.float32)
    uv0, _, _ = jse3_project(X, T0)
    uv1, _, _ = jse3_project(X, T1)
    uv0 = uv0 + rng.normal(scale=0.5, size=uv0.shape).astype(np.float32)
    P0 = np.asarray(jtri.projection_matrix(jnp.asarray(K), jnp.asarray(T0)))
    P1 = np.asarray(jtri.projection_matrix(jnp.asarray(K), jnp.asarray(T1)))
    Xj = np.asarray(jtri.triangulate_two_view(*map(jnp.asarray,
                                                   (P0, P1, uv0, uv1))))
    Xt = n(ttri.triangulate_two_view(*map(t, (P0, P1, uv0, uv1))))
    np.testing.assert_allclose(Xt, Xj, rtol=1e-3, atol=1e-3)
    kw = dict(min_depth=0.4, max_depth=100.0, min_parallax_deg=2.0,
              max_reproj_px=2.0)
    keep_j, why_j = jtri.two_view_gates(*map(jnp.asarray,
                                             (Xj, K, T0, T1, uv0, uv1)), **kw)
    keep_t, why_t = ttri.two_view_gates(*map(t, (Xj, K, T0, T1, uv0, uv1)),
                                        **kw)
    assert_masks_close(n(keep_t), keep_j)
    for name in why_j:
        assert_masks_close(n(why_t[name]), why_j[name])
    np.testing.assert_allclose(
        n(ttri.parallax_deg_world(t(Xj), t(T0), t(T1))),
        np.asarray(jtri.parallax_deg_world(*map(jnp.asarray, (Xj, T0, T1)))),
        atol=1e-2)


def jse3_project(X, T):
    from simpleslam_tpu.ops.projection import project_points
    uv, z, f = project_points(jnp.asarray(X), jnp.asarray(T), jnp.asarray(K))
    return np.asarray(uv), np.asarray(z), np.asarray(f)


# ---------------------------------------------------------------- P3P / PnP

def _pnp_scene(seed, M=256, outliers=0.2):
    rng = np.random.default_rng(seed)
    X = np.column_stack([rng.uniform(-6, 6, M), rng.uniform(-2, 2, M),
                         rng.uniform(5, 30, M)]).astype(np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.2, -0.05, 0.4, 0.01, 0.03, -0.02], np.float32))))
    uv, _, _ = jse3_project(X, T)
    uv = uv + rng.normal(scale=0.4, size=uv.shape).astype(np.float32)
    bad = rng.uniform(size=M) < outliers
    uv[bad] += rng.uniform(-50, 50, size=(bad.sum(), 2)).astype(np.float32)
    valid = np.ones(M, bool)
    valid[-5:] = False
    return X, uv.astype(np.float32), valid, T


def test_p3p_matches_reference():
    X, uv, _valid, _T = _pnp_scene(7, M=3, outliers=0.0)
    rays = np.column_stack([(uv - K[:2, 2]) / K[0, 0], np.ones(3)])
    rays = (rays / np.linalg.norm(rays, axis=1, keepdims=True)).astype(
        np.float32)
    Pj, vj = jp3p.p3p_grunert(jnp.asarray(X), jnp.asarray(rays))
    Pt, vt = tp3p.p3p_grunert(t(X), t(rays))
    assert np.array_equal(n(vt), np.asarray(vj))
    np.testing.assert_allclose(n(Pt)[n(vt)], np.asarray(Pj)[np.asarray(vj)],
                               atol=2e-3)


def test_solve_pnp_ransac_matches_reference():
    X, uv, valid, _T = _pnp_scene(8)
    key = jax.random.PRNGKey(9)
    T_init = np.eye(4, dtype=np.float32)
    Tj, inl_j, nj, okj = jpnp.solve_pnp_ransac(
        key, *map(jnp.asarray, (X, uv, valid, K)), 2.0,
        Tcw_init=jnp.asarray(T_init), n_hyp=64)
    Tt, inl_t, nt, okt = tpnp.solve_pnp_ransac(
        JaxKey(key), *map(t, (X, uv, valid, K)), 2.0, Tcw_init=t(T_init),
        n_hyp=64)
    assert bool(okt) == bool(okj)
    assert abs(int(nt) - int(nj)) <= 1
    assert_masks_close(n(inl_t), inl_j)
    np.testing.assert_allclose(n(Tt), np.asarray(Tj), atol=1e-3)
    np.testing.assert_allclose(
        n(tpnp.predict_pose_const_vel(t(Tj), t(np.asarray(Tj)))),
        np.asarray(jpnp.predict_pose_const_vel(Tj, Tj)), atol=1e-4)
    uvn = ((uv[:64] - K[:2, 2]) / K[0, 0]).astype(np.float32)
    np.testing.assert_allclose(n(tpnp.dlt_pose(t(X[:64]), t(uvn),
                                               t(~(np.arange(64) % 5 == 0),
                                                 torch.float32))),
                               np.asarray(jpnp.dlt_pose(
                                   jnp.asarray(X[:64]), jnp.asarray(uvn),
                                   jnp.asarray(~(np.arange(64) % 5 == 0),
                                               jnp.float32))), atol=5e-3)


def test_reproject_and_match_2d3d_matches_reference():
    rng = np.random.default_rng(10)
    C, N, R, D = 512, 384, 6, 32
    X = np.column_stack([rng.uniform(-8, 8, C), rng.uniform(-2, 2, C),
                         rng.uniform(4, 40, C)]).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    uv, _, _ = jse3_project(X, T)
    desc_l = rng.normal(size=(C, D)).astype(np.float32)
    desc_l /= np.linalg.norm(desc_l, axis=1, keepdims=True)
    kp_from = rng.choice(C, N, replace=False)
    kpts = (uv[kp_from] + rng.normal(scale=2.0, size=(N, 2))).astype(
        np.float32)
    desc_k = desc_l[kp_from] + 0.05 * rng.normal(size=(N, D))
    desc_k = (desc_k / np.linalg.norm(desc_k, axis=1, keepdims=True)).astype(
        np.float32)
    ring = np.repeat(desc_l[:, None], R, 1) + 0.05 * rng.normal(
        size=(C, R, D))
    ring = ring.astype(np.float32)
    n_desc = rng.integers(0, 9, size=C).astype(np.int32)
    alive = rng.uniform(size=C) < 0.95
    kp_valid = np.ones(N, bool)
    kp_valid[-10:] = False
    args = (X, alive, ring, n_desc, kpts, desc_k, kp_valid, K, T)
    kw = dict(img_w=1232, img_h=376, radius_px=10.0, max_l2=0.8)
    aj = jpnp.reproject_and_match_2d3d(*map(jnp.asarray, args), **kw,
                                       chunk=256)
    at = tpnp.reproject_and_match_2d3d(*map(t, args), **kw, chunk=128)
    vj, vt = np.asarray(aj.valid), n(at.valid)
    assert vj.sum() > 100
    assert_masks_close(vt, vj)
    both = vj & vt
    assert (np.asarray(aj.kp_idx)[both] == n(at.kp_idx)[both]).mean() > 0.99


# ----------------------------------------------------------------------- BA

def _ba_problem(seed, P=5, L=64, noise=True):
    rng = np.random.default_rng(seed)
    pts = np.column_stack([rng.uniform(-1, 1, L), rng.uniform(-0.7, 0.7, L),
                           rng.uniform(4, 8, L)]).astype(np.float32)
    poses = []
    for i in range(P):
        xi = np.array([-0.1 * i, 0, 0, 0, math.radians(2.0 * i), 0],
                      np.float32)
        poses.append(np.asarray(jse3.se3_exp(jnp.asarray(xi))))
    poses = np.stack(poses)
    cam, pt, uvs = [], [], []
    for c in range(P):
        uv, _, _ = jse3_project(pts, poses[c])
        for l in range(L):
            cam.append(c)
            pt.append(l)
            uvs.append(uv[l] + rng.normal(scale=0.3, size=2))
    E = 512
    e = len(cam)
    cam_idx = np.zeros(E, np.int32)
    pt_idx = np.zeros(E, np.int32)
    uv = np.zeros((E, 2), np.float32)
    ev = np.zeros(E, bool)
    cam_idx[:e], pt_idx[:e], uv[:e], ev[:e] = cam, pt, uvs, True
    noisy = poses.copy()
    noisy[1:, :3, 3] += rng.normal(scale=0.01, size=(P - 1, 3))
    pts_n = pts + rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
    cam_free = np.ones(P, bool)
    cam_free[0] = False
    pt_free = np.ones(L, bool)
    pt_free[-4:] = False
    return (noisy.astype(np.float32), pts_n, cam_idx, pt_idx, uv, ev,
            cam_free, pt_free)


@pytest.mark.parametrize("seed", [0, 1])
def test_ba_solve_matches_reference(seed):
    arrs = _ba_problem(seed)
    Kb = K
    pj = jba.BAProblem(*map(jnp.asarray, arrs))
    Pj, Xj, c0j, c1j, _ = jba.ba_solve(pj, jnp.asarray(Kb), max_iters=12)
    cast = [torch.float32, torch.float32, torch.int64, torch.int64,
            torch.float32, torch.bool, torch.bool, torch.bool]
    pt_ = tba.BAProblem(*[t(a, d) for a, d in zip(arrs, cast)])
    Pt, Xt, c0t, c1t, _ = tba.ba_solve(pt_, t(Kb), max_iters=12)
    np.testing.assert_allclose(float(c0t), float(c0j), rtol=1e-4)
    assert float(c1t) < 0.1 * float(c0t)
    np.testing.assert_allclose(float(c1t), float(c1j), rtol=1e-3,
                               atol=1e-3 * float(c0j))
    np.testing.assert_allclose(n(Pt), np.asarray(Pj), atol=1e-4)
    np.testing.assert_allclose(n(Xt), np.asarray(Xj), atol=1e-3)


def test_pose_only_refine_matches_reference():
    arrs = _ba_problem(2, P=2, L=200)
    Kb = K
    poses, pts, cam_idx, pt_idx, uv, ev = arrs[:6]
    sel = ev & (cam_idx == 1)
    P3 = pts[pt_idx[sel]]
    UV = uv[sel]
    V = np.ones(len(P3), bool)
    Tj, c0j, c1j = jba.pose_only_refine(*map(jnp.asarray,
                                             (poses[1], P3, UV, V, Kb)))
    Tt, c0t, c1t = tba.pose_only_refine(*map(t, (poses[1], P3, UV, V, Kb)))
    np.testing.assert_allclose(n(Tt), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(float(c1t), float(c1j), rtol=1e-3)
