"""Camera calibration of the port (``tools/calibrate.py``) against the JAX
package's on the CPU: ``tests/test_calibrate.py``'s three cases through
both packages on the same seeded corners, the Jacobian of the LM step
against a finite-difference one, and the CLI over chessboard images that
the test renders itself, whose pickle both packages' ``custom`` loaders
read.
"""
import glob
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from simpleslam_tpu.data import load_calibration as j_load_calibration
from simpleslam_tpu.ops.epipolar import fit_homography as j_fit_homography
from simpleslam_tpu.tools import calibrate as jcal
from simpleslam_tpu_torch.data import load_calibration
from simpleslam_tpu_torch.tools import calibrate
from test_calibrate import _render_views

# Both packages refine in float32 from the same corners; their LM paths may
# take different accept/reject decisions late in the loop, so the results
# are compared, not the path. CPU readings: K 2.3e-3 px, D 1.5e-6, rms
# 1e-6 px.
K_TOL = 0.05       # px
D_TOL = 5e-4
RMS_TOL = 1e-3     # px

K_CLEAN = np.array([[600.0, 0, 320], [0, 610.0, 240], [0, 0, 1]])
K_NOISY = np.array([[580.0, 0, 310], [0, 585.0, 250], [0, 0, 1]])
D_NOISY = np.array([-0.25, 0.08, 1e-3, -5e-4, 0.0])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(obj, img_pts, iters):
    ref = jcal.calibrate_camera(obj, img_pts, refine_iters=iters)
    got = calibrate.calibrate_camera(obj, img_pts, refine_iters=iters,
                                     device="cpu")
    assert np.abs(got[0] - ref[0]).max() <= K_TOL
    assert np.abs(got[1] - ref[1]).max() <= D_TOL
    assert abs(got[2] - ref[2]) <= RMS_TOL
    assert got[3].shape == ref[3].shape == (img_pts.shape[0], 4, 4)
    return got


def test_calibrate_no_distortion_matches_reference():
    obj, img_pts = _render_views(K_CLEAN, np.zeros(5), noise=0.0)
    K, D, rms, _ = _both(obj, img_pts, 25)
    assert rms < 0.05
    assert abs(K[0, 0] - 600) < 2.0 and abs(K[1, 1] - 610) < 2.0
    assert abs(K[0, 2] - 320) < 2.0 and abs(K[1, 2] - 240) < 2.0
    assert np.abs(D[:2]).max() < 0.01


def test_calibrate_with_distortion_and_noise_matches_reference():
    obj, img_pts = _render_views(K_NOISY, D_NOISY, n_views=8, noise=0.3,
                                 seed=1)
    K, D, rms, _ = _both(obj, img_pts, 40)
    assert rms < 0.6
    assert abs(K[0, 0] - 580) < 10.0
    assert abs(D[0] - (-0.25)) < 0.03
    assert abs(D[1] - 0.08) < 0.1
    assert D[4] == 0.0                       # fix_k3


def test_zhang_closed_form_matches_reference():
    K_gt = np.array([[500.0, 0, 300], [0, 505.0, 220], [0, 0, 1]])
    obj, img_pts = _render_views(K_gt, np.zeros(5), n_views=5, seed=2)
    Hs_ref = [np.asarray(j_fit_homography(
        jnp.asarray(obj[:, :2], jnp.float32),
        jnp.asarray(img_pts[v], jnp.float32)), np.float64) for v in range(5)]
    Hs = [calibrate.fit_homography(
        torch.as_tensor(obj[:, :2], dtype=torch.float32),
        torch.as_tensor(img_pts[v], dtype=torch.float32)).numpy().astype(
            np.float64) for v in range(5)]
    K0_ref = jcal.zhang_intrinsics(Hs_ref)
    K0 = calibrate.zhang_intrinsics(Hs)
    assert np.abs(K0 - K0_ref).max() <= K_TOL
    assert abs(K0[0, 0] - 500) < 15.0 and abs(K0[0, 2] - 300) < 15.0
    R, t = calibrate.extrinsics_from_h(Hs[0], K0)
    R_ref, t_ref = jcal.extrinsics_from_h(Hs_ref[0], K0_ref)
    assert np.abs(R - R_ref).max() <= 1e-3 and np.abs(t - t_ref).max() <= 1e-3
    assert np.array_equal(calibrate.chessboard_object_points(9, 6, 0.03),
                          jcal.chessboard_object_points(9, 6, 0.03))


def test_lm_jacobian_matches_finite_differences():
    """The LM step's forward-mode Jacobian of ``_reproject_all`` stays
    float32 and agrees with central differences in float64."""
    obj, img_pts = _render_views(K_NOISY, D_NOISY, n_views=3, seed=1)
    rng = np.random.default_rng(0)
    p = np.concatenate([[580.0, 585.0, 310.0, 250.0, -0.2, 0.05, 1e-3, 0.0,
                         0.0], np.tile([0.0, 0.0, 0.6, 0.1, -0.1, 0.05], 3)
                        + rng.normal(0, 0.02, 18)])
    obj_t = torch.as_tensor(obj)

    def f(q):
        return calibrate._reproject_all(q, obj_t.to(q.dtype), 3).reshape(-1)

    J = torch.func.jacfwd(f)(torch.as_tensor(p, dtype=torch.float32))
    assert J.dtype == torch.float32 and J.shape == (3 * 54 * 2, 27)
    p64 = torch.as_tensor(p)
    eps = 1e-6
    cols = [(f(p64 + eps * e) - f(p64 - eps * e)) / (2 * eps)
            for e in torch.eye(27, dtype=torch.float64)]
    J_fd = torch.stack(cols, 1).numpy()
    scale = np.abs(J_fd).max(0)
    assert (np.abs(J.numpy() - J_fd).max(0) <= 1e-3 * scale + 1e-3).all()


# --------------------------------------------------------------------------- #
# the CLI over rendered chessboard images
# --------------------------------------------------------------------------- #

CLI_HW = (480, 640)
CLI_K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
SQUARE = 0.03


def _render_board(R, t, ss=3):
    """A 9x6 (inner corners) board with a white margin on a grey
    background, rendered by inverse mapping: each of ss x ss subpixel rays
    meets the board plane, whose square decides its shade."""
    H, W = CLI_HW
    o = (np.arange(ss) + 0.5) / ss - 0.5
    v, u = np.meshgrid(np.arange(H)[:, None] + o[None, :],
                       np.arange(W)[:, None] + o[None, :], indexing="ij")
    d = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(CLI_K).T
    n = R[:, 2]
    lam = (n @ t) / (d @ n)
    Xb = (lam[..., None] * d - t) @ R          # board coordinates
    i = np.floor(Xb[..., 0] / SQUARE)
    j = np.floor(Xb[..., 1] / SQUARE)
    on_board = (i >= -1) & (i <= 8) & (j >= -1) & (j <= 5)
    margin = (i >= -2) & (i <= 9) & (j >= -2) & (j <= 6)
    shade = np.where(on_board, np.where((i + j) % 2 == 0, 20.0, 235.0),
                     np.where(margin, 235.0, 128.0))
    shade = np.where(lam > 0, shade, 128.0)
    return shade.reshape(H, ss, W, ss).mean((1, 3)).round().astype(np.uint8)


def _board_views(n_views=6, seed=0):
    from simpleslam_tpu_torch.ops import se3
    rng = np.random.default_rng(seed)
    views = []
    for _ in range(n_views):
        R = se3.so3_exp(torch.as_tensor(rng.normal(size=3) * 0.25)).numpy()
        centre = np.array([4 * SQUARE, 2.5 * SQUARE, 0.0])
        t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                      rng.uniform(0.45, 0.6)]) - R @ centre
        views.append(_render_board(R, t))
    return views


def test_calibrate_cli_writes_what_both_loaders_read(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img_dir = tmp_path / "boards"
    img_dir.mkdir()
    for k, img in enumerate(_board_views()):
        cv2.imwrite(str(img_dir / f"{k:02d}.png"), img)
    out = tmp_path / "custom" / "calibration.pkl"
    out.parent.mkdir()
    assert calibrate.main(["--images", str(img_dir / "*.png"), "--pattern",
                           "9", "6", "--square", str(SQUARE), "--out",
                           str(out), "--device", "cpu"]) == 0
    with open(out, "rb") as f:
        K, D, rms = pickle.load(f)
    assert np.abs(K - CLI_K).max() <= 2.0, K
    assert rms < 0.5 and np.abs(D).max() < 0.05
    args = SimpleNamespace(dataset="custom", base_dir=str(tmp_path))
    for loader in (load_calibration, j_load_calibration):
        calib = loader(args)
        assert np.array_equal(calib["K_l"], K)
        assert calib["P_l"].shape == (3, 4)
    assert len(glob.glob(str(img_dir / "*.png"))) == 6
    assert calibrate.main(["--images", str(tmp_path / "none" / "*.png"),
                           "--device", "cpu"]) == 1


def test_calibrate_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj, img_pts = _render_views(K_CLEAN, np.zeros(5), n_views=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate.calibrate_camera(obj, img_pts, refine_iters=1)
