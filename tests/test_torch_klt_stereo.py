"""KLT optical flow and stereo of the port against the JAX package on the
CPU: ``ops/klt.py`` (the pyramid, ``lk_track``, ``fb_track``),
``ops/stereo.py`` (block matching, depth, back-projection) and
``stereo/tracker.py::StereoTracker``, on the JAX package's own test inputs
(``tests/test_klt.py``, ``tests/test_stereo.py``), the same seeded numpy
arrays into both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.ndimage import map_coordinates
from simpleslam_tpu.config import SLAMConfig as JConfig
from simpleslam_tpu.ops import klt as jklt
from simpleslam_tpu.ops import stereo as jstereo
from simpleslam_tpu.stereo import StereoTracker as JStereoTracker
from simpleslam_tpu.tools.synth import (DEFAULT_K, CorridorScene,
                                        make_trajectory)
from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.ops import klt, stereo
from simpleslam_tpu_torch.stereo import StereoTracker
from test_klt import _textured
from test_stereo import _texture
from test_torch_slam import JaxKey

PYRAMID_TOL = 1e-4       # float32 blur sums, levels on [0, 255]
TRACK_TOL = 1e-3         # px, where both packages report the point good
DISP_TOL = 1e-4          # px, where both packages report a valid pixel
VALID_AGREE_MIN = 0.995  # share of pixels whose validity agrees
STEREO_POSE_TOL = 1e-3   # max |T_cw| entry gap, same features and draws


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def flow_pair():
    """``tests/test_klt.py::test_lk_translation``'s images, with 64 points
    spread over the frame (borders included)."""
    rng = np.random.default_rng(0)
    img = _textured(rng)
    yy, xx = np.mgrid[0:120, 0:160].astype(np.float32)
    img1 = map_coordinates(img, [yy - 3.7, xx + 6.3], order=1,
                           mode="nearest").astype(np.float32)
    pts = np.stack([rng.uniform(2, 158, 64), rng.uniform(2, 118, 64)],
                   1).astype(np.float32)
    return img, img1, pts


def test_pyramid_matches_reference(flow_pair):
    img = flow_pair[0]
    ref = jklt.build_pyramid(jnp.asarray(img), 4)
    got = klt.build_pyramid(_t(img), 4)
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for r, g in zip(ref, got):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= PYRAMID_TOL


def _same_tracks(ref, got):
    st_r, st_g = np.asarray(ref[1]), got[1].numpy()
    assert np.array_equal(st_r, st_g)
    both = st_r & st_g
    assert both.sum() >= 20
    gap = np.abs(np.asarray(ref[0])[both] - got[0].numpy()[both]).max()
    assert gap <= TRACK_TOL, gap


@pytest.mark.parametrize("fn", ["lk_track", "fb_track"])
def test_tracking_matches_reference(flow_pair, fn):
    """Status equal, points within TRACK_TOL where both are good: a
    subpixel shift, tests/test_klt.py's occluded pair and its flat
    image."""
    img, img1, pts = flow_pair
    _same_tracks(getattr(jklt, fn)(jnp.asarray(img), jnp.asarray(img1),
                                   jnp.asarray(pts)),
                 getattr(klt, fn)(_t(img), _t(img1), _t(pts)))
    rng = np.random.default_rng(1)
    img = _textured(rng)
    occ = np.roll(img, (0, 5), (0, 1)).astype(np.float32)
    occ[40:80, 60:100] = 0.0
    p = np.array([[30.0, 30.0], [75.0, 60.0]], np.float32)
    ref = getattr(jklt, fn)(jnp.asarray(img), jnp.asarray(occ),
                            jnp.asarray(p))
    got = getattr(klt, fn)(_t(img), _t(occ), _t(p))
    assert np.array_equal(np.asarray(ref[1]), got[1].numpy())
    assert np.abs(np.asarray(ref[0])[0] - got[0].numpy()[0]).max() \
        <= TRACK_TOL
    flat = np.full((64, 64), 100.0, np.float32)
    got = getattr(klt, fn)(_t(flat), _t(flat), _t([[32.0, 32.0]]))
    assert not bool(got[1][0])


def _stereo_pair(seed, H, W, shift):
    left = _texture(np.random.default_rng(seed), H, W)
    right = np.zeros_like(left)
    right[:, :W - shift] = left[:, shift:]
    return left, right


@pytest.mark.parametrize("seed,max_disp,shift", [(0, 32, 12)])
def test_disparity_matches_reference(seed, max_disp, shift):
    """``tests/test_stereo.py``'s 64x160 pair: validity agrees on at least
    VALID_AGREE_MIN of the pixels, disparity within DISP_TOL where both
    are valid."""
    left, right = _stereo_pair(seed, 64, 160, shift)
    rd, rv = jstereo.disparity_block_match(jnp.asarray(left),
                                           jnp.asarray(right),
                                           max_disp=max_disp, block=9)
    gd, gv = stereo.disparity_block_match(_t(left), _t(right),
                                          max_disp=max_disp, block=9)
    rv, gv = np.asarray(rv), gv.numpy()
    assert (rv == gv).mean() >= VALID_AGREE_MIN
    both = rv & gv
    assert both.sum() > 1000
    assert np.abs(np.asarray(rd)[both] - gd.numpy()[both]).max() <= DISP_TOL
    assert np.all(gd.numpy()[~gv] == 0.0)


def test_box_filter_matches_reference():
    x = np.random.default_rng(2).uniform(0, 255, (20, 33)).astype(np.float32)
    ref = np.asarray(jstereo._box_filter(jnp.asarray(x), 9))
    got = stereo._box_filter(_t(x), 9).numpy()
    assert got.shape == ref.shape
    # the running sums along the rows reach ~1e5, where the float32 step is
    # 0.0078, and the two cumsums add in different orders
    assert np.abs(got - ref).max() <= 2e-2


def test_depth_and_backprojection_match_reference():
    rng = np.random.default_rng(4)
    disp = rng.uniform(0, 40, (12, 16)).astype(np.float32)
    disp[0, :4] = 0.0
    valid = rng.random((12, 16)) > 0.2
    K = np.array([[500.0, 0, 8], [0, 490.0, 6], [0, 0, 1]], np.float32)
    kp = rng.uniform(-2, 18, (30, 2)).astype(np.float32)
    z_r = jstereo.depth_from_disparity(jnp.asarray(disp), 500.0, 0.5,
                                       valid=jnp.asarray(valid))
    z_g = stereo.depth_from_disparity(_t(disp), 500.0, 0.5,
                                      valid=torch.as_tensor(valid))
    np.testing.assert_allclose(z_g.numpy(), np.asarray(z_r), rtol=1e-6)
    d_r, ok_r = jstereo.sample_disparity(jnp.asarray(disp),
                                         jnp.asarray(valid), jnp.asarray(kp))
    d_g, ok_g = stereo.sample_disparity(_t(disp), torch.as_tensor(valid),
                                        _t(kp))
    assert np.array_equal(d_g.numpy(), np.asarray(d_r))
    assert np.array_equal(ok_g.numpy(), np.asarray(ok_r))
    X_r = jstereo.keypoints_to_3d(jnp.asarray(kp), d_r, jnp.asarray(K), 0.5)
    X_g = stereo.keypoints_to_3d(_t(kp), d_g, _t(K), 0.5)
    np.testing.assert_allclose(X_g.numpy(), np.asarray(X_r), rtol=1e-5,
                               atol=1e-5)
    X = stereo.keypoints_to_3d(_t([[8.0, 6.0]]), _t([10.0]), _t(K), 0.5)
    np.testing.assert_allclose(X.numpy()[0], [0, 0, 25.0], atol=1e-4)


STEREO_HW = (150, 400)
STEREO_FRAMES = 5
BASELINE = 0.54


@pytest.fixture(scope="module")
def stereo_frames():
    """``tests/test_stereo.py``'s corridor, left and right (+0.54 m)."""
    scene = CorridorScene(seed=2, hw=STEREO_HW)
    T = make_trajectory(STEREO_FRAMES, speed=0.5, yaw_rate_deg=0.0)
    offs = np.eye(4)
    offs[0, 3] = BASELINE
    return ([scene.render(T[i]) for i in range(STEREO_FRAMES)],
            [scene.render(T[i] @ offs) for i in range(STEREO_FRAMES)])


def test_stereo_tracker_follows_reference(stereo_frames):
    """The port's StereoTracker (ORB, its own features) and the JAX
    package's, with the reference's PnP-RANSAC draws: the same tracked
    and lost counts, poses within STEREO_POSE_TOL, and metric steps of
    ~0.5 m (the reference test's check)."""
    lefts, rights = stereo_frames
    cfg = dict(max_features=512, pnp_min_inliers=20, headless=True)
    ref = JStereoTracker(JConfig(**cfg), DEFAULT_K, baseline=BASELINE)
    got = StereoTracker(SLAMConfig(**cfg), DEFAULT_K, baseline=BASELINE,
                        device="cpu", key=JaxKey(jax.random.PRNGKey(0)))
    for L, R in zip(lefts, rights):
        assert ref.step(L, R) == got.step(L, R)
    assert (got.n_tracked, got.n_lost) == (ref.n_tracked, ref.n_lost)
    assert got.n_tracked >= STEREO_FRAMES - 2
    gap = max(np.abs(a - b).max() for a, b in zip(ref.poses, got.poses))
    assert gap <= STEREO_POSE_TOL, gap
    steps = [np.linalg.norm((b @ np.linalg.inv(a))[:3, 3])
             for a, b in zip(got.poses[1:-1], got.poses[2:])]
    assert abs(np.median(steps) - 0.5) < 0.1, steps


def test_stereo_tracker_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StereoTracker(SLAMConfig(), DEFAULT_K, baseline=BASELINE)
