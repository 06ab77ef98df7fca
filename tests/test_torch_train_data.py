"""Training data of the port (``models/train.py``, ``utils/resize.py``)
against the JAX package's on the CPU, on the same draws.

Tolerances:
- ``resize_bicubic_like_jax`` against ``jax.image.resize(..., "bicubic")``:
  1e-5 absolute on data in [0, 1] (both float32; the products are summed in
  another order). ``F.interpolate``'s bicubic misses by ~0.1 there.
- ``resize_linear`` / ``resize_area`` against ``cv2.resize``: 1e-4 absolute
  on data in [0, 255], a few float32 ulps at 255 (cv2 sums its two passes in
  another order).
- ``synthetic_pair_batch`` fed ``jax.random``'s draws: images 1e-5
  (float32 warps of [0, 1] data), points 1e-3 px (float32 homographies of
  ~100 px coordinates), every mask equal; the homographies, each a float32
  DLT fit (an SVD of a normalised 8x9 system), to 1e-4 of their largest
  entry.
- ``ScenePairPool``: the pool's trajectories, poses and K equal; its
  renders equal the reference's to one grey level; ``batch`` on the same
  views from the same ``np.random.Generator`` equal except view 1's resize
  (1e-6 on [0, 1]); ``photometric_augment`` bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.models import train as jtrain
from simpleslam_tpu_torch.models import train as ttrain
from simpleslam_tpu_torch.utils import resize

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("hw", [(144, 256), (48, 48)])
def test_bicubic_resize_matches_jax_at_smooth_noise_octaves(hw):
    H, W = hw
    rng = np.random.default_rng(H)
    for o in ttrain.OCTAVES:
        x = rng.uniform(size=(3, H // o + 2, W // o + 2)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (3, H, W),
                                           "bicubic"))
        got = resize.resize_bicubic_like_jax(torch.from_numpy(x), (H, W))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_bicubic_resize_shrinks_like_jax():
    x = np.random.default_rng(1).uniform(size=(2, 50, 70)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 21, 33),
                                       "bicubic"))
    got = resize.resize_bicubic_like_jax(torch.from_numpy(x), (21, 33))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", [0.8, 0.87, 0.95, 1.0, 1.004, 1.07, 1.16,
                               1.25, 2.0])
def test_linear_and_area_resize_match_cv2(s):
    cv2 = pytest.importorskip("cv2")
    H, W = 144, 256
    H1, W1 = int(round(H * s)), int(round(W * s))
    crop = np.random.default_rng(int(100 * s)).uniform(
        0, 255, (H1, W1)).astype(np.float32)
    interp = cv2.INTER_AREA if s > 1 else cv2.INTER_LINEAR
    fn = resize.resize_area if s > 1 else resize.resize_linear
    want = cv2.resize(crop, (W, H), interpolation=interp)
    got = fn(torch.from_numpy(crop), (H, W)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def jax_synthetic_draws(key, B, H, W, G):
    """The draws ``simpleslam_tpu.models.train.synthetic_pair_batch`` makes
    from ``key``, in the port's layout."""
    keys = jax.random.split(key, 4)
    k, coarse = keys[0], []
    for o in ttrain.OCTAVES:
        k, sub = jax.random.split(k)
        coarse.append(torch.from_numpy(np.array(
            jax.random.uniform(sub, (B, H // o + 2, W // o + 2)))))
    jitter = np.stack([np.asarray(jax.random.uniform(
        jax.random.split(kb)[0], (4, 2), minval=-0.12, maxval=0.12))
        for kb in jax.random.split(keys[1], B)])
    m = ttrain.MARGIN
    x1 = jax.random.uniform(keys[2], (B, G), minval=m, maxval=W - m)
    y1 = jax.random.uniform(keys[3], (B, G), minval=m, maxval=H - m)
    return {"coarse": coarse, "jitter": torch.from_numpy(jitter),
            "x1": torch.from_numpy(np.array(x1)),
            "y1": torch.from_numpy(np.array(y1))}


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_pair_batch_from_jax_draws(seed):
    B, H, W, G = 3, 48, 64, 24
    key = jax.random.PRNGKey(seed)
    want = jtrain.synthetic_pair_batch(key, B=B, H=H, W=W, G=G)
    got = ttrain.synthetic_pair_batch_from_draws(
        jax_synthetic_draws(key, B, H, W, G), H, W)
    assert set(got) == set(want)
    for k in ("pt_valid", "warp_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("img0", "img1"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0)
    for k in ("pts0", "pts1", "warp01"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-3, rtol=0)
    Hw = np.asarray(want["Hmats"])
    np.testing.assert_allclose(got["Hmats"].numpy(), Hw, rtol=0,
                               atol=1e-4 * np.abs(Hw).max())
    # drawn from a torch.Generator: the same layout, in range
    g = torch.Generator().manual_seed(seed)
    own = ttrain.synthetic_pair_batch(g, B, H, W, G)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in got.items()}
    assert float(own["img0"].min()) == 0.0 and float(own["img0"].max()) == 1.0


@pytest.fixture(scope="module")
def pools():
    kw = dict(n_views=6, seed=2, n_scenes=2, render_hw=(64, 96))
    ref = jtrain.ScenePairPool((48, 64), cache_dir=None, **kw)
    port = ttrain.ScenePairPool((48, 64), device="cpu", **kw)
    return ref, port


def test_scene_pool_renders_like_reference(pools):
    ref, port = pools
    np.testing.assert_array_equal(port.K, ref.K)
    assert port.n == ref.n and port._per == ref._per
    for a, b in zip(port.poses, ref.poses):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.imgs, ref.imgs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    for a, b in zip(port.depth, ref.depth):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for a, b in zip(port.pts, ref.pts):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_scene_pool_batch_and_augment_follow_reference_draws(pools):
    ref, _ = pools
    port = ttrain.ScenePairPool.__new__(ttrain.ScenePairPool)
    port.K, port.hw, port.render_hw = ref.K, ref.hw, ref.render_hw
    port.set_views(ref.imgs, ref.pts, ref.depth, ref.poses, ref._per)
    for seed in (0, 1):
        r_ref, r_port = (np.random.default_rng(seed) for _ in range(2))
        raw_ref, raw = ref.batch(r_ref, 4, 24), port.batch(r_port, 4, 24)
        assert raw["pt_valid"].sum() > 0
        for k in raw_ref:
            tol = 1e-6 if k == "img1" else 0
            np.testing.assert_allclose(raw[k], raw_ref[k], atol=tol, rtol=0)
        want = jtrain.photometric_augment(r_ref, raw_ref)
        got = ttrain.photometric_augment(r_port, raw)
        for k in want:
            tol = 1e-5 if k == "img1" else 0
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0)
        assert r_ref.random() == r_port.random()     # the same draws used


def test_photometric_augment_bit_for_bit():
    rng = np.random.default_rng(5)
    batch = {"img0": rng.uniform(size=(2, 16, 16, 1)).astype(np.float32),
             "img1": rng.uniform(size=(2, 16, 16, 1)).astype(np.float32),
             "pts0": np.zeros((2, 4, 2), np.float32)}
    want = jtrain.photometric_augment(np.random.default_rng(9), batch)
    got = ttrain.photometric_augment(np.random.default_rng(9), batch)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_other_scene_families_raise():
    """An unknown family raises ``KeyError`` in both packages, as the
    reference's ``SCENE_FAMILIES[fam]`` lookup does."""
    for make in (lambda: jtrain.ScenePairPool(
            (48, 64), n_views=2, n_scenes=1, families=("tunnel",),
            cache_dir=None),
            lambda: ttrain.ScenePairPool((48, 64), n_views=2, n_scenes=1,
                                         families=("tunnel",),
                                         device="cpu")):
        with pytest.raises(KeyError, match="tunnel"):
            make()
