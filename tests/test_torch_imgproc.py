"""The port's image helpers (``simpleslam_tpu_torch/utils/imgproc.py``)
against the cv2 calls that the JAX package's photograph paths make, and
the frame reader's JPEG path (``data/dataloader.py::imread_bgr``) against
``cv2.imread``, on seeded images and on photographs written here.

Tolerances:
- ``get_perspective_transform``: 1e-9 of the matrix's largest entry (an
  8x8 float64 solve, pivoted alike, rounded in another order);
- ``get_rotation_matrix_2d``: exact (one closed form in float64);
- ``warp_perspective``: float32 images in [0, 1] within 5e-5 (cv2 samples
  at float32 source points), float64 within 1e-12 (cv2's 1/32-pixel fixed
  point, emulated), uint8 within one level on at most 0.5% of the pixels;
- ``gaussian_blur``: float32 images in [0, 255] within 5e-4 (float32 sums
  in another order), float64 within 1e-9;
- the grey reader and ``imread_bgr``: equal to cv2, byte for byte;
- ``resize_area_u8``: equal to cv2 at whole factors, within one level
  elsewhere.
"""
import os

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from simpleslam_tpu_torch.data import dataloader
from simpleslam_tpu_torch.utils import imgproc

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

H, W = 90, 120


def _corners(rng, mag=0.15):
    c0 = np.float32([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1]])
    c1 = c0 + rng.uniform(-mag, mag, (4, 2)).astype(np.float32) \
        * np.float32([W, H])
    return c0, c1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perspective_and_rotation_matrices_match_cv2(seed):
    rng = np.random.default_rng(seed)
    c0, c1 = _corners(rng)
    want = cv2.getPerspectiveTransform(c0, c1)
    got = imgproc.get_perspective_transform(c0, c1)
    assert got.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    ang, s = rng.uniform(-15, 15), float(np.exp(rng.uniform(-0.22, 0.22)))
    np.testing.assert_array_equal(
        imgproc.get_rotation_matrix_2d((W / 2.0, H / 2.0), ang, s),
        cv2.getRotationMatrix2D((W / 2.0, H / 2.0), ang, s))


@pytest.mark.parametrize("dtype", ["float32", "float64", "uint8"])
def test_warp_perspective_matches_cv2(dtype):
    rng = np.random.default_rng(4)
    M = imgproc.get_perspective_transform(*_corners(rng))
    if dtype == "uint8":
        img = rng.integers(0, 256, (H, W), dtype=np.uint8)
        want = cv2.warpPerspective(img, M, (W, H))
        got = imgproc.warp_perspective(img, M, (W, H)).numpy()
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 5e-3
        return
    img = rng.uniform(0, 1, (H, W)).astype(dtype)
    want = cv2.warpPerspective(img, M.astype(np.float32), (W, H))
    got = imgproc.warp_perspective(torch.from_numpy(img),
                                   M.astype(np.float32), (W, H)).numpy()
    assert got.dtype == want.dtype
    tol = 5e-5 if dtype == "float32" else 1e-12
    assert np.abs(got - want).max() <= tol
    assert (want == 0).sum() > 0           # the border is in the test


@pytest.mark.parametrize("sigma", [1, 2, 4, 8])
def test_gaussian_blur_matches_cv2(sigma):
    rng = np.random.default_rng(sigma)
    img = rng.uniform(0, 255, (120, 160))
    assert len(imgproc.gaussian_kernel(sigma)) == {1: 9, 2: 17, 4: 33,
                                                   8: 65}[sigma]
    for dtype, tol in ((np.float32, 5e-4), (np.float64, 1e-9)):
        x = img.astype(dtype)
        want = cv2.GaussianBlur(x, (0, 0), sigmaX=sigma)
        got = imgproc.gaussian_blur(torch.from_numpy(x), sigma).numpy()
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= tol


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    rng = np.random.default_rng(7)
    views = [cv2.GaussianBlur(rng.integers(0, 256, (64, 80), np.uint8),
                              (0, 0), 1.5) for _ in range(8)]
    return chip_smoke.write_photos(str(tmp_path_factory.mktemp("ph")), views)


def test_grey_reader_equals_cv2(photos, tmp_path):
    kinds = [os.path.splitext(p)[1] for p in photos]
    assert kinds.count(".png") == 6 and kinds.count(".jpg") == 2
    for p in photos:
        want = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        got = imgproc.imread_gray(p)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=p)
    # colour PNGs are not their first channel: the conversion is exercised
    bgr = cv2.imread(photos[4], cv2.IMREAD_UNCHANGED)
    assert bgr.ndim == 3 and not np.array_equal(bgr[..., 0],
                                                imgproc.imread_gray(photos[4]))
    assert imgproc.imread_gray(str(tmp_path / "missing.png")) is None
    rgba = np.random.default_rng(1).integers(0, 256, (16, 24, 4), np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), rgba)
    np.testing.assert_array_equal(
        imgproc.imread_gray(str(tmp_path / "a.png")),
        cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_GRAYSCALE))


def test_imread_bgr_reads_jpeg_as_reference(photos, tmp_path, monkeypatch):
    from simpleslam_tpu.data import dataloader as jdl
    grey_jpg = str(tmp_path / "g.jpg")
    cv2.imwrite(grey_jpg, np.full((8, 8), 77, np.uint8))
    for p in photos + [grey_jpg]:
        got = dataloader.imread_bgr(p)
        assert got.ndim == 3 and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jdl.imread_bgr(p), err_msg=p)
    # without cv2 the JPEG path names the file; PNG needs no cv2
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="photo_06.jpg"):
        dataloader.imread_bgr(photos[6])
    with pytest.raises(ImportError, match="photo_07.jpg"):
        imgproc.imread_gray(photos[7])
    assert dataloader.imread_bgr(photos[0]).shape == (64, 80, 3)


def test_resize_area_u8_matches_cv2():
    img = np.random.default_rng(3).integers(0, 256, (96, 128), np.uint8)
    for hw, exact in (((48, 64), True), ((24, 32), True), ((37, 50), False)):
        want = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)
        got = imgproc.resize_area_u8(img, hw)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= (0 if exact else 1), hw
