"""The port's image IO, dataset layer and KITTI-layout writer against cv2 and
the JAX package's, on the CPU.

* PNG: the port's decoder reads what ``cv2.imwrite`` writes and cv2 reads
  what the port writes, equal in every pixel (grey, BGR, BGRA, odd widths);
  every row filter (0-4) with IDAT split over chunks; the unsupported
  variants raise naming the case.
* Dataset: on a 180x410 corridor written by the reference (``fov`` and
  ``crop`` cameras) and on a hand-built TUM fixture, the port's
  ``Sequence`` equals the reference's (frames, K, calibration, GT,
  timestamps); one frame, an unknown dataset, ``.jpg`` and ``custom`` raise
  as the reference does (or name the missing decoder).
* Synth: the port's ``generate_kitti_sequence`` against the reference's
  numpy renderer at 128x256 and 4 frames: the pose and calibration text
  equal, the images identical (the renderer tolerance of
  ``tests/test_torch_tools.py``).
"""
import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

cv2 = pytest.importorskip("cv2")

import simpleslam_tpu.tools.synth as jsynth
from simpleslam_tpu.data import Sequence as JSequence
from simpleslam_tpu.data import dataloader as jdl
from simpleslam_tpu_torch.data import Prefetcher, Sequence, dataloader
from simpleslam_tpu_torch.tools import synth
from simpleslam_tpu_torch.utils import png


@pytest.mark.parametrize("shape", [(37, 53), (40, 61, 3), (23, 17, 4),
                                   (64, 128, 3)])
def test_png_round_trips_with_cv2(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    assert np.array_equal(png.read_png(path), img)
    png.write_png(path, img)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def _filtered(px, filters):
    """Scanlines of ``px`` (h, w, c) with each row's given filter."""
    h, w, c = px.shape
    p = px.astype(np.int16)
    rows = []
    for y in range(h):
        up = p[y - 1] if y else np.zeros_like(p[y])
        left = np.concatenate([np.zeros((1, c), np.int16), p[y, :-1]])
        ul = np.concatenate([np.zeros((1, c), np.int16), up[:-1]])
        pred = [0 * left, left, up, (left + up) >> 1,
                png._paeth(left, up, ul)][filters[y]]
        rows.append(bytes([filters[y]])
                    + ((p[y] - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(rows)


def _png_bytes(w, h, ctype, data, depth=8, interlace=0, split=2):
    cut = len(data) // split
    idat = [data[i * cut:(i + 1) * cut if i < split - 1 else len(data)]
            for i in range(split)]
    return (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                              ctype, 0, 0, interlace))
            + b"".join(png._chunk(b"IDAT", d) for d in idat)
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype, channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_png_decodes_every_row_filter(ctype, channels):
    rng = np.random.default_rng(ctype)
    px = rng.integers(0, 256, (30, 45, channels), dtype=np.uint8)
    filters = rng.integers(0, 5, 30)
    data = _png_bytes(45, 30, ctype, zlib.compress(_filtered(px, filters)),
                      split=3)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("kw, match", [
    (dict(ctype=3), "palette"), (dict(ctype=0, interlace=1), "interlaced"),
    (dict(ctype=0, depth=16), "16-bit"), (dict(ctype=0, depth=4), "4-bit")])
def test_png_unsupported_variants_raise(kw, match):
    data = _png_bytes(4, 4, data=zlib.compress(b"\0" * 40), **kw)
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)


@pytest.fixture(scope="module")
def kitti_bases(tmp_path_factory):
    out = {}
    for calib in ("fov", "crop"):
        base = str(tmp_path_factory.mktemp(f"kitti_{calib}"))
        jsynth.generate_kitti_sequence(base, n_frames=4, seed=2,
                                       hw=(180, 410), calib=calib)
        out[calib] = base
    return out


def _args(dataset, base):
    return SimpleNamespace(dataset=dataset, base_dir=base)


def _assert_same_sequence(got, want):
    assert len(got) == len(want) and got.frames == want.frames
    assert got.name == want.name
    assert got.timestamps is None and want.timestamps is None
    for i in range(len(want)):
        assert np.array_equal(got.frame(i), want.frame(i)), i
    assert set(got.calib) == set(want.calib)
    for k, v in want.calib.items():
        if v is None or isinstance(v, bool):
            assert got.calib[k] is v or got.calib[k] == v, k
        else:
            assert np.array_equal(got.calib[k], v), k
    assert np.array_equal(got.K, want.K)
    assert (got.D is None and want.D is None) or np.array_equal(got.D, want.D)
    assert np.array_equal(got.gt, want.gt)


@pytest.mark.parametrize("calib", ["fov", "crop"])
def test_kitti_sequence_equals_reference(kitti_bases, calib):
    args = _args("kitti", kitti_bases[calib])
    got, want = Sequence.load(args), JSequence.load(args)
    _assert_same_sequence(got, want)
    assert got.frame(0).shape == (180, 410, 3)
    assert got.calib.get("native") is (True if calib == "crop" else None)
    assert dataloader.load_stereo_paths(args) == []
    a, b = dataloader.load_frame_pair(args, got.frames, 1)
    assert np.array_equal(a, want.frame(1)) and np.array_equal(b,
                                                               want.frame(2))


def _write_tum(base):
    """A TUM fr3 layout: 5 PNG frames, rgb.txt and a quaternion GT table
    whose stamps straddle the frames'."""
    seq_dir = os.path.join(base, "tum-rgbd",
                           "rgbd_dataset_freiburg3_long_office_household")
    os.makedirs(os.path.join(seq_dir, "rgb"))
    rng = np.random.default_rng(4)
    stamps = 1341847980.0 + np.cumsum(rng.uniform(0.03, 0.04, 5))
    lines = ["# color images", "# timestamp filename"]
    for i, t in enumerate(stamps):
        name = f"rgb/{t:.6f}.png"
        cv2.imwrite(os.path.join(seq_dir, name),
                    rng.integers(0, 256, (24, 32, 3), dtype=np.uint8))
        lines.append(f"{t:.6f} {name}")
    with open(os.path.join(seq_dir, "rgb.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    gt_t = stamps[0] - 0.02 + np.arange(20) * 0.011
    q = rng.normal(size=(20, 4))
    rows = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for t, p, qq in zip(gt_t, rng.normal(size=(20, 3)), q):
        rows.append(" ".join(f"{v:.4f}" for v in (t, *p, *qq)))
    with open(os.path.join(seq_dir, "groundtruth.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def test_tum_sequence_equals_reference(tmp_path):
    _write_tum(str(tmp_path))
    args = _args("tum-rgbd", str(tmp_path))
    got, want = Sequence.load(args), JSequence.load(args)
    _assert_same_sequence(got, want)
    assert got.K[0, 0] != 535.4        # rescaled to the 24x32 frames
    assert np.array_equal(got.D, np.zeros(5))


def test_malaga_gps_groundtruth_equals_reference(tmp_path):
    """Malaga's GPS log (pandas in the reference, numpy here): the frames
    trimmed to the log's interval, positions interpolated and remapped;
    its JPEG frames read as ``cv2.imread`` reads them."""
    pytest.importorskip("pandas")
    prefix = tmp_path / "malaga"
    img_dir = prefix / \
        "malaga-urban-dataset-extract-07_rectified_800x600_Images"
    img_dir.mkdir(parents=True)
    rng, pix = np.random.default_rng(6), np.random.default_rng(60)
    for t in 100.0 + np.arange(8) * 0.25:
        cv2.imwrite(str(img_dir / f"img_CAMERA1_{t:.6f}_left.jpg"),
                    pix.integers(0, 256, (12, 16, 3), np.uint8))
    rows = ["% GPS log", "% columns ..."]
    for t in 100.3 + np.arange(9) * 0.2:
        vals = rng.normal(size=25)
        vals[0] = t
        rows.append(" ".join(f"{v:.6f}" for v in vals))
    (prefix / "malaga-urban-dataset-extract-07_all-sensors_GPS.txt") \
        .write_text("\n".join(rows) + "\n")
    args = _args("malaga", str(tmp_path))
    want_seq, got_seq = jdl.load_sequence(args), dataloader.load_sequence(args)
    assert got_seq == want_seq
    gps = str(prefix / "malaga-urban-dataset-extract-07_all-sensors_GPS.txt")
    want = jdl._malaga_groundtruth(gps, want_seq)
    got = dataloader._malaga_groundtruth(gps, got_seq)
    assert got_seq == want_seq and len(got_seq) < 8
    assert np.array_equal(got, want)
    assert np.array_equal(dataloader.load_groundtruth(args),
                          jdl.load_groundtruth(args))
    # Malaga's JPEG frames read as cv2.imread reads them
    for f in got_seq:
        np.testing.assert_array_equal(dataloader.imread_bgr(f),
                                      cv2.imread(f, cv2.IMREAD_UNCHANGED))


def test_error_cases_raise_as_reference(tmp_path):
    one = tmp_path / "one"
    os.makedirs(one / "kitti" / "05" / "image_0")
    cv2.imwrite(str(one / "kitti" / "05" / "image_0" / "000000.png"),
                np.zeros((8, 8), np.uint8))
    for mod in (jdl, dataloader):
        with pytest.raises(RuntimeError, match="at least two frames"):
            mod.load_sequence(_args("kitti", str(one)))
        with pytest.raises(ValueError, match="Unknown dataset"):
            mod.load_sequence(_args("euroc", str(one)))
        with pytest.raises(ValueError, match="No calibration"):
            mod.load_calibration(_args("parking", str(one)))
    with pytest.raises(RuntimeError, match="requires cv2"):
        dataloader.load_sequence(_args("custom", str(one)))
    with pytest.raises(FileNotFoundError):
        dataloader.imread_bgr(str(tmp_path / "missing.png"))
    grey = dataloader.imread_bgr(
        str(one / "kitti" / "05" / "image_0" / "000000.png"))
    assert grey.shape == (8, 8, 3)


def test_prefetcher_yields_every_frame_and_raises_decode_errors(kitti_bases):
    seq = Sequence.load(_args("kitti", kitti_bases["fov"]))
    pf = Prefetcher(seq, depth=2, start=1, transform=torch.as_tensor)
    got = list(pf)
    assert [i for i, _ in got] == [1, 2, 3]
    assert all(torch.equal(img, torch.as_tensor(seq.frame(i)))
               for i, img in got)
    seq.frames[2] = seq.frames[2] + ".missing"
    with pytest.raises(FileNotFoundError):
        list(Prefetcher(seq, start=0))


def _numpy_texture_only():
    raise RuntimeError("reference numpy path")


@pytest.mark.parametrize("calib", ["fov", "crop"])
def test_generate_kitti_sequence_equals_reference(tmp_path, monkeypatch,
                                                  calib):
    monkeypatch.setattr(jsynth, "_jax_tex", _numpy_texture_only)
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(n_frames=4, seed=1, hw=(128, 256), speed=0.5, yaw_rate_deg=0.3,
              calib=calib)
    jsynth.generate_kitti_sequence(ref, **kw)
    assert synth.generate_kitti_sequence(port, device="cpu", **kw) == port
    for rel in ("kitti/poses/05.txt", "kitti/05/calib.txt"):
        if calib == "fov" and rel.endswith("calib.txt"):
            assert not os.path.exists(os.path.join(port, rel))
            continue
        with open(os.path.join(ref, rel)) as a, \
                open(os.path.join(port, rel)) as b:
            assert a.read() == b.read(), rel
    for i in range(4):
        name = f"kitti/05/image_0/{i:06d}.png"
        want = cv2.imread(os.path.join(ref, name), cv2.IMREAD_UNCHANGED)
        got = png.read_png(os.path.join(port, name))
        assert got.dtype == np.uint8 and np.array_equal(got, want), i


@pytest.mark.parametrize("kind", ["loop", "square"])
def test_loop_trajectories_equal_reference(kind):
    if kind == "loop":
        want = jsynth.make_loop_trajectory(50, speed=0.4, closure_frac=0.7)
        got = synth.make_loop_trajectory(50, speed=0.4, closure_frac=0.7)
    else:
        want = jsynth.make_square_loop_trajectory(90, corner_frames=8)
        got = synth.make_square_loop_trajectory(90, corner_frames=8)
    assert np.array_equal(got, want)


def test_synth_cli_writes_a_sequence_the_port_reads(tmp_path, monkeypatch):
    out = str(tmp_path / "cli")
    assert synth.main(["--out", out, "--frames", "3", "--hw", "48", "96",
                       "--device", "cpu", "--trajectory", "square"]) == 0
    seq = Sequence.load(_args("kitti", out))
    assert len(seq) == 3 and seq.gt.shape == (3, 3, 4)
    assert seq.frame(2).shape == (48, 96, 3)
    boxes = str(tmp_path / "boxes")
    assert synth.main(["--out", boxes, "--frames", "2", "--hw", "48", "96",
                       "--device", "cpu", "--scene", "boxes",
                       "--trajectory", "square"]) == 0
    assert Sequence.load(_args("kitti", boxes)).frame(1).shape == (48, 96, 3)
    # the photo family, on photographs written here
    import chip_smoke
    rng = np.random.default_rng(2)
    chip_smoke.write_photos(str(tmp_path / "ph"), [
        rng.integers(0, 256, (40, 56), np.uint8) for _ in range(8)])
    monkeypatch.setattr(synth, "REAL_PHOTO_GLOB", str(tmp_path / "ph" / "*"))
    photo = str(tmp_path / "photo")
    assert synth.main(["--out", photo, "--frames", "2", "--hw", "48", "96",
                       "--device", "cpu", "--scene", "photo",
                       "--trajectory", "loop"]) == 0
    assert Sequence.load(_args("kitti", photo)).frame(1).shape == (48, 96, 3)
