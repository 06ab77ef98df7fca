"""SIFT and AKAZE in the port (``ops/features_sift.py``,
``ops/features_akaze.py``) against the JAX package's, on the CPU, on the
reference's ``_blob_image`` (``tests/test_sift.py``) and on frame 0 of the
synthetic corridor at 180x410. Tolerances:

* ``_extrema_mask`` on the same DoG stack, ``_fed_tau``,
  ``_fed_cycle_steps``, ``_MLDB_W`` and ``_MLDB_PAIRS``: exactly equal;
* the DoG stack and ``nonlinear_scale_space``'s levels: within 1e-5 (the
  convolutions and the percentile sum in another order; 2.4e-7 measured),
  the antialiased halving at the CLI's odd sizes within 1e-6;
* keypoint sets: at least 99% of the reference's valid keypoints have a
  port keypoint within 1e-3 px (near-tie scores may swap the last rows);
* SIFT: orientations on the same gradients agree (within 1e-5 rad) for at
  least 99% of the keypoints (the 36-bin histogram is a scatter-add, whose
  float sum in another order can flip a near-tie), and the descriptors of
  the shared keypoints are within 1e-4 in L2;
* AKAZE: at most 1% of the bits differ over the shared keypoints;
* one 8-frame run per detector through ``run``, host and ``--fused``: the
  JAX host run's keyframe frames and lost count (SIFT at 370x1226 over 6
  frames: its detector finds too few keypoints at 180x410 to bootstrap).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleslam_tpu.ops import features_akaze as jakaze
from simpleslam_tpu.ops import features_sift as jsift
from simpleslam_tpu_torch.ops import features_akaze as akaze
from simpleslam_tpu_torch.ops import features_sift as sift

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import shared_keypoints  # noqa: E402  (the smoke's, too)

cv2 = pytest.importorskip("cv2")

SMALL_HW = (180, 410)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blob_image(rng, H=192, W=256, n=70):
    """``tests/test_sift.py::_blob_image``."""
    img = np.full((H, W), 40.0, np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n):
        cy, cx = rng.integers(25, H - 25), rng.integers(25, W - 25)
        s = rng.uniform(2.0, 6.0)
        img += rng.uniform(60, 180) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                             / (2 * s * s))
    return np.clip(img, 0, 255)


def corridor_grey(hw, tmp):
    """Frame 0 of the synthetic corridor (seed 0) at ``hw``, in grey as the
    front-end converts it."""
    from simpleslam_tpu.tools.synth import generate_kitti_sequence
    generate_kitti_sequence(tmp, n_frames=1, seed=0, hw=hw)
    bgr = cv2.imread(os.path.join(tmp, "kitti", "05", "image_0",
                                  "000000.png"))
    b, g, r = (bgr[..., i].astype(np.float32) for i in range(3))
    return 0.114 * b + 0.587 * g + 0.299 * r


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return {"blob": _blob_image(np.random.default_rng(0)).astype(np.float32),
            "corridor": corridor_grey(SMALL_HW,
                                      str(tmp_path_factory.mktemp("c")))}


def shared_rows(ref, port):
    """For each valid reference keypoint, the valid port row at the same
    position (within 1e-3 px) with the nearest score, or -1; and the
    reference's valid mask."""
    r = {k: np.asarray(v) for k, v in vars(ref).items()}
    return shared_keypoints(r, port.numpy()), r["valid"]


def test_sift_scale_space_and_extrema_match_reference(images):
    """The DoG stack within 1e-5; ``_extrema_mask`` on the reference's DoG
    exactly equal (the corridor frame)."""
    for img in (images["corridor"],):
        G_j, dog_j = jax.jit(jsift._dog_stack)(jnp.asarray(img / 255.0))
        G_p, dog_p = sift._dog_stack(torch.as_tensor(img / 255.0))
        np.testing.assert_allclose(G_p.numpy(), np.asarray(G_j), atol=1e-5)
        np.testing.assert_allclose(dog_p.numpy(), np.asarray(dog_j),
                                   atol=1e-5)
        want = np.asarray(jax.jit(jsift._extrema_mask)(dog_j))
        got = sift._extrema_mask(torch.as_tensor(np.array(dog_j))).numpy()
        assert want.any()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["blob", "corridor"])
def test_sift_matches_reference(name, images):
    """Keypoints, orientations and descriptors against the reference's
    extract (256 keypoints, 3 octaves)."""
    img = images[name]
    ref = jsift.sift_detect_and_describe(jnp.asarray(img), max_kp=256)
    port = sift.sift_detect_and_describe(torch.as_tensor(img), max_kp=256)
    assert port.kpts.shape == (256, 2) and port.desc.shape == (256, 128)
    assert port.desc.dtype == torch.float32
    rows, vr = shared_rows(ref, port)
    assert vr.sum() > 30 and (rows[vr] >= 0).mean() >= 0.99
    assert port.valid.sum() == vr.sum()
    # orientations on the same gradients and keypoints (level 0's)
    gx, gy = sift._grad(sift._dog_stack(torch.as_tensor(img / 255.0))[0][1])
    kr = np.asarray(ref.kpts)[vr].astype(np.int32)
    th_j = np.asarray(jax.jit(jsift._orientations)(
        jnp.asarray(gx.numpy()), jnp.asarray(gy.numpy()),
        jnp.asarray(kr[:, 0]), jnp.asarray(kr[:, 1])))
    th_p = sift._orientations(gx, gy, torch.as_tensor(kr[:, 0]).long(),
                              torch.as_tensor(kr[:, 1]).long()).numpy()
    same = np.abs(th_p - th_j) <= 1e-5
    assert same.mean() >= 0.99
    d_ref = np.asarray(ref.desc)[vr][rows[vr] >= 0]
    d_port = port.desc.numpy()[rows[vr][rows[vr] >= 0]]
    err = np.linalg.norm(d_ref - d_port, axis=1)
    assert err[same[rows[vr] >= 0]].max() <= 1e-4


def test_fed_and_mldb_tables_match_reference():
    """The FED steps and the M-LDB tables: exactly equal."""
    for T in (0.08, 0.5, 1.3, 2.7, 11.0):
        n = akaze._fed_cycle_steps(T)
        assert n == jakaze._fed_cycle_steps(T)
        np.testing.assert_array_equal(akaze._fed_tau(n, T),
                                      jakaze._fed_tau(n, T))
    np.testing.assert_array_equal(akaze._MLDB_W, jakaze._MLDB_W)
    np.testing.assert_array_equal(akaze._MLDB_PAIRS, jakaze._MLDB_PAIRS)
    assert akaze._MLDB_W.dtype == np.float32


def test_nonlinear_scale_space_matches_reference(images):
    """Every level within 1e-5 of the reference's, with the same sigmas
    and octaves (the corridor frame); the halving at the CLI frames' odd
    sizes (370x1226 on to 46x153) within 1e-6 of ``jax.image.resize``."""
    meta = []

    def levels(x):
        out = jakaze.nonlinear_scale_space(x)
        meta[:] = [(s, o) for _, s, o in out]
        return [L for L, _, _ in out]
    for img in (images["corridor"],):
        ref = jax.jit(levels)(jnp.asarray(img))
        port = akaze.nonlinear_scale_space(torch.as_tensor(img))
        assert [(s, o) for _, s, o in port] == meta
        for (Lp, _, _), Lj in zip(port, ref):
            np.testing.assert_allclose(Lp.numpy(), np.asarray(Lj), atol=1e-5)
    rng = np.random.default_rng(2)
    for hw in ((370, 1226), (185, 613), (92, 306), (46, 153)):
        L = rng.uniform(0, 1, hw).astype(np.float32)
        want = jax.image.resize(jnp.asarray(L), (hw[0] // 2, hw[1] // 2),
                                "linear")
        np.testing.assert_allclose(akaze.resize_half(torch.as_tensor(L))
                                   .numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", ["blob", "corridor"])
def test_akaze_matches_reference(name, images):
    """Keypoints and descriptors against the reference's extract (512
    keypoints, 4 octaves x 4 sublevels)."""
    img = images[name]
    ref = jakaze.akaze_detect_and_describe(jnp.asarray(img), max_kp=512)
    port = akaze.akaze_detect_and_describe(torch.as_tensor(img), max_kp=512)
    assert port.desc.shape == (512, 64) and port.desc.dtype == torch.uint8
    rows, vr = shared_rows(ref, port)
    assert vr.sum() > 100 and (rows[vr] >= 0).mean() >= 0.99
    assert port.valid.sum() == vr.sum()
    ok = rows >= 0
    bits = np.unpackbits(np.asarray(ref.desc)[ok]
                         ^ port.desc.numpy()[rows[ok]], axis=1)
    assert bits.sum() <= 0.01 * 486 * ok.sum()
    # M-LDB on the same patches and angles (one a bin): bit for bit
    rng = np.random.default_rng(3)
    pats = [rng.uniform(-1, 1, (30, 32, 32)).astype(np.float32)
            for _ in range(3)]
    theta = np.linspace(-np.pi, np.pi, 30, endpoint=False, dtype=np.float32)
    want = np.asarray(jakaze._mldb_describe(*map(jnp.asarray, pats),
                                            jnp.asarray(theta)))
    got = akaze._mldb_describe(*map(torch.as_tensor, pats),
                               torch.as_tensor(theta)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["sift", "akaze"])
def test_facade(name, images):
    """``init_feature_pipeline`` takes the reference's ``sift`` and
    ``akaze`` branches: the detector pads to 128 rows past
    ``max_features``, ``feature_extractor`` converts a BGR frame as the
    direct call on its grey, and the matcher is the cross-checked
    brute-force one (L2 for SIFT's floats, Hamming for AKAZE's bytes)."""
    from simpleslam_tpu_torch.config import SLAMConfig
    from simpleslam_tpu_torch.core import frontend
    from simpleslam_tpu_torch.ops.matching import bf_match
    cfg = SLAMConfig(detector=name, max_features=300)
    det, mat = frontend.init_feature_pipeline(cfg, device="cpu")
    grey = images["corridor"]
    bgr = np.repeat(np.round(grey).astype(np.uint8)[..., None], 3, -1)
    f = frontend.feature_extractor(cfg, bgr, det)
    direct = {"sift": sift.sift_detect_and_describe,
              "akaze": akaze.akaze_detect_and_describe}[name](
        frontend.rgb_to_gray(torch.as_tensor(bgr)), max_kp=384)
    assert f.kpts.shape[0] == 384
    for k in ("kpts", "desc", "valid"):
        assert torch.equal(getattr(f, k), getattr(direct, k))
    m = frontend.feature_matcher(cfg, f, f, mat)
    assert torch.equal(m.valid, bf_match(f, f).valid)
    assert int(m.valid.sum()) >= 0.95 * int(f.valid.sum())


@pytest.mark.parametrize("name", ["sift", "akaze"])
def test_fused_state_takes_the_descriptors(name, images):
    """The fused step's config and state for the detector's descriptors
    (SIFT: 128 float32, AKAZE: 64 bytes) against the reference's: the
    descriptor width and dtype of every descriptor field, the place
    vector's width (binary descriptors pool as their bits), the two match
    gates, every field's shape."""
    from simpleslam_tpu.config import SLAMConfig as JConfig
    from simpleslam_tpu.core import fused as jfused
    from simpleslam_tpu_torch.config import SLAMConfig
    from simpleslam_tpu_torch.core import fused
    fn = {"sift": sift.sift_detect_and_describe,
          "akaze": akaze.akaze_detect_and_describe}[name]
    f = fn(torch.as_tensor(images["corridor"]), max_kp=256)
    kw = dict(detector=name, map_capacity=2048)
    fc = fused.make_fused_config(SLAMConfig(**kw), SMALL_HW, 256,
                                 f.desc.shape[1])
    fj = jfused.make_fused_config(JConfig(**kw), SMALL_HW, 256,
                                  f.desc.shape[1])
    assert (fc.desc_dim, fc.max_hamm, fc.max_l2) == \
        (fj.desc_dim, fj.max_hamm, fj.max_l2) == \
        ({"sift": 128, "akaze": 64}[name], 64.0, 0.8)
    state = fused.abstract_state(fc, desc_dtype=f.desc.dtype)
    ref = jfused.abstract_state(fj, desc_dtype=np.dtype(
        str(f.desc.dtype).replace("torch.", "")))
    assert f.desc.dtype == {"sift": torch.float32, "akaze": torch.uint8}[name]
    for k in ("prev_desc", "kf_desc", "desc_ring", "kf_place"):
        a, b = getattr(state, k), getattr(ref, k)
        assert tuple(a.shape) == tuple(b.shape), k
        if k != "kf_place":
            assert str(a.dtype).replace("torch.", "") == str(b.dtype), k
    assert state.kf_place.shape[-1] == 16 * f.desc.shape[1] * (
        8 if name == "akaze" else 1)


def _cli_case(detector):
    """(frames, hw, config overrides) of a detector's run: the reference's
    small fixture settings at 512 keypoints and a 2048-row map."""
    kw = dict(max_features=512, map_capacity=2048)
    if detector == "sift":
        return 6, (370, 1226), kw
    return 8, SMALL_HW, dict(kw, kf_min_inliers=40, pnp_min_inliers=15)


@pytest.mark.parametrize("detector", ["sift", "akaze"])
def test_cli_runs_follow_reference(detector, tmp_path, monkeypatch):
    """One run per detector through ``run``, host and ``--fused``, against
    the JAX package's host run of the same config: the same keyframe
    frames and lost count."""
    from simpleslam_tpu.config import SLAMConfig as JConfig
    from simpleslam_tpu.run_slam import run as jrun
    from simpleslam_tpu.tools.synth import generate_kitti_sequence
    from simpleslam_tpu_torch import run_slam
    from simpleslam_tpu_torch.config import SLAMConfig
    monkeypatch.chdir(tmp_path)
    n, hw, kw = _cli_case(detector)
    base = str(tmp_path)
    generate_kitti_sequence(base, n_frames=n, seed=0, hw=hw)
    common = dict(dataset="kitti", base_dir=base, headless=True,
                  no_viz3d=True, detector=detector, **kw)
    ref = jrun(JConfig(**common))
    assert ref.n_keyframes >= 2
    for fused in (False, True):
        res = run_slam.run(SLAMConfig(fused=fused, **common), device="cpu")
        assert res.kf_frames == ref.kf_frames
        assert res.tracking_lost_count == ref.tracking_lost_count
        assert len(res.poses_cw) == len(ref.poses_cw)
        assert res.ate is not None and np.isfinite(res.ate)


def cli_readings(runner, parser, base, detector, fused, seed, **kw):
    """One CLI run over the KITTI-layout sequence under ``base``: lost
    frames, ATE, keyframes, keyframe frames and frames posed."""
    argv = ["--dataset", "kitti", "--base_dir", base, "--headless",
            "--no_viz3d", "--detector", detector, "--seed", str(seed)]
    res = runner(parser(argv + (["--fused"] if fused else [])), **kw)
    return {"lost": int(res.tracking_lost_count), "ate_m": res.ate,
            "keyframes": int(res.n_keyframes), "kf_frames": res.kf_frames,
            "posed": len(res.poses_cw)}


if __name__ == "__main__":
    # Each detector's CLI run, host and --fused, per RANSAC seed, over the
    # first --frames frames of tools.synth's default corridor (seed 0,
    # 370x1226, the CLI's 4000 features): the JAX package's readings
    # (--reference) or the port's on the CPU, with its own RANSAC draws or,
    # with --jax_draws, the reference's (``JaxKey``):
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sift_akaze.py \
    #       --reference --frames 16 --seeds 0,1,2,3 --detectors sift,akaze
    import argparse
    import json
    import logging
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", action="store_true",
                    help="the JAX package's runs instead of the port's")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--detectors", default="sift,akaze")
    ap.add_argument("--modes", default="host,fused")
    ap.add_argument("--jax_draws", action="store_true",
                    help="the port's runs with the reference's RANSAC draws")
    a = ap.parse_args()
    logging.disable(logging.CRITICAL)
    from simpleslam_tpu.tools.synth import generate_kitti_sequence
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        generate_kitti_sequence(tmp, n_frames=a.frames, seed=0)
        if a.reference:
            from simpleslam_tpu.config import parse_config as jparse
            from simpleslam_tpu.run_slam import run as jrun
            runner, parser, kw = jrun, jparse, {}
        else:
            from simpleslam_tpu_torch import run_slam
            from simpleslam_tpu_torch.config import parse_config
            runner, parser, kw = run_slam.run, parse_config, {"device": "cpu"}
        for det in a.detectors.split(","):
            for mode in a.modes.split(","):
                for seed in map(int, a.seeds.split(",")):
                    if a.jax_draws and not a.reference:
                        from test_torch_slam import JaxKey
                        kw["key"] = JaxKey(jax.random.PRNGKey(seed))
                    r = cli_readings(runner, parser, tmp, det,
                                     mode == "fused", seed, **kw)
                    print(json.dumps({"detector": det, "mode": mode,
                                      "seed": seed, "draws": "jax" if (
                                          a.reference or a.jax_draws)
                                      else "torch", **r}), flush=True)
