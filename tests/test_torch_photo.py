"""The photograph paths of the port against the JAX package's on the CPU:
``tools/synth.py::PhotoScene`` and ``--scene photo``, the training pools
over the ``boxes`` and ``photo`` families (``models/train.py::
ScenePairPool``), ``PhotoPairPool`` and ``train_frontend``'s
``--real_frac`` mix.

The photographs are written here (``chip_smoke.write_photos``): views of
the JAX package's box and corridor scenes with noise and hard edges, as
grey and BGR PNG and as 4:2:0 and 4:4:4 JPEG. Both packages'
``REAL_PHOTO_GLOB`` point at them; ``grace_hopper.jpg`` joins the training
half where matplotlib has it.

Tolerances:
- images: within one level (the mip level choice and the float32 lookups
  are the reference's expressions; a level can still flip where a value
  sits on a rounding edge);
- hit points and depths (float64): 1e-9;
- the pools' photographs and crops: 1e-12 (area halving in float64);
  ``img1`` of a photo pair within 1e-6 (cv2's fixed-point warp of a
  float64 crop, emulated, then stored as float32 in both); ``warp01``
  within 1e-4 px; ``warp_valid`` equal except within 1e-6 px of the
  margin; the draws alike (``r_ref.random() == r_port.random()``
  afterwards).
"""
import glob
import os

import numpy as np
import pytest
import torch

import chip_smoke
from simpleslam_tpu.models import train as jtrain
from simpleslam_tpu.tools import synth as jsynth
from simpleslam_tpu_torch.models import train as ttrain
from simpleslam_tpu_torch.models import train_frontend
from simpleslam_tpu_torch.tools import synth as tsynth

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _k(hw):
    K = jsynth.DEFAULT_K.copy()
    K[0] *= hw[1] / jsynth.DEFAULT_HW[1]
    K[1] *= hw[0] / jsynth.DEFAULT_HW[0]
    return K


@pytest.fixture(scope="module")
def photo_glob(tmp_path_factory):
    """Eight photographs from the JAX package's scenes, and both packages'
    globs pointed at them for the module."""
    hw = (120, 160)
    scenes = [jsynth.BoxScene(seed=401, hw=hw, K=_k(hw)),
              jsynth.CorridorScene(seed=402, hw=hw, K=_k(hw))]
    T = jsynth.make_trajectory(8, speed=1.5, yaw_rate_deg=6.0)
    views = [scenes[i % 2].render(T[i]) for i in range(8)]
    d = str(tmp_path_factory.mktemp("photos"))
    chip_smoke.write_photos(d, views)
    pattern = os.path.join(d, "*")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsynth, "REAL_PHOTO_GLOB", pattern)
        mp.setattr(tsynth, "REAL_PHOTO_GLOB", pattern)
        yield pattern


def test_photo_family_and_its_splits(photo_glob):
    """The family is registered, its default photographs are the even half
    and the training photographs the odd half (plus grace_hopper), as in
    the reference (``tests/test_synth_scenes.py:91``)."""
    assert tsynth.SCENE_FAMILIES["photo"] is tsynth.PhotoScene
    ev, tr = tsynth._default_photo_set(), ttrain.train_photo_paths()
    assert ev == jsynth._default_photo_set()
    assert tr == jtrain.train_photo_paths()
    assert len(ev) == 4 and not set(ev) & set(tr)
    assert set(ev) | set(tr[:4]) == set(glob.glob(photo_glob))
    missing = [os.path.join(os.path.dirname(photo_glob), "none.png")]
    for scene in (jsynth.PhotoScene, lambda **k: tsynth.PhotoScene(
            device="cpu", **k)):
        with pytest.raises(FileNotFoundError, match="failed to load"):
            scene(hw=(8, 8), photos=missing)


def test_photo_scene_renders_like_reference(photo_glob):
    hw = (90, 205)
    ref = jsynth.PhotoScene(seed=3, hw=hw, K=_k(hw))
    port = tsynth.PhotoScene(seed=3, hw=hw, K=_k(hw), device="cpu")
    assert len(port._pyramids) == len(ref._pyramids) == 4
    for a, b in zip(port._pyramids, ref._pyramids):
        np.testing.assert_allclose(a.numpy(), np.stack(b), rtol=0,
                                   atol=1e-9)
    T = jsynth.make_trajectory(30, speed=0.5, yaw_rate_deg=0.5)
    for i in (0, 10, 29):
        img_r, hit_r, t_r = ref.render_with_geometry(T[i])
        img, hit, t = (x.numpy() for x in port.render_with_geometry(T[i]))
        d = np.abs(img.astype(int) - img_r.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (i, d.max())
        np.testing.assert_allclose(hit, hit_r, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(np.isinf(t), np.isinf(t_r))
        fin = np.isfinite(t_r)
        np.testing.assert_allclose(t[fin], t_r[fin], rtol=1e-12, atol=1e-9)


def test_synth_cli_writes_the_photo_sequence(photo_glob, tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    jsynth.generate_kitti_sequence(ref_dir, n_frames=3, hw=(60, 128),
                                   scene="photo")
    assert tsynth.main(["--out", port_dir, "--frames", "3", "--hw", "60",
                        "128", "--scene", "photo", "--device", "cpu"]) == 0
    import cv2
    for name in ("000000.png", "000002.png"):
        a, b = (cv2.imread(os.path.join(d, "kitti", "05", "image_0", name),
                           cv2.IMREAD_GRAYSCALE) for d in (ref_dir, port_dir))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    np.testing.assert_array_equal(
        np.loadtxt(os.path.join(port_dir, "kitti", "poses", "05.txt")),
        np.loadtxt(os.path.join(ref_dir, "kitti", "poses", "05.txt")))


@pytest.mark.parametrize("families", [("boxes",),
                                      ("corridor", "boxes", "photo")])
def test_scene_pool_families_render_like_reference(photo_glob, families):
    kw = dict(n_views=2 * len(families), seed=2, n_scenes=len(families),
              render_hw=(64, 96), families=families)
    ref = jtrain.ScenePairPool((48, 64), cache_dir=None, **kw)
    port = ttrain.ScenePairPool((48, 64), device="cpu", **kw)
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
    # the same draws give the same pairs
    r_ref, r_port = np.random.default_rng(4), np.random.default_rng(4)
    want, got = ref.batch(r_ref, 3, 16), port.batch(r_port, 3, 16)
    for k in ("pts0", "pt_valid", "warp_valid"):
        np.testing.assert_array_equal(got[k], want[k])
    assert r_ref.random() == r_port.random()


def test_photo_pair_pool_follows_reference_draws(photo_glob):
    paths = jtrain.train_photo_paths()
    ref = jtrain.PhotoPairPool((48, 64), paths, seed=0)
    port = ttrain.PhotoPairPool((48, 64), ttrain.train_photo_paths(),
                                seed=0, device="cpu")
    assert len(port.imgs) == len(ref.imgs) >= 4
    for a, b in zip(port.imgs, ref.imgs):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    port.imgs = ref.imgs          # the batches below from the same pixels
    for seed in (0, 1):
        r_ref, r_port = (np.random.default_rng(seed) for _ in range(2))
        want, got = ref.batch(r_ref, 4, 24), port.batch(r_port, 4, 24)
        assert got["pt_valid"].sum() > 0
        for k in ("img0", "pts0", "pt_valid"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["img1"], want["img1"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(got["pts1"], want["pts1"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got["warp01"], want["warp01"], rtol=0,
                                   atol=1e-4)
        diff = got["warp_valid"] != want["warp_valid"]
        if diff.any():
            u = want["warp01"][diff]
            edge = np.minimum(np.abs(u - 6), np.abs(u - np.array(
                [64 - 6, 48 - 6]))).min(-1)
            assert edge.max() <= 1e-6
        assert r_ref.random() == r_port.random()
        # the augmentation that follows consumes alike too
        a = jtrain.photometric_augment(r_ref, want)
        b = ttrain.photometric_augment(r_port, got)
        np.testing.assert_allclose(b["img0"], a["img0"], rtol=0, atol=1e-6)
        assert r_ref.random() == r_port.random()


def test_train_frontend_mix_picks_the_reference_pools(photo_glob, tmp_path,
                                                     monkeypatch):
    """One seed, the same pool at every step: the port's ``main`` (its
    step replaced by a stub, the mix is the point) against the reference's
    loop replayed on its own pools and draws."""
    steps, real_frac, scene_frac = 14, 0.3, 0.5
    argv = ["--device", "cpu", "--batch", "1", "--hw", "48", "64",
            "--points", "8", "--scene_views", "2", "--scenes", "2",
            "--render_hw", "64", "96", "--families", "boxes,photo",
            "--real_frac", str(real_frac), "--scene_frac", str(scene_frac),
            "--steps", str(steps), "--seed", "3",
            "--out", str(tmp_path / "w.npz")]

    def stub_step(tx, hw):
        zero = {k: torch.zeros(()) for k in
                ("total", "desc", "match", "rep", "peak", "sig")}
        return lambda state, batch: (state, zero)

    monkeypatch.setattr(ttrain, "make_train_step", stub_step)
    hist = []
    assert train_frontend.main(argv, history=hist) == 0
    got = [r["source"] for r in hist]

    pool = jtrain.ScenePairPool((48, 64), n_views=2, seed=3,
                                render_hw=(64, 96), n_scenes=2,
                                families=("boxes", "photo"), cache_dir=None)
    photo = jtrain.PhotoPairPool((48, 64), jtrain.train_photo_paths(),
                                 seed=3)
    rng = np.random.default_rng(3 + 2)
    want = []
    for _ in range(steps):
        u = rng.random()
        if u < real_frac:
            want.append("photo")
            batch = photo.batch(rng, 1, 8)
        elif u < real_frac + (1.0 - real_frac) * scene_frac:
            want.append("scene")
            batch = pool.batch(rng, 1, 8)
        else:
            want.append("synthetic")
            batch = {"img0": np.zeros((1, 48, 64, 1), np.float32),
                     "img1": np.zeros((1, 48, 64, 1), np.float32)}
        jtrain.photometric_augment(rng, batch)
    assert got == want
    assert set(got) == {"photo", "scene", "synthetic"}


if __name__ == "__main__":
    # The CPU readings that phase 11 of chip_smoke.py holds the card to,
    # on the smoke's photographs (chip_smoke.photo_views at 480x640,
    # rendered by the port on the CPU, written by chip_smoke.write_photos):
    #   --slam: the JAX package's ORB host run (run_slam's defaults) over
    #     the 40-frame photo sequence at 376x1232, one line per RANSAC seed;
    #   --real_eval: the port's real_eval --compare on the CPU (8
    #     photographs, 2 warps each, 1024 keypoints, the trained tree).
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_photo.py \
    #       --slam --seeds 0,1,2,3
    import argparse
    import contextlib
    import io
    import json
    import logging
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument("--slam", action="store_true")
    ap.add_argument("--real_eval", action="store_true")
    ap.add_argument("--seeds", default="0,1,2,3")
    a = ap.parse_args()
    logging.disable(logging.CRITICAL)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        photos = chip_smoke.write_photos(
            os.path.join(tmp, "photos"),
            chip_smoke.photo_views(chip_smoke.PHOTO_HW, "cpu"))
        pattern = os.path.join(tmp, "photos", "*")
        jsynth.REAL_PHOTO_GLOB = tsynth.REAL_PHOTO_GLOB = pattern
        if a.slam:
            from simpleslam_tpu.config import parse_config as jparse
            from simpleslam_tpu.run_slam import run as jrun
            base = os.path.join(tmp, "seq")
            jsynth.generate_kitti_sequence(
                base, n_frames=chip_smoke.PHOTO_FRAMES,
                hw=chip_smoke.PHOTO_SEQ_HW, scene="photo")
            for seed in map(int, a.seeds.split(",")):
                r = jrun(jparse(["--dataset", "kitti", "--base_dir", base,
                                 "--headless", "--no_viz3d", "--seed",
                                 str(seed)]))
                print(json.dumps({"seed": seed, "lost": r.tracking_lost_count,
                                  "keyframes": r.n_keyframes,
                                  "ate_m": r.ate,
                                  "posed": len(r.poses_cw)}), flush=True)
        if a.real_eval:
            from simpleslam_tpu_torch.tools import real_eval as tre
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                tre.main(chip_smoke.REAL_EVAL_ARGV + ["--glob", pattern,
                                                      "--device", "cpu"])
            print(out.getvalue().strip().splitlines()[-1], flush=True)
