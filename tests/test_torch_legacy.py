"""The legacy drivers of the port (``legacy/run_ef.py``,
``legacy/run_klt.py``) against the JAX package's on the CPU: the E/H
tracker's helpers, its lateral-motion case, both trackers over the first
five frames of ``tests/test_legacy.py``'s 8-frame corridor (160x360), as
that file's tests run them, with the reference's RANSAC draws injected,
and both CLIs on a tiny ``tools.synth`` sequence.
"""
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.config import SLAMConfig as JConfig
from simpleslam_tpu.core import frontend as jfrontend
from simpleslam_tpu.core.types import Features as JFeatures
from simpleslam_tpu.data import Sequence as JSequence
from simpleslam_tpu.legacy import run_ef as jef
from simpleslam_tpu.legacy.run_klt import KLTTracker as JKLTTracker
from simpleslam_tpu.ops import klt as jklt
from simpleslam_tpu.ops import se3 as jse3
from simpleslam_tpu.tools.synth import generate_kitti_sequence
from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.data import Sequence
from simpleslam_tpu_torch.legacy import run_ef, run_klt
from test_torch_slam import JaxKey, _ReferenceFilter, _to_torch

cv2 = pytest.importorskip("cv2")

# Pose entries, max |T_cw| gap over the chained frames. Fed the
# reference's features, tracks and F-RANSAC match filter, the port's
# trackers read <= 1.7e-5 (E/H) and 4.0e-4 (KLT: the essential matrix's
# float32 Sampson polish from equal inputs moves the unit translation by
# ~1e-4 a frame) on the CPU: FOLLOW_POSE_TOL. With their own features (equal
# to ~7e-5 px), tracks (~1e-3 px) and filter, the 8-point refits (the
# smallest eigenvector of a float32 Gram matrix, ill-conditioned in
# forward motion; tests/test_torch_slam.py's module docstring) move a few
# F-filter inliers, or the weighted essential refit from the same RANSAC
# inliers: the E/H tracker's homography rotation moved by up to 4e-3 a
# frame (gap 3.4e-3), the KLT tracker's unit translation by 0.035 at one
# frame (gap 0.033), every decision equal: POSE_TOL.
FOLLOW_POSE_TOL = 1e-3
N_STEPPED = 5              # frames 0-4, as tests/test_legacy.py steps
POSE_TOL = 5e-2
PARALLAX_TOL_DEG = 0.05   # arccos of a float32 dot near 1 is ill-conditioned


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("legacy"))
    generate_kitti_sequence(base, n_frames=8, seed=5, hw=(160, 360),
                            speed=0.5)
    return base


def _key(seed=0):
    return JaxKey(jax.random.PRNGKey(seed))


def _rotation_case(seed):
    """Pixels of 40 points before and after a rotation (plus a little
    translation for ``seed`` 1)."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 180], [0, 500.0, 80], [0, 0, 1]], np.float32)
    R = np.asarray(jse3.so3_exp(jnp.array([0.0, 0.05, 0.01 * seed])))
    X = np.column_stack([rng.uniform(-3, 3, 40), rng.uniform(-2, 2, 40),
                         rng.uniform(4, 9, 40)])
    t = np.array([0.3 * seed, 0.0, 0.0])
    p0 = X @ K.T
    p1 = (X @ R.T + t) @ K.T
    p0 = (p0[:, :2] / p0[:, 2:]).astype(np.float32)
    p1 = (p1[:, :2] / p1[:, 2:]).astype(np.float32)
    mask = rng.random(40) > 0.2
    return K, p0, p1, R.astype(np.float32), mask


@pytest.mark.parametrize("seed", [0, 1])
def test_median_parallax_matches_reference(seed):
    K, p0, p1, R, mask = _rotation_case(seed)
    ref = jef.median_parallax_deg(jnp.asarray(K), jnp.asarray(p0),
                                  jnp.asarray(p1), jnp.asarray(R),
                                  jnp.asarray(mask))
    got = run_ef.median_parallax_deg(*(torch.as_tensor(a) for a in
                                       (K, p0, p1, R, mask)))
    assert abs(got - ref) <= PARALLAX_TOL_DEG, (got, ref)
    if seed == 0:
        assert got < PARALLAX_TOL_DEG    # pure rotation


def test_best_h_decomposition_matches_reference():
    """A plane z = 6 seen from two poses, its exact homography
    K (R + t n^T / d) K^-1: the same candidate, count and (R, t)."""
    rng = np.random.default_rng(3)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = np.column_stack([rng.uniform(-2, 2, 60), rng.uniform(-1.5, 1.5, 60),
                         np.full(60, 6.0)])
    R = np.asarray(jse3.so3_exp(jnp.array([0.02, -0.04, 0.01])), np.float64)
    t = np.array([0.4, 0.05, -0.1])
    H = K @ (R + np.outer(t, [0.0, 0.0, 1.0 / 6.0])) @ np.linalg.inv(K)
    p0 = X @ K.T
    p1 = (X @ R.T + t) @ K.T
    args = [(H / H[2, 2]).astype(np.float32), K.astype(np.float32),
            (p0[:, :2] / p0[:, 2:]).astype(np.float32),
            (p1[:, :2] / p1[:, 2:]).astype(np.float32), np.ones(60, bool)]
    ref = jef.best_h_decomposition(*(jnp.asarray(a) for a in args))
    got = run_ef.best_h_decomposition(*(torch.as_tensor(a) for a in args))
    assert got[2] == ref[2] == 60
    assert np.abs(got[0] - ref[0]).max() <= 1e-4
    assert np.abs(got[1] - ref[1]).max() <= 1e-4
    assert np.abs(got[0] - R).max() <= 1e-3


def test_ef_lateral_motion_matches_reference():
    """``tests/test_legacy.py``'s lateral case through both trackers: the
    full R + t branch, the unit translation along -x, the same pose."""
    rng = np.random.default_rng(0)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1.0]])
    X = np.stack([rng.uniform(-2, 2, 150), rng.uniform(-1.5, 1.5, 150),
                  rng.uniform(4, 7, 150)], 1)
    t = np.array([0.5, 0.0, 0.0])
    p0 = X @ K.T
    p0 = (p0[:, :2] / p0[:, 2:3]).astype(np.float32)
    p1 = (X - t) @ K.T
    p1 = (p1[:, :2] / p1[:, 2:3]).astype(np.float32)
    desc = rng.normal(size=(150, 16)).astype(np.float32)
    q0 = p0 + rng.normal(0, 0.2, p0.shape)
    q1 = p1 + rng.normal(0, 0.2, p1.shape)
    ref = jef.EFTracker(JConfig(headless=True), K)
    ref.step(1, JFeatures.from_arrays(q0, desc, n_pad=256),
             JFeatures.from_arrays(q1, desc, n_pad=256))
    got = run_ef.EFTracker(SLAMConfig(headless=True), K, device="cpu",
                           key=_key())
    got.step(1, Features.from_arrays(q0, desc, n_pad=256),
             Features.from_arrays(q1, desc, n_pad=256))
    assert (got.n_full, got.n_rot_only, got.n_deadreckon) == (1, 0, 0)
    T = got.world_map.poses[-1]
    assert abs(np.linalg.norm(T[:3, 3]) - 1.0) < 0.05 and T[0, 3] < -0.9
    assert np.abs(T - ref.world_map.poses[-1]).max() <= FOLLOW_POSE_TOL


def _pose_gap(ref, got):
    assert len(ref.world_map.poses) == len(got.world_map.poses)
    return max(np.abs(a - b).max() for a, b in
               zip(ref.world_map.poses, got.world_map.poses))


def test_ef_tracker_follows_reference(corridor):
    """The E/H trackers over the corridor with the reference's draws: the
    port with its own ORB features and filter (``port``) and fed the
    reference's features and F-RANSAC filter (``follow``) take the
    reference's rotation-only, full and dead-reckoned updates; poses within
    POSE_TOL and FOLLOW_POSE_TOL."""
    kw = dict(dataset="kitti", base_dir=corridor, max_features=512,
              headless=True)
    jseq = JSequence.load(JConfig(**kw))
    cfg = SLAMConfig(**kw)
    seq = Sequence.load(cfg)
    ref = jef.EFTracker(JConfig(**kw), jseq.K)
    port, follow = (run_ef.EFTracker(cfg, seq.K, device="cpu", key=_key())
                    for _ in range(2))
    jprev = jfrontend.feature_extractor(ref.cfg, jseq.frame(0), ref.detector)
    prev = frontend.feature_extractor(cfg, seq.frame(0), port.detector)
    for i in range(1, N_STEPPED):
        jf = jfrontend.feature_extractor(ref.cfg, jseq.frame(i), ref.detector)
        f = frontend.feature_extractor(cfg, seq.frame(i), port.detector)
        ref.step(i, jprev, jf)
        port.step(i, prev, f)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(frontend, "filter_matches_ransac", _ReferenceFilter())
            follow.step(i, _to_torch(jprev), _to_torch(jf))
        jprev, prev = jf, f
    want = (ref.n_rot_only, ref.n_full, ref.n_deadreckon)
    assert want[0] + want[1] == N_STEPPED - 1 and want[2] == 0
    for got in (port, follow):
        assert (got.n_rot_only, got.n_full, got.n_deadreckon) == want
    assert _pose_gap(ref, port) <= POSE_TOL
    assert _pose_gap(ref, follow) <= FOLLOW_POSE_TOL


class _ReferenceDetector:
    """The reference tracker's ORB detector in the port's signature."""

    def __init__(self, ref):
        self.fn = lambda grey: _to_torch(ref.detector.fn(
            jnp.asarray(grey.numpy())))
        self.device = torch.device("cpu")


def _reference_fb_track(g0, g1, pts, **kw):
    out = jklt.fb_track(*(jnp.asarray(a.numpy()) for a in (g0, g1, pts)),
                        **kw)
    return tuple(torch.as_tensor(np.array(a)) for a in out)


def test_klt_tracker_follows_reference(corridor):
    """The KLT trackers over the corridor with the reference's draws: the
    port with its own ORB seeds and tracks (``port``) and fed the
    reference's seeds and ``fb_track`` (``follow``) take the reference's
    updates and reseeds and keep its tracks; poses within POSE_TOL and
    FOLLOW_POSE_TOL; the overlay."""
    kw = dict(dataset="kitti", base_dir=corridor, max_features=512,
              headless=True)
    jseq = JSequence.load(JConfig(**kw))
    cfg = SLAMConfig(**kw)
    seq = Sequence.load(cfg)
    ref = JKLTTracker(JConfig(**kw), jseq.K, min_tracks=120)
    port, follow = (run_klt.KLTTracker(cfg, seq.K, min_tracks=120,
                                       device="cpu", key=_key())
                    for _ in range(2))
    follow.detector = _ReferenceDetector(ref)
    ref.seed(jseq.frame(0))
    for t in (port, follow):
        t.seed(seq.frame(0))
    assert len(port.pts) == len(ref.pts) > 100
    for i in range(1, N_STEPPED):
        ref.step(jseq.frame(i - 1), jseq.frame(i))
        port.step(seq.frame(i - 1), seq.frame(i))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(run_klt, "fb_track", _reference_fb_track)
            follow.step(seq.frame(i - 1), seq.frame(i))
        assert len(port.pts) == len(follow.pts) == len(ref.pts), i
    want = (ref.n_rot_only, ref.n_full, ref.n_reseed)
    assert want[0] + want[1] >= N_STEPPED - 2
    for got in (port, follow):
        assert (got.n_rot_only, got.n_full, got.n_reseed) == want
        assert np.array_equal(got.track_ids, ref.track_ids)
    assert np.abs(port.pts - ref.pts).max() <= 1e-2
    assert np.abs(follow.pts - ref.pts).max() <= 1e-4
    assert _pose_gap(ref, port) <= POSE_TOL
    assert _pose_gap(ref, follow) <= FOLLOW_POSE_TOL
    overlay = port.overlay(seq.frame(N_STEPPED - 1))
    assert overlay.shape == seq.frame(0).shape[:2] + (3,)
    assert max(len(v) for v in port.trails.values()) >= 3


@pytest.mark.parametrize("name", ["run_ef", "run_klt"])
def test_legacy_cli_on_cpu(tmp_path, monkeypatch, caplog, name):
    """``python -m simpleslam_tpu_torch.legacy.<name> --dataset kitti
    --base_dir D --headless --device cpu`` on a 4-frame synth sequence:
    every frame posed, the trajectory plot written, the done line logged.
    Without ``--device`` and without CUDA it raises."""
    from simpleslam_tpu_torch.tools import synth
    base = str(tmp_path / "seq")
    assert synth.main(["--out", base, "--frames", "4", "--hw", "128", "256",
                       "--device", "cpu"]) == 0
    monkeypatch.chdir(tmp_path)
    mod = run_ef if name == "run_ef" else run_klt
    argv = ["--dataset", "kitti", "--base_dir", base, "--headless",
            "--max_features", "512"]
    with caplog.at_level(logging.INFO):
        assert mod.main(argv + ["--device", "cpu"]) == 0
    suffix = "ef" if name == "run_ef" else "klt"
    assert os.path.isfile(tmp_path / f"trajectory_kitti_{suffix}.png")
    done = [r.getMessage() for r in caplog.records if " done: " in
            r.getMessage()]
    assert len(done) == 1 and done[0].split(" done: ")[1].startswith(
        "4 poses (4 finite)"), done
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def jax_legacy_readings(base: str, seed: int) -> dict:
    """The JAX package's E/H and KLT trackers over the KITTI-layout
    sequence under ``base`` with RANSAC seed ``seed``, as their ``run``
    drives them (the CLIs' default flags): the update counts."""
    import time
    out = {"seed": seed}
    cfg = JConfig(dataset="kitti", base_dir=base, headless=True, seed=seed)
    seq = JSequence.load(cfg)
    t0 = time.time()
    ef = jef.EFTracker(cfg, seq.K)
    prev = jfrontend.feature_extractor(cfg, seq.frame(0), ef.detector)
    for i in range(1, len(seq)):
        feats = jfrontend.feature_extractor(cfg, seq.frame(i), ef.detector)
        ef.step(i, prev, feats)
        prev = feats
    out["ef"] = {"poses": len(ef.world_map.poses), "rot_only": ef.n_rot_only,
                 "full": ef.n_full, "dead": ef.n_deadreckon,
                 "seconds": time.time() - t0}
    t0 = time.time()
    klt = JKLTTracker(cfg, seq.K)
    klt.seed(seq.frame(0))
    for i in range(1, len(seq)):
        klt.step(seq.frame(i - 1), seq.frame(i))
    n = len(klt.world_map.poses)
    out["klt"] = {"poses": n, "rot_only": klt.n_rot_only,
                  "full": klt.n_full,
                  "dead": n - 1 - klt.n_rot_only - klt.n_full,
                  "reseeds": klt.n_reseed, "seconds": time.time() - t0}
    return out


if __name__ == "__main__":
    # The JAX package's legacy trackers over tools.synth's default corridor
    # (seed 0, 370x1226, the CLIs' 4000 features), per RANSAC seed: the
    # readings phase 10 (e) of chip_smoke.py holds the card to.
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_legacy.py \
    #       --frames 40 --seeds 0,1,2,3
    import argparse
    import json
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", default="0,1,2,3")
    a = ap.parse_args()
    logging.disable(logging.CRITICAL)
    with tempfile.TemporaryDirectory() as tmp:
        generate_kitti_sequence(tmp, n_frames=a.frames, seed=0)
        for s in a.seeds.split(","):
            print(json.dumps(jax_legacy_readings(tmp, int(s))), flush=True)
