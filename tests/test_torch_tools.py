"""The port's corridor renderer and trajectory evaluation against the JAX
package's.

* renderer: ``CorridorScene.render`` on the CPU against the reference's
  numpy path (its JAX texture path is switched off here) at 64x200 over a
  ``bench.py``-style trajectory; the trajectory must be equal and the
  images identical to the grey level (the uint8 cast of the same float32
  arithmetic);
* evaluation: ``ate_rmse`` (Sim(3), SE(3), none) and ``rte`` against the
  reference's on seeded noisy trajectories, to 1e-9;
* KITTI pose files round-trip.
"""
import numpy as np
import pytest
import torch

import simpleslam_tpu.tools.synth as jsynth
from simpleslam_tpu.core import trajectory_utils as jtraj
from simpleslam_tpu.tools import trajectory_eval as jeval
from simpleslam_tpu.viz.trajectory2d import umeyama_sim3 as j_umeyama
from simpleslam_tpu_torch.core import trajectory_utils
from simpleslam_tpu_torch.tools import synth, trajectory_eval

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _numpy_texture_only():
    raise RuntimeError("reference numpy path")


def test_corridor_render_matches_reference_numpy_path(monkeypatch):
    monkeypatch.setattr(jsynth, "_jax_tex", _numpy_texture_only)
    hw = (64, 200)
    K = jsynth.DEFAULT_K.copy()
    K[0] *= hw[1] / 1232.0
    K[1] *= hw[1] / 1232.0
    K[1, 2] = 0.487 * hw[0]
    T = jsynth.make_trajectory(12, speed=0.5, yaw_rate_deg=0.3)
    assert np.array_equal(T, synth.make_trajectory(12, speed=0.5,
                                                   yaw_rate_deg=0.3))
    ref = jsynth.CorridorScene(seed=0, hw=hw, K=K)
    port = synth.CorridorScene(seed=0, hw=hw, K=K, device="cpu")
    for i in (0, 5, 11):
        want = ref.render(T[i])
        got = port.render(T[i])
        assert got.dtype == torch.uint8 and got.shape == hw
        assert np.array_equal(got.numpy(), want), i
    _img, hit, depth = port.render_with_geometry(T[5])
    _img_r, hit_r, depth_r = ref.render_with_geometry(T[5])
    assert np.allclose(hit.numpy(), hit_r, atol=1e-9)
    assert np.allclose(depth.numpy(), depth_r, atol=1e-9)


def test_render_sequence_is_benchs_sequence(monkeypatch):
    monkeypatch.setattr(jsynth, "_jax_tex", _numpy_texture_only)
    hw = (48, 160)
    frames, T = synth.render_sequence("corridor", 3, hw, jsynth.DEFAULT_K, 4,
                                      speed=0.5, yaw_rate_deg=0.3,
                                      device="cpu")
    scene = jsynth.SCENE_FAMILIES["corridor"](seed=3, hw=hw,
                                              K=jsynth.DEFAULT_K)
    want = np.stack([scene.render(T[i]) for i in range(4)])
    assert frames.shape == (4,) + hw
    assert np.array_equal(frames.numpy(), want)
    assert synth.renderer_version() and len(synth.renderer_version()) == 12


def test_renderer_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth.CorridorScene(hw=(8, 8))


def _noisy(seed, n=60):
    rng = np.random.default_rng(seed)
    gt = jsynth.make_trajectory(n, speed=0.7, yaw_rate_deg=0.8)
    est = np.linalg.inv(gt)                          # T_cw
    est[:, :3, 3] = est[:, :3, 3] * 1.7 + rng.normal(scale=0.05,
                                                     size=(n, 3))
    return est, gt


@pytest.mark.parametrize("align", ["sim3", "se3", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ate_matches_reference(align, seed):
    est, gt = _noisy(seed)
    got, stats = trajectory_eval.ate_rmse(est, gt, align=align)
    want, want_stats = jeval.ate_rmse(est, gt, align=align)
    assert abs(got - want) <= 1e-9
    for k in want_stats:
        assert abs(stats[k] - want_stats[k]) <= 1e-9, k


@pytest.mark.parametrize("delta", [1, 5])
def test_rte_matches_reference(delta):
    est, gt = _noisy(2)
    te, re = trajectory_eval.rte(est, gt, delta=delta)
    te_r, re_r = jeval.rte(est, gt, delta=delta)
    assert np.abs(te - te_r).max() <= 1e-9
    assert np.abs(re - re_r).max() <= 1e-9


def test_kitti_pose_files_round_trip(tmp_path):
    _est, gt = _noisy(3, n=7)
    path = str(tmp_path / "poses.txt")
    trajectory_eval.save_kitti_poses(path, gt)
    assert np.allclose(trajectory_eval.load_kitti_poses(path), gt,
                       atol=1e-12)
    assert np.allclose(jeval.load_kitti_poses(path), gt, atol=1e-12)


def test_alignment_helpers_match_reference():
    est, gt = _noisy(4, n=20)
    R, t = trajectory_utils.compute_gt_alignment(gt)
    Rr, tr = jtraj.compute_gt_alignment(gt)
    assert np.array_equal(R, Rr) and np.array_equal(t, tr)
    pts = gt[:, :3, 3]
    assert np.array_equal(trajectory_utils.apply_alignment(pts, R, t),
                          jtraj.apply_alignment(pts, Rr, tr))
    src = -np.einsum("nji,nj->ni", est[:, :3, :3], est[:, :3, 3])
    for a, b in zip(trajectory_utils.umeyama_sim3(src, pts),
                    j_umeyama(src, pts)):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-12
