"""``core/bootstrap.py::evaluate_two_view_bootstrap_with_masks`` resolves
its device like every other entry point of the port: ``device="cpu"``
runs on the CPU and agrees with the reference's decision on a two-view
fixture; the default is the GPU and raises without one. ~10 s (the reference's
compile)."""
import numpy as np
import pytest
import torch

from simpleslam_tpu.core import bootstrap as jboot
from simpleslam_tpu_torch.core import bootstrap

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _two_views(n=200, seed=0):
    """``n`` points seen from two poses 1 m apart, pixels with 0.3 px
    noise."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                  rng.uniform(6, 20, n)], 1)
    T1 = np.eye(4)
    T1[0, 3] = -1.0

    def project(T):
        Xc = X @ T[:3, :3].T + T[:3, 3]
        uv = (Xc[:, :2] / Xc[:, 2:]) * 500.0 + [320, 240]
        return uv + rng.normal(scale=0.3, size=uv.shape)
    return K, project(np.eye(4)), project(T1)


def test_cpu_call_agrees_with_reference():
    K, p0, p1 = _two_views()
    dec = bootstrap.evaluate_two_view_bootstrap_with_masks(
        K, p0, p1, bootstrap.InitParams(), device="cpu")
    ref = jboot.evaluate_two_view_bootstrap_with_masks(
        K, p0, p1, jboot.InitParams())
    assert dec is not None and ref is not None
    assert dec.pose.model.name == ref.pose.model.name
    t, t_ref = np.ravel(dec.pose.t), np.ravel(ref.pose.t)
    cos = abs(t @ t_ref) / (np.linalg.norm(t) * np.linalg.norm(t_ref))
    assert cos > 0.999
    np.testing.assert_allclose(dec.pose.R, np.asarray(ref.pose.R),
                               atol=1e-3)
    assert abs(np.mean(dec.inlier_mask) - np.mean(ref.inlier_mask)) < 0.05


def test_default_device_is_the_gpu(monkeypatch):
    K, p0, p1 = _two_views(n=20)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bootstrap.evaluate_two_view_bootstrap_with_masks(K, p0, p1)
    # a call too small to decide still resolves its device first
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bootstrap.evaluate_two_view_bootstrap_with_masks(K, p0[:4], p1[:4])
