"""The host driver's "never kill tracking" catches, as the reference's: any
error from local BA, and any error while a new landmark registers its
observations, is logged and tracking goes on (``simpleslam_tpu/run_slam.py``
catches ``Exception`` around local BA, ``core/triangulate.py`` around the
landmark rollback).

Both run ``chip_smoke.py``'s oracle back half on the CPU over 12 frames
(bootstrap at frame 2, keyframes, one local BA) with the fault injected;
every frame must still be posed, with finite poses.
"""
import logging
import os
import sys

import pytest
import torch

from simpleslam_tpu_torch import run_slam
from simpleslam_tpu_torch.core import map as map_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(n_frames=N_FRAMES):
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.run_oracle_phase("cpu", n_frames=n_frames)


def _all_posed(res):
    return (res["finite"] and res["consistent"] and res["lost"] == 0
            and res["frames_tracked"] == N_FRAMES - 1)


def test_local_ba_assertion_error_keeps_tracking(monkeypatch, caplog):
    calls = []

    def failing_ba(*args, **kwargs):
        calls.append(1)
        raise AssertionError("injected local BA failure")

    monkeypatch.setattr(run_slam, "local_bundle_adjustment", failing_ba)
    with caplog.at_level(logging.WARNING, logger="main"):
        res = _oracle()
    assert calls, "local BA never ran"
    assert _all_posed(res), res
    assert res["local_ba_solves"] == 0
    assert "injected local BA failure" in caplog.text


def test_landmark_rollback_type_error_keeps_tracking(monkeypatch):
    """Every third observation registration of a keyframe after the
    bootstrap pair raises TypeError: those landmarks are rolled back, the
    rest stay, every frame is posed."""
    real = map_mod.MapPoint.add_observation
    count = [0]

    def flaky(self, keyframe_idx, kp_idx, descriptor):
        count[0] += keyframe_idx >= 2
        if keyframe_idx >= 2 and count[0] % 3 == 0:
            raise TypeError("injected registration failure")
        return real(self, keyframe_idx, kp_idx, descriptor)

    monkeypatch.setattr(map_mod.MapPoint, "add_observation", flaky)
    res = _oracle()
    assert count[0] > 30
    assert _all_posed(res), res
    assert res["keyframes"] >= 3 and res["map_points"] > 0, res
