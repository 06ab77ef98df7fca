"""The ``custom`` video dataset and the webcam grabber against the JAX
package's, on the CPU (cv2 writes and reads ``mp4v``; no camera, no
display):

* the test writes its own ``custom/custom_compress.mp4`` and
  ``custom/calibration.pkl``; both packages' ``Sequence.load`` give equal
  frames, equal K and no ground truth, and the port's ``run`` tracks over
  the video (ORB, host);
* without cv2 the port refuses the video as the reference does;
* ``tools.get_images`` with a fake ``VideoCapture`` and a key script saves
  and prints what the reference's saves and prints.

One process, one torch thread: ~10 s.
"""
import builtins
import contextlib
import io
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from simpleslam_tpu.data import dataloader as jdl  # noqa: E402
from simpleslam_tpu.tools import get_images as j_get  # noqa: E402
from simpleslam_tpu_torch import run_slam  # noqa: E402
from simpleslam_tpu_torch.config import parse_config  # noqa: E402
from simpleslam_tpu_torch.data import dataloader  # noqa: E402
from simpleslam_tpu_torch.tools import get_images  # noqa: E402
from simpleslam_tpu_torch.tools.synth import (DEFAULT_K,  # noqa: E402
                                              CorridorScene, make_trajectory)

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

HW = (180, 410)
N_FRAMES = 10


def _K():
    K = DEFAULT_K.copy()
    K[0] *= HW[1] / 1232.0
    K[1] *= HW[1] / 1232.0
    K[1, 2] = 0.487 * HW[0]
    return K


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """``<base>/custom/custom_compress.mp4`` (the corridor, BGR, mp4v) and
    ``calibration.pkl`` (K, D) -> (base, the frames written)."""
    base = tmp_path_factory.mktemp("custom_base")
    os.makedirs(base / "custom")
    scene = CorridorScene(seed=2, hw=HW, K=_K(), device="cpu")
    T = make_trajectory(N_FRAMES, speed=0.5, yaw_rate_deg=0.3)
    frames = [cv2.cvtColor(scene.render(T[i]).numpy(), cv2.COLOR_GRAY2BGR)
              for i in range(N_FRAMES)]
    w = cv2.VideoWriter(str(base / "custom" / "custom_compress.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                        (HW[1], HW[0]))
    assert w.isOpened(), "cv2 has no mp4v writer"
    for f in frames:
        w.write(f)
    w.release()
    with open(base / "custom" / "calibration.pkl", "wb") as f:
        pickle.dump((_K(), np.zeros(5)), f)
    return str(base), frames


def _args(base):
    return SimpleNamespace(dataset="custom", base_dir=base)


def test_custom_video_loads_as_reference(video):
    base, written = video
    port = dataloader.Sequence.load(_args(base))
    ref = jdl.Sequence.load(_args(base))
    assert len(port) == len(ref) == N_FRAMES
    for i in range(N_FRAMES):
        f = port.frame(i)
        assert f.shape == HW + (3,) and f.dtype == np.uint8
        np.testing.assert_array_equal(f, ref.frame(i))
        # lossy, but the corridor it was made from
        assert np.abs(f.astype(int) - written[i]).mean() < 8.0
    np.testing.assert_array_equal(port.K, ref.K)
    np.testing.assert_allclose(port.K, _K())
    assert port.gt is None and ref.gt is None
    assert port.D is None
    # in-memory frames: the readahead gets no paths
    pf = dataloader.Prefetcher(port, start=1)
    try:
        assert pf._native is None
        assert [i for i, _ in pf] == list(range(1, N_FRAMES))
    finally:
        pf.close()


def test_custom_video_run(video, tmp_path, monkeypatch):
    """``run_slam --dataset custom`` (ORB, host) tracks every frame of the
    video after its bootstrap; there is no ground truth, so no ATE."""
    monkeypatch.chdir(tmp_path)
    base, _ = video
    res = run_slam.run(parse_config(
        ["--dataset", "custom", "--base_dir", base, "--headless",
         "--no_viz3d", "--max_features", "512", "--map_capacity", "2048"]),
        device="cpu")
    assert res.n_frames == N_FRAMES
    assert res.frame_ids and res.frame_ids[-1] == N_FRAMES - 1
    assert res.n_keyframes >= 2 and res.ate is None
    assert np.isfinite(np.stack(res.poses_cw)).all()


def test_custom_video_needs_cv2(video, monkeypatch):
    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="requires cv2"):
        dataloader.load_sequence(_args(video[0]))


class FakeCapture:
    """A camera of ``n`` seeded frames."""

    def __init__(self, n):
        rng = np.random.default_rng(4)
        self.frames = [rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
                       for _ in range(n)]
        self.released = False

    def isOpened(self):
        return not self.released

    def read(self):
        if not self.frames:
            return False, None
        return True, self.frames.pop(0)

    def release(self):
        self.released = True


@pytest.mark.parametrize("keys, n_frames", [
    ([-1, 32, -1, 32, 32, 27], 8),     # three saves, then ESC
    ([32, -1, 32], 3)])                # the camera runs out
def test_get_images_as_reference(keys, n_frames, tmp_path, monkeypatch):
    got = {}
    for name, mod in (("jax", j_get), ("torch", get_images)):
        script = list(keys)
        shown = []
        monkeypatch.setattr(cv2, "VideoCapture",
                            lambda cam: FakeCapture(n_frames))
        monkeypatch.setattr(cv2, "waitKey",
                            lambda d: script.pop(0) if script else -1)
        monkeypatch.setattr(cv2, "imshow",
                            lambda win, img: shown.append(win))
        monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
        out = tmp_path / name
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main(["--out", str(out), "--camera", "1"]) == 0
        files = sorted(os.listdir(out))
        got[name] = (buf.getvalue().replace(str(out), "OUT"), files,
                     [cv2.imread(str(out / f)) for f in files], shown)
    (jt, jf, ji, js), (tt, tf, ti, ts) = got["jax"], got["torch"]
    assert tt == jt and tf == jf and ts == js
    assert len(tf) == sum(k == 32 for k in keys[:n_frames])
    assert tt.endswith(f"{len(tf)} images saved\n")
    for a, b in zip(ti, ji):
        np.testing.assert_array_equal(a, b)
