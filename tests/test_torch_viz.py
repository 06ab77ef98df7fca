"""The port's visualisation layer and live run against the JAX package's,
on the CPU and without a display (cv2's window calls are replaced by
recorders, so no HighGUI window opens):

* ``viz/windows.py`` (keyframe strip, match overlay, ``TrackBook``) and
  ``viz/visualize_ba.py`` array-equal to the reference's on the fixtures
  of ``tests/test_driver_extras.py`` and ``tests/test_aux.py``, rebuilt
  with the port's types;
* ``run_slam._show_driver_windows`` shows the reference's windows with the
  reference's arrays;
* ``VizUI``'s p / n / q keys poll as the reference's; ``Visualizer3D`` is
  a no-op without open3d, and its colour scale works under numpy 2;
* ``Trajectory2D`` live with the Umeyama fit against the reference's;
* ``run`` without ``--headless`` gives the ``--headless`` run's poses and
  keyframes (also with loop closure and global BA on), a q at frame k stops it after frame k, and ``--viz_ba``
  leaves the poses unchanged.

One process, one torch thread: ~35 s.
"""
import logging

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from simpleslam_tpu.tools.synth import generate_kitti_sequence  # noqa: E402
from simpleslam_tpu_torch import run_slam  # noqa: E402
from simpleslam_tpu_torch.config import parse_config  # noqa: E402

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

N_FRAMES = 12


class Recorder:
    """Stand-ins for cv2's window calls: records what is shown and answers
    ``waitKey`` from a script (then -1)."""

    def __init__(self, keys=()):
        self.shown = []          # (window name, copy of the image)
        self.calls = []          # (function name, window name or delay)
        self.keys = list(keys)

    def install(self, monkeypatch):
        def named(name, *_a):
            self.calls.append(("namedWindow", name))

        def resize(name, *_a):
            self.calls.append(("resizeWindow", name))

        def imshow(name, img):
            self.calls.append(("imshow", name))
            self.shown.append((name, np.array(img)))

        def wait(delay=0):
            self.calls.append(("waitKey", delay))
            return self.keys.pop(0) if self.keys else -1

        def destroy(name):
            self.calls.append(("destroyWindow", name))

        for attr, fn in (("namedWindow", named), ("resizeWindow", resize),
                         ("imshow", imshow), ("waitKey", wait),
                         ("destroyWindow", destroy),
                         ("destroyAllWindows",
                          lambda: self.calls.append(("destroyAll", None)))):
            monkeypatch.setattr(cv2, attr, fn)
        return self

    def names(self):
        return [n for n, _ in self.shown]


# --------------------------------------------------------------------------- #
# window construction
# --------------------------------------------------------------------------- #

def _window_fixture(pkg):
    """``test_driver_extras.py``'s keyframes, features and image in
    ``pkg``'s types ("jax" or "torch")."""
    if pkg == "jax":
        from simpleslam_tpu.core.keyframe import Keyframe, make_thumb
        from simpleslam_tpu.core.types import Features
    else:
        from simpleslam_tpu_torch.core.keyframe import Keyframe, make_thumb
        from simpleslam_tpu_torch.core.types import Features
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (90, 160, 3), dtype=np.uint8)
    feats = Features.from_arrays(
        rng.uniform(0, 80, (16, 2)),
        rng.integers(0, 255, (16, 32)).astype(np.uint8))
    kfs = [Keyframe(i, i * 3, "", feats, np.eye(4),
                    make_thumb(img, (64, 36))) for i in range(3)]
    return img, feats, kfs


def test_windows_equal_reference():
    from simpleslam_tpu.viz import windows as jw
    from simpleslam_tpu_torch.viz import windows as tw
    outs = {}
    for pkg, mod in (("jax", jw), ("torch", tw)):
        img, feats, kfs = _window_fixture(pkg)
        kp = np.asarray(feats.kpts) if pkg == "jax" else feats.kpts.numpy()
        idx = np.arange(16)
        v = np.ones(16, bool)
        v[3] = False
        strip = mod.build_kf_strip(kfs, height=60)
        overlay = mod.build_match_overlay(img, img[:, ::-1], kp, kp + 2.0,
                                          idx, idx[::-1], v)
        tb = mod.TrackBook(max_len=4)
        for s in range(5):
            tb.advance(kp + s, kp + s + 1.0, idx, (idx + s) % 16, v)
        outs[pkg] = (strip, overlay, tb.tracks)
    (js, jo, jt), (ts, to, tt) = outs["jax"], outs["torch"]
    assert ts.shape == (60, 321, 3) and to.shape == (90, 320, 3)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(to, jo)
    assert tt == jt and len(tt) == 15
    # the port takes tensors too
    img, feats, _ = _window_fixture("torch")
    idx = torch.arange(16)
    np.testing.assert_array_equal(
        tw.build_match_overlay(torch.as_tensor(img), img[:, ::-1],
                               feats.kpts, feats.kpts + 2.0, idx,
                               idx.flip(0), torch.as_tensor(v)), jo)


def _ba_fixture(pkg):
    """``test_aux.py::_make_state`` in ``pkg``'s types."""
    if pkg == "jax":
        from simpleslam_tpu.core.keyframe import Keyframe
        from simpleslam_tpu.core.map import Map
        from simpleslam_tpu.core.types import Features
    else:
        from simpleslam_tpu_torch.core.keyframe import Keyframe
        from simpleslam_tpu_torch.core.map import Map
        from simpleslam_tpu_torch.core.types import Features
    rng = np.random.default_rng(0)
    m = Map()
    m.add_pose(np.eye(4), True)
    T1 = np.eye(4)
    T1[0, 3] = -1.0
    m.add_pose(T1, False)
    m.add_pose(T1, True)
    ids = m.add_points(rng.normal(size=(20, 3)) + [0, 0, 6],
                       rng.uniform(0, 1, (20, 3)).astype(np.float32),
                       keyframe_idx=0)
    feats = Features.from_arrays(rng.uniform(0, 100, (32, 2)),
                                 rng.normal(size=(32, 8)).astype(np.float32),
                                 n_pad=64)
    kfs = [Keyframe(0, 0, "a.png", feats, np.eye(4),
                    b"\x5a\x03\x00\x00\x00" + b"xxx"),
           Keyframe(1, 2, "", feats, T1, b"")]
    for j, pid in enumerate(ids[:10]):
        m.points[pid].add_observation(0, j, np.arange(8, dtype=np.float32))
        m.points[pid].add_observation(1, j + 1,
                                      np.arange(8, dtype=np.float32))
    return m, kfs


def test_ba_overlay_equal_reference(caplog):
    from simpleslam_tpu.viz import visualize_ba as jv
    from simpleslam_tpu_torch.viz import visualize_ba as tv
    K = np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]])
    poses_before = {1: np.eye(4)}
    outs = {}
    for pkg, mod in (("jax", jv), ("torch", tv)):
        m, kfs = _ba_fixture(pkg)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="ba"):
            imgs = mod.visualize_ba_window(m, K, kfs, [0, 1], poses_before)
        outs[pkg] = (mod.collect_kf_residuals(m, K, kfs[1], poses_before),
                     imgs, [r.getMessage() for r in caplog.records])
    (jr, ji, jl), (tr, ti, tl) = outs["jax"], outs["torch"]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9)
    assert not np.allclose(tr[1], tr[2])
    assert sorted(ti) == sorted(ji) == [0, 1]
    for k in ti:
        np.testing.assert_array_equal(ti[k], ji[k])
    assert tl == jl and len(tl) == 2


def test_show_driver_windows_equal_reference(monkeypatch):
    from simpleslam_tpu.run_slam import _show_driver_windows as j_show
    from simpleslam_tpu.viz.windows import TrackBook as JBook
    from simpleslam_tpu_torch.viz.windows import TrackBook as TBook
    shown = {}
    for pkg, show, book in (("jax", j_show, JBook),
                            ("torch", run_slam._show_driver_windows, TBook)):
        rec = Recorder().install(monkeypatch)
        img, feats, kfs = _window_fixture(pkg)
        kp = np.asarray(feats.kpts) if pkg == "jax" else feats.kpts.numpy()
        idx = np.arange(16)
        grey = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)

        class System:
            pass
        system = System()
        system.kfs = kfs
        system._last_matches = (img, grey, kp, kp + 1.0, idx, idx,
                                np.ones(16, bool))
        system._trackbook = book()
        system._trackbook.advance(kp, kp + 1.0, idx, idx, np.ones(16, bool))
        show(system)
        shown[pkg] = rec.shown
        assert rec.calls[-1] == ("waitKey", 1)
    assert [n for n, _ in shown["torch"]] == [n for n, _ in shown["jax"]] \
        == ["keyframes", "matches prev->cur", "tracks"]
    for (_, a), (_, b) in zip(shown["torch"], shown["jax"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# the UI, the 3-D viewer, the live trajectory plot
# --------------------------------------------------------------------------- #

def _poll_script(VizUI, keys, monkeypatch):
    rec = Recorder(keys).install(monkeypatch)
    ui = VizUI(enabled=True)
    got = []
    for _ in range(4):
        got.append((ui.poll(), ui.paused, ui.quit))
    ui.close()
    return got, rec.calls


@pytest.mark.parametrize("keys", [
    [ord("p"), -1, -1, ord("n"), -1, ord("p"), 27],
    [-1, ord("q"), -1],
    [ord("p"), ord("n"), ord("n"), ord("p"), -1, ord("q")]])
def test_vizui_keys_as_reference(keys, monkeypatch):
    """p pauses (polling blocks until n steps or p resumes), q and Esc
    quit, and the ghost window is made and destroyed as in the
    reference."""
    from simpleslam_tpu.viz.ui import VizUI as JUI
    from simpleslam_tpu_torch.viz import VizUI
    port = _poll_script(VizUI, keys, monkeypatch)
    ref = _poll_script(JUI, keys, monkeypatch)
    assert port == ref
    assert port[1][:3] == [("namedWindow", "ui"), ("resizeWindow", "ui"),
                           ("imshow", "ui")]
    assert port[1][-1] == ("destroyWindow", "ui")
    assert VizUI(enabled=False).poll() is True


def test_visualizer3d_noop_and_colours():
    """Without open3d the viewer is a no-op; its colour scale takes
    ``np.ptp`` where the reference's ``ndarray.ptp`` is gone in numpy 2."""
    from simpleslam_tpu.viz.viz3d import Visualizer3D as J3D
    from simpleslam_tpu_torch.viz import Visualizer3D
    from matplotlib import cm
    v = Visualizer3D(enabled=True)
    assert v.enabled is J3D(enabled=True).enabled is False
    assert v.update(np.zeros((4, 3)), None, np.zeros((2, 3))) is None
    v.close()
    pts = np.random.default_rng(0).normal(size=(50, 3))
    for mode, axis in (("z", pts[:, 2]), ("pca", None)):
        cols = Visualizer3D._colors_by_axis(pts, mode)
        assert cols.shape == (50, 3) and np.isfinite(cols).all()
        if axis is not None:
            want = cm.turbo((axis - axis.min()) / np.ptp(axis))[:, :3]
            np.testing.assert_allclose(cols, want)
    assert Visualizer3D._colors_by_axis(np.zeros((0, 3)), "z").shape == (0, 3)
    if not hasattr(np.ndarray, "ptp"):
        with pytest.raises(AttributeError):
            J3D._colors_by_axis(pts, "z")


def test_umeyama_sim3_as_reference():
    from simpleslam_tpu.viz.trajectory2d import umeyama_sim3 as j_ume
    from simpleslam_tpu_torch.viz.trajectory2d import umeyama_sim3
    src = np.random.default_rng(3).normal(size=(30, 3))
    dst = 1.7 * src[:, ::-1] + 0.3
    for a, b in zip(umeyama_sim3(src, dst), j_ume(src, dst)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_trajectory2d_live_umeyama_as_reference(tmp_path):
    """The same pushes give the same aligned estimate in both packages
    (live, Umeyama on: the default alignment below ten poses, the fit
    from then on), and the live plot draws and saves under Agg."""
    from simpleslam_tpu.viz.trajectory2d import Trajectory2D as JT
    from simpleslam_tpu_torch.viz import Trajectory2D
    gt = np.tile(np.eye(4), (14, 1, 1))
    gt[:, 2, 3] = np.arange(14) * 0.5
    gt[:, 0, 3] = np.sin(np.arange(14) * 0.3)
    rng = np.random.default_rng(5)
    poses = []
    for i in range(12):
        Tcw = np.linalg.inv(gt[i])
        Tcw[:3, 3] = 0.4 * Tcw[:3, 3] + rng.normal(scale=1e-3, size=3)
        poses.append(Tcw)
    out = []
    for T in (Trajectory2D, JT):
        tr = T(gt, dataset="kitti", live=True, umeyama=True)
        for i in range(9):
            tr.push(i, poses[i])
        tr.draw()
        few = tr._aligned_est()
        assert tr.s == 2.0
        for i in range(9, 12):
            tr.push(i, poses[i])
        tr.draw()
        path = tmp_path / f"{T.__module__}.png"
        tr.save(str(path))
        assert path.stat().st_size > 0
        out.append((few, tr._aligned_est(), tr.s, tr.R, tr.t))
    assert abs(out[0][2] - 2.5) < 0.1          # the fit, not the default
    for a, b in zip(out[0], out[1]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------------------- #
# the live run
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """``tests/test_driver_extras.py``'s sequence (180x410), 12 frames."""
    b = str(tmp_path_factory.mktemp("viz_seq"))
    generate_kitti_sequence(b, n_frames=N_FRAMES, seed=3, hw=(180, 410),
                            speed=0.5, yaw_rate_deg=0.3)
    return b


def _argv(base, *extra):
    return ["--dataset", "kitti", "--base_dir", base, "--no_viz3d",
            "--max_features", "512", "--map_capacity", "2048", *extra]


@pytest.fixture(scope="module")
def headless_runs(base, tmp_path_factory):
    """``get(*flags)``: the ``--headless`` run with ``flags``, made once."""
    import os
    runs = {}

    def get(*flags):
        if flags not in runs:
            cwd = os.getcwd()
            os.chdir(tmp_path_factory.mktemp("headless"))
            try:
                runs[flags] = run_slam.run(
                    parse_config(_argv(base, "--headless", *flags)),
                    device="cpu")
            finally:
                os.chdir(cwd)
        return runs[flags]
    return get


@pytest.fixture(scope="module")
def headless(headless_runs):
    return headless_runs()


def _same_run(a, b):
    assert a.frame_ids == b.frame_ids
    assert a.kf_frames == b.kf_frames
    assert a.n_landmarks == b.n_landmarks
    np.testing.assert_array_equal(np.stack(a.poses_cw), np.stack(b.poses_cw))


@pytest.mark.parametrize("flags", [(), ("--loop_closure", "--gba_enable")])
def test_live_run_equals_headless(base, headless_runs, flags, tmp_path,
                                  monkeypatch):
    """Without ``--headless`` (and with loop closure and global BA on too)
    the run is the headless run, with the live windows shown."""
    monkeypatch.chdir(tmp_path)
    rec = Recorder().install(monkeypatch)
    warned = []
    monkeypatch.setattr(run_slam.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    res = run_slam.run(parse_config(_argv(base, *flags)), device="cpu")
    _same_run(res, headless_runs(*flags))
    assert res.frame_ids[-1] == N_FRAMES - 1
    names = set(rec.names())
    assert {"ui", "keyframes", "matches prev->cur", "tracks"} <= names
    polls = [c for c in rec.calls if c == ("waitKey", 1)]
    assert len(polls) >= 2 * (N_FRAMES - 1)     # windows + UI each frame
    assert rec.calls[-1] == ("destroyWindow", "ui")
    assert not any(w.startswith("viz failed") for w in warned), warned
    assert (tmp_path / "trajectory_kitti.png").exists()


def test_quit_key_stops_after_frame(base, headless, tmp_path, monkeypatch):
    """q at the k-th poll (after frame k) ends the host loop there: the
    run's frames are the headless run's first k + 1."""
    monkeypatch.chdir(tmp_path)
    k = 7
    # each frame: the driver windows' waitKey(1), then the UI's poll
    Recorder([-1] * (2 * k - 1) + [ord("q")]).install(monkeypatch)
    res = run_slam.run(parse_config(_argv(base)), device="cpu")
    assert res.frame_ids[-1] == k
    assert res.frame_ids == headless.frame_ids[:len(res.frame_ids)]
    np.testing.assert_array_equal(
        np.stack(res.poses_cw),
        np.stack(headless.poses_cw[:len(res.poses_cw)]))


def test_viz_ba_leaves_poses_unchanged(base, headless, tmp_path,
                                       monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    Recorder().install(monkeypatch)
    with caplog.at_level(logging.INFO, logger="ba"):
        res = run_slam.run(parse_config(_argv(base, "--headless",
                                              "--viz_ba")), device="cpu")
    _same_run(res, headless)
    viz = [r.getMessage() for r in caplog.records
           if r.getMessage().startswith("[BA viz]")]
    assert viz, "local BA never ran: the overlay was not reached"
