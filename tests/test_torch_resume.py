"""Saved state, resume and localisation-only mode through the port's
``run_slam.run``, on the CPU, held to the reference's own tests of them
(``tests/test_driver_extras.py::test_save_then_resume_continues``,
``tests/test_localize.py``) at 180x410 and 512 keypoints:

* the port maps a short sequence with ``save_state`` and resumes it over a
  longer one (the same frames first): the run continues at the frame after
  the saved ``frame_ids[-1]``, keeps the saved poses bit for bit and lands
  near an uninterrupted run;
* ``--resume --localize_only`` tracks against the map frozen (keyframes,
  landmark count and positions bit for bit, no global BA, no descriptor
  ring, keyframe or bootstrap step), the first pose from global
  relocalisation;
* the same two flows against a state that the JAX package mapped (one
  module-scoped JAX run);
* the reference's refusals (``ValueError``), here the state without
  keyframes (the three flag refusals are in ``tests/test_torch_cli.py``).
"""
import os
import sys

import numpy as np
import pytest
import torch

from simpleslam_tpu.tools.synth import generate_kitti_sequence
from simpleslam_tpu_torch import run_slam
from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.utils.serialize import load_state, save_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import recorded_systems  # noqa: E402  (the smoke's, too)

SHORT, FULL = 10, 18
# the reference's fixture settings (tests/test_localize.py), with the map
# capacity of tests/test_driver_extras.py
KW = dict(dataset="kitti", max_features=512, headless=True, no_viz3d=True,
          kf_min_inliers=40, pnp_min_inliers=15, map_capacity=2048)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """``tests/test_localize.py``'s corridor (seed 7): its first SHORT
    frames and all FULL, the same frames first."""
    out = {}
    for name, n in (("short", SHORT), ("full", FULL)):
        base = str(tmp_path_factory.mktemp(name))
        generate_kitti_sequence(base, n_frames=n, seed=7, hw=(180, 410),
                                speed=0.5, yaw_rate_deg=0.3)
        out[name] = base
    return out


def _run(base, **kw):
    with recorded_systems() as made:
        res = run_slam.run(SLAMConfig(base_dir=base, **KW, **kw),
                           device="cpu")
    return res, made[0]


@pytest.fixture(scope="module")
def port_state(seqs, tmp_path_factory):
    """The port's map of the short sequence, saved."""
    path = str(tmp_path_factory.mktemp("port_state") / "state.npz")
    cwd = os.getcwd()
    os.chdir(os.path.dirname(path))
    try:
        res, _ = _run(seqs["short"], save_state=path)
    finally:
        os.chdir(cwd)
    assert res.n_keyframes >= 2 and res.n_landmarks >= 80
    return path, res


@pytest.fixture(scope="module")
def reference_state(seqs, tmp_path_factory):
    """The JAX package's map of the short sequence, saved by its run."""
    from simpleslam_tpu.config import SLAMConfig as JConfig
    from simpleslam_tpu.run_slam import run as jrun
    path = str(tmp_path_factory.mktemp("ref_state") / "state.npz")
    cwd = os.getcwd()
    os.chdir(os.path.dirname(path))
    try:
        res = jrun(JConfig(base_dir=seqs["short"], save_state=path, **KW))
    finally:
        os.chdir(cwd)
    assert res.n_keyframes >= 2 and res.n_landmarks >= 80
    return path, res


def check_resumed(res, system, saved, path, n_frames):
    """The reference's resume checks: the run continues at the frame after
    the saved ``frame_ids[-1]`` to the sequence's end; the mapping run's
    poses (``saved``) are the file's and the resumed system's at its start,
    bit for bit."""
    m, _kfs, _cfg, fids = load_state(path)
    n = len(m.poses)
    np.testing.assert_array_equal(np.stack(m.poses), np.stack(saved))
    np.testing.assert_array_equal(np.stack(system.poses_at_start),
                                  np.stack(saved))
    assert res.frame_ids[:n] == fids
    assert res.frame_ids[n] == fids[-1] + 1
    assert res.frame_ids[-1] == n_frames - 1
    assert len(res.poses_cw) > n
    assert res.ate is not None and res.ate < 2.0


def check_localised(res, system, path, n_frames, logged):
    """``tests/test_localize.py``'s checks, with the frozen map held bit
    for bit: keyframes, landmark count and positions unchanged, no global
    BA, the first pose from global relocalisation near the start, at least
    two thirds of the frames posed (12 of 18 there), at most 4 lost."""
    m, kfs, _cfg, _fids = load_state(path)
    assert res.n_keyframes == len(kfs) == len(system.kfs)
    assert res.n_landmarks == len(m)
    np.testing.assert_array_equal(system.world_map.get_point_array(),
                                  m.get_point_array())
    assert [k.frame_idx for k in system.kfs] == [k.frame_idx for k in kfs]
    assert res.gba_runs == 0
    assert len(res.poses_cw) >= 2 * n_frames / 3
    assert res.frame_ids[0] <= 2
    assert res.tracking_lost_count <= 4
    assert any(msg.startswith("[GRELOC] recovery") for msg in logged)
    first = next(i for i, msg in enumerate(logged)
                 if msg.startswith(("[GRELOC] recovery", "[TRACK]",
                                    "[RELOC]", "[FALLBACK]")))
    assert logged[first].startswith("[GRELOC] recovery")
    assert res.ate is not None and res.ate < 2.0


@pytest.fixture
def log_lines(monkeypatch):
    logged = []
    monkeypatch.setattr(run_slam.logger, "info",
                        lambda msg, *a: logged.append(msg % a))
    return logged


@pytest.mark.parametrize("source, fused", [("port", False),
                                           ("reference", False),
                                           ("port", True)])
def test_resume_continues(source, fused, seqs, request, tmp_path,
                          monkeypatch):
    """``test_save_then_resume_continues`` on the port, from the port's
    state and from the JAX package's, and into the fused loop; the port's
    resumed host run lands within 0.5 m ATE of its uninterrupted run, as
    there."""
    monkeypatch.chdir(tmp_path)
    path, mapped = request.getfixturevalue(f"{source}_state")
    res, system = _run(seqs["full"], resume=path, fused=fused)
    check_resumed(res, system, mapped.poses_cw, path, FULL)
    if source == "port" and not fused:
        whole, _ = _run(seqs["full"])
        assert len(res.poses_cw) == len(whole.poses_cw)
        assert abs(res.ate - whole.ate) < 0.5


@pytest.mark.parametrize("source", ["port", "reference"])
def test_localize_only_tracks_frozen_map(source, seqs, request, tmp_path,
                                         monkeypatch, log_lines):
    """``test_localize_only_tracks_frozen_map`` on the port over the
    mapped frames, against the port's state and the JAX package's; no
    descriptor ring, keyframe or bootstrap step runs."""
    monkeypatch.chdir(tmp_path)
    path, _ = request.getfixturevalue(f"{source}_state")
    writes = []
    for name in ("_refresh_rings", "_maybe_keyframe", "_try_bootstrap"):
        monkeypatch.setattr(run_slam.SLAMSystem, name,
                            lambda *a, name=name: writes.append(name))
    res, system = _run(seqs["short"], resume=path, localize_only=True)
    check_localised(res, system, path, SHORT, log_lines)
    assert writes == []


def test_sigint_stops_after_the_frame_and_saves(seqs, tmp_path, monkeypatch):
    """With ``--save_state``, SIGINT stops the host loop after the frame in
    flight; the state is saved at that frame and the handler before the
    run is back afterwards."""
    import signal
    monkeypatch.chdir(tmp_path)
    before = signal.getsignal(signal.SIGINT)
    process = run_slam.SLAMSystem.process_frame

    def interrupted(self, frame_idx, img, prev):
        out = process(self, frame_idx, img, prev)
        if frame_idx == 4:
            signal.raise_signal(signal.SIGINT)
        return out
    monkeypatch.setattr(run_slam.SLAMSystem, "process_frame", interrupted)
    path = str(tmp_path / "state.npz")
    res, _ = _run(seqs["short"], save_state=path)
    assert res.frame_ids[-1] == 4
    assert load_state(path)[3] == res.frame_ids
    assert signal.getsignal(signal.SIGINT) is before


def test_resumed_state_without_keyframes_raises(seqs, tmp_path, monkeypatch):
    """The reference's refusal of a state with no keyframes to localise
    against."""
    from simpleslam_tpu_torch.core.map import Map
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "empty.npz")
    save_state(path, Map(), [], frame_ids=[])
    with pytest.raises(ValueError, match="no keyframes"):
        _run(seqs["short"], resume=path, localize_only=True)


if __name__ == "__main__":
    # The CLI's saved-state flow at the CLI's defaults (ORB, 370x1226,
    # tools.synth's corridor, seed 0), per RANSAC seed: map the first
    # --map_frames frames with --save_state, --resume over all --frames,
    # then --resume --localize_only over all; the JAX package's readings
    # (--reference) or the port's on the CPU:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_resume.py \
    #       --reference --map_frames 20 --frames 40 --seeds 0,1,2,3
    import argparse
    import json
    import logging
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", action="store_true",
                    help="the JAX package's runs instead of the port's")
    ap.add_argument("--map_frames", type=int, default=20)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seeds", default="0,1,2,3")
    a = ap.parse_args()
    logging.disable(logging.CRITICAL)
    if a.reference:
        from simpleslam_tpu.config import parse_config
        from simpleslam_tpu.run_slam import run
        kw = {}
    else:
        from simpleslam_tpu_torch.config import parse_config
        run, kw = run_slam.run, {"device": "cpu"}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        bases = {}
        for n in (a.map_frames, a.frames):
            bases[n] = os.path.join(tmp, str(n))
            generate_kitti_sequence(bases[n], n_frames=n, seed=0)
        for seed in map(int, a.seeds.split(",")):
            state = os.path.join(tmp, f"state{seed}.npz")

            def go(n, *extra):
                return run(parse_config(["--dataset", "kitti", "--base_dir",
                                         bases[n], "--headless", "--no_viz3d",
                                         "--seed", str(seed), *extra]), **kw)
            mapped = go(a.map_frames, "--save_state", state)
            resumed = go(a.frames, "--resume", state)
            loc = go(a.frames, "--resume", state, "--localize_only")
            print(json.dumps({
                "seed": seed, "map": {"keyframes": mapped.n_keyframes,
                                      "landmarks": mapped.n_landmarks,
                                      "lost": mapped.tracking_lost_count,
                                      "ate_m": mapped.ate},
                "resume": {"next_frame": resumed.frame_ids[
                    len(mapped.frame_ids)], "lost":
                    resumed.tracking_lost_count, "ate_m": resumed.ate,
                    "keyframes": resumed.n_keyframes},
                "localize": {"first_frame": loc.frame_ids[0],
                             "posed": len(loc.poses_cw),
                             "lost": loc.tracking_lost_count,
                             "ate_m": loc.ate, "gba_runs": loc.gba_runs,
                             "keyframes": loc.n_keyframes,
                             "landmarks": loc.n_landmarks}}), flush=True)
