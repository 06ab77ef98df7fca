"""The slice as a whole with the default ORB front-end, and the CLI: the
port's ``run_slam.run``/``main`` over KITTI-layout sequences written by the
reference's ``tools/synth``, on the CPU (the ORB follow run, which holds
the port's back half to the reference's frame by frame, is in
``tests/test_torch_orb.py``).

* the port's own ``run`` on ``test_e2e.py``'s fixture meets that test's
  bounds, and its ``--fused`` run meets ``test_fused.py``'s
  host-against-fused bounds on that test's fixture (the chaotic part over
  RANSAC seeds, see the test);
* ``main`` returns 0, a run without ``--device`` needs CUDA, the live run
  (without ``--headless``) gives the headless run's frames, and the
  saved-state flags are refused or run as in the reference.
"""
import os

import numpy as np
import pytest
import torch

from simpleslam_tpu.tools.synth import generate_kitti_sequence
from simpleslam_tpu_torch import run_slam
from simpleslam_tpu_torch.config import SLAMConfig, parse_config
from simpleslam_tpu_torch.tools.fused_vs_host import compare_runs

E2E = dict(max_features=512, kf_min_inliers=40, pnp_min_inliers=15)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def e2e_base(tmp_path_factory):
    """``tests/test_e2e.py``'s fixture."""
    base = str(tmp_path_factory.mktemp("synth"))
    generate_kitti_sequence(base, n_frames=18, seed=3, hw=(180, 410),
                            speed=0.5, yaw_rate_deg=0.3)
    return base


@pytest.fixture(scope="module")
def fused_base(tmp_path_factory):
    """``tests/test_fused.py``'s fixture."""
    base = str(tmp_path_factory.mktemp("fused_seq"))
    generate_kitti_sequence(base, n_frames=16, seed=7, hw=(180, 410),
                            speed=0.5, yaw_rate_deg=0.3)
    return base


def test_run_meets_e2e_bounds(e2e_base, tmp_path, monkeypatch):
    """``test_e2e.py::test_full_pipeline_on_synthetic_corridor``'s bounds,
    with the run's log lines."""
    monkeypatch.chdir(tmp_path)
    logged = []
    monkeypatch.setattr(run_slam.logger, "info",
                        lambda msg, *a: logged.append(msg % a))
    res = run_slam.run(SLAMConfig(dataset="kitti", base_dir=e2e_base,
                                  headless=True, no_viz3d=True, **E2E),
                       device="cpu")
    assert isinstance(res, run_slam.SLAMResult)
    assert res.n_frames == 18
    assert res.n_keyframes >= 2
    assert res.n_landmarks >= 80
    assert os.path.exists("trajectory_kitti.png")
    assert len(res.poses_cw) >= 10
    assert res.ate is not None and res.ate < 2.0
    assert res.kf_frames[:2] == res.frame_ids[:2]
    assert any(m.startswith("ATE-RMSE (Sim3): ") for m in logged)
    assert any(m.startswith("done: 18 frames") for m in logged)
    report = next(m for m in logged if m.startswith("per-stage breakdown"))
    assert "host-gap" in report and "extract" in report and "/s" in report


def _host_fused_stats(run, parse_config, base, seed, **run_kw):
    """One host and one ``--fused`` run of ``test_fused.py``'s argv at
    RANSAC ``seed`` -> (host result, fused result, the statistics its
    bounds read: ``tools/fused_vs_host.compare_runs``)."""
    def argv(fused):
        return (["--dataset", "kitti", "--base_dir", base, "--headless",
                 "--no_viz3d", "--max_features", "512", "--map_capacity",
                 "2048", "--tri_kf2", "--seed", str(seed)]
                + (["--fused"] if fused else []))
    res_host = run(parse_config(argv(False)), **run_kw)
    res_fused = run(parse_config(argv(True)), **run_kw)
    return res_host, res_fused, compare_runs(res_host, res_fused)


def test_fused_run_meets_host_bounds(fused_base, tmp_path, monkeypatch):
    """``test_fused.py::test_fused_matches_host``'s bounds on the port's
    host and ``--fused`` ORB runs. Per seed: the same keyframes, one pose
    per frame, no frame lost, the poses before the first keyframe after
    the bootstrap within 0.02 m. After it the fixture is chaotic (ATE
    0.4-0.7 m in both packages, and the port's readings move with the
    thread count): over RANSAC seeds 0-3 the reference's own pair meets
    the bounds on the Sim(3)-aligned shape at seeds 0 and 3 only (median
    0.13, 0.32, 0.68, 0.39 m; |s - 1| 0.09, 0.19, 0.23, 0.01; the script
    at the end of this file prints them), so those bounds and the ATE
    band hold the median over seeds 0-3."""
    monkeypatch.chdir(tmp_path)
    stats = []
    for seed in range(4):
        res_host, res_fused, st = _host_fused_stats(
            run_slam.run, parse_config, fused_base, seed, device="cpu")
        assert res_fused.ate is not None and res_host.ate is not None
        assert st["same_keyframes"]
        assert st["common"] == res_fused.n_frames
        assert st["n_pre_kf"] >= 3
        assert st["pre_kf"] < 0.02, st
        assert res_fused.tracking_lost_count == 0
        assert len(res_fused.poses_cw) == res_fused.n_frames
        stats.append(st)
    med = {k: float(np.median([st[k] for st in stats]))
           for k in ("median", "max", "scale_gap", "ate_gap", "landmarks")}
    assert med["median"] < 0.6, stats
    assert med["max"] < 2.0, stats
    assert med["scale_gap"] < 0.15, stats
    assert med["ate_gap"] < 1.0, stats
    assert med["landmarks"] > 0.5, stats


def test_stage_all_runs_the_prefetched_loop(fused_base, tmp_path,
                                            monkeypatch):
    """``--stage_all`` (every frame decoded and uploaded before the fused
    loop) runs the loop that the ``Prefetcher`` feeds: the same poses,
    keyframes and map."""
    monkeypatch.chdir(tmp_path)
    logged = []
    monkeypatch.setattr(run_slam.logger, "info",
                        lambda msg, *a: logged.append(msg % a))
    argv = ["--dataset", "kitti", "--base_dir", fused_base, "--headless",
            "--no_viz3d", "--max_features", "512", "--map_capacity", "2048",
            "--tri_kf2", "--fused"]
    fed = run_slam.run(parse_config(argv), device="cpu")
    assert not any(m.startswith("[FUSED] staging") for m in logged)
    staged = run_slam.run(parse_config(argv + ["--stage_all"]), device="cpu")
    assert any(m.startswith("[FUSED] staging") for m in logged)
    assert staged.frame_ids == fed.frame_ids == list(range(16))
    assert staged.kf_frames == fed.kf_frames
    assert staged.n_landmarks == fed.n_landmarks
    np.testing.assert_array_equal(np.stack(staged.poses_cw),
                                  np.stack(fed.poses_cw))


def test_main_returns_zero_and_needs_a_device(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = str(tmp_path / "seq")
    generate_kitti_sequence(base, n_frames=6, seed=2, hw=(128, 256))
    argv = ["--dataset", "kitti", "--base_dir", base, "--headless",
            "--no_viz3d", "--max_features", "256"]
    results = []
    assert run_slam.main(argv + ["--device", "cpu"], results=results) == 0
    assert len(results) == 1 and results[0].n_frames == 6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_slam.main(argv)


@pytest.mark.parametrize("change, error", [
    (dict(localize_only=True), "resume"),
    (dict(localize_only=True, resume="state.npz", fused=True,
          loop_closure=True), "fused"),
    (dict(localize_only=True, resume="state.npz",
          save_state="again.npz"), "save_state"),
    (dict(resume="state.npz"), None)])
def test_state_flags_behave_as_reference(change, error, tmp_path,
                                         monkeypatch):
    """The reference's refusals of ``--localize_only`` without
    ``--resume``, with ``--fused`` and with ``--save_state`` (ValueError,
    before any frame is read), and a ``--resume`` that runs: a 6-frame map
    saved, then resumed over the 8-frame sequence it starts."""
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "kitti", "--headless", "--no_viz3d",
            "--max_features", "256", "--map_capacity", "2048"]
    if error is not None:
        cfg = parse_config(argv + ["--base_dir", str(tmp_path / "none")])
        for k, v in change.items():
            setattr(cfg, k, v)
        with pytest.raises(ValueError, match=error):
            run_slam.run(cfg, device="cpu")
        return
    bases = {}
    for n in (6, 8):
        bases[n] = str(tmp_path / f"seq{n}")
        generate_kitti_sequence(bases[n], n_frames=n, seed=2, hw=(128, 256))
    state = str(tmp_path / "state.npz")
    first = run_slam.run(parse_config(argv + ["--base_dir", bases[6],
                                              "--save_state", state]),
                         device="cpu")
    assert os.path.exists(state) and first.frame_ids[-1] == 5
    res = run_slam.run(parse_config(argv + ["--base_dir", bases[8],
                                            "--resume", state]),
                       device="cpu")
    assert res.frame_ids[:len(first.frame_ids)] == first.frame_ids
    assert res.frame_ids[len(first.frame_ids):] == [6, 7]


if __name__ == "__main__":
    # Host against --fused on test_fused.py's fixture, per RANSAC seed:
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_cli.py \
    #       [--reference] [--seeds 0,1,2,3]
    import argparse
    import logging
    import tempfile
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", action="store_true",
                    help="the JAX package's runs instead of the port's")
    ap.add_argument("--seeds", default="0,1,2,3")
    a = ap.parse_args()
    logging.disable(logging.CRITICAL)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        generate_kitti_sequence(tmp, n_frames=16, seed=7, hw=(180, 410),
                                speed=0.5, yaw_rate_deg=0.3)
        if a.reference:
            from simpleslam_tpu.config import parse_config as jparse
            from simpleslam_tpu.run_slam import run as jrun
            runner, parser, kw = jrun, jparse, {}
        else:
            runner, parser, kw = run_slam.run, parse_config, {"device": "cpu"}
        for seed in map(int, a.seeds.split(",")):
            h, f, st = _host_fused_stats(runner, parser, tmp, seed, **kw)
            print(f"seed {seed}: same keyframes {f.kf_frames == h.kf_frames}"
                  f", ATE host {h.ate:.3f} fused {f.ate:.3f}, " + ", ".join(
                      f"{k} {v:.3f}" for k, v in st.items()), flush=True)
