"""The fused loop with the loop closer on, in both packages on the CPU: a
run with periodic syncs and scans that close nothing gives what the run
without the closer gives (kept apart from ``tests/test_torch_loop.py``:
its four SLAM runs take most of a minute)."""
import numpy as np
import pytest
import torch

import jax

from test_torch_slam import JaxKey


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fused_loop_with_closer_and_no_closure_changes_nothing(
        tmp_path_factory, monkeypatch):
    """Fused runs of 24 corridor frames at 180x410 (ORB, 512 keypoints, map
    capacity 2048) with ``--fused_sync_every 8``, with and without
    ``--loop_closure``, in both packages (the port with the reference's
    RANSAC draws, a JaxKey of seed 0). With the closer on, two periodic
    syncs and their scans find no closure and need no rescue, and in each
    package the poses, keyframes and map equal those of its run without
    the closer (the closer only reads the state at those frames). The
    packages agree on the frames posed, the keyframes' frames and the lost
    count; their free-running ORB poses part from the first fused frame on
    (ORB's rounding), so poses are held within each package."""
    from simpleslam_tpu.config import parse_config as jparse
    from simpleslam_tpu.run_slam import run as jrun
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.run_slam import SLAMSystem, run_fused_loop
    from simpleslam_tpu_torch.tools.synth import generate_kitti_sequence
    from simpleslam_tpu_torch.data import Sequence
    n = 24
    base = str(tmp_path_factory.mktemp("corridor24"))
    generate_kitti_sequence(base, n_frames=n, seed=7, hw=(180, 410),
                            speed=0.5, yaw_rate_deg=0.3, device="cpu")
    monkeypatch.chdir(base)             # the reference's run writes its plot
    argv = ["--dataset", "kitti", "--base_dir", base, "--max_features", "512",
            "--map_capacity", "2048", "--fused_sync_every", "8"]
    runs, refs = [], []
    for extra in ([], ["--loop_closure"]):
        cfg = parse_config(argv + extra)
        seq = Sequence.load(cfg)
        frames = [seq.frame(i) for i in range(len(seq))]
        s = SLAMSystem(cfg, seq.K, img_hw=frames[0].shape[:2], device="cpu",
                       key=JaxKey(jax.random.PRNGKey(cfg.seed)))
        prev = s.process_frame(0, frames[0], None)
        i = 1
        while not s.initialised:
            prev = s.process_frame(i, frames[i], prev)
            i += 1
        run_fused_loop(cfg, s, frames[i:], prev, i)
        runs.append(s)
        refs.append(jrun(jparse(argv + extra + ["--fused", "--headless",
                                                "--no_viz3d"])))
    off, on = runs
    assert on.loop_closer is not None and on.loop_closer.closures == []
    assert on.loop_closer._scanned_until == len(on.kfs) >= 4
    assert on.frame_ids == off.frame_ids == list(range(n))
    assert [kf.frame_idx for kf in on.kfs] == [kf.frame_idx for kf in off.kfs]
    np.testing.assert_array_equal(np.stack(on.world_map.poses),
                                  np.stack(off.world_map.poses))
    assert on.world_map.point_ids() == off.world_map.point_ids()
    np.testing.assert_array_equal(on.world_map.get_point_array(),
                                  off.world_map.get_point_array())
    j_off, j_on = refs
    assert j_on.loop_closures == j_off.loop_closures == 0
    assert j_on.frame_ids == j_off.frame_ids == on.frame_ids
    assert j_on.kf_frames == j_off.kf_frames == [kf.frame_idx for kf in on.kfs]
    assert j_on.tracking_lost_count == j_off.tracking_lost_count == \
        on.tracking_lost_count
    np.testing.assert_array_equal(np.stack(j_on.poses_cw),
                                  np.stack(j_off.poses_cw))
    assert j_on.n_landmarks == j_off.n_landmarks
