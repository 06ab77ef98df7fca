"""``tools/sfm.py`` (the offline structure-from-motion batch API) against
the JAX package's on the CPU.

- On ``tests/test_sfm.py``'s fixture (10 corridor frames at 160x1226, ORB
  512, survival 0.4, gap 3, global BA): the port with its own RANSAC
  within the reference test's bounds (at least 4 keyframes, more than 40
  landmarks, ATE below 1 m, RTE rotation below 5 degrees); then the port
  drawing the reference's minimal sets (a ``jax.random`` key behind the
  port's key interface) and fed the reference's F-RANSAC filter: the same
  keyframes, the landmark count within 10%, ATE at most max(2 x the
  reference's, 0.05 m), and the checkpoint PNG written. The survival
  ratio sits near its 0.4 gate, where the F filter's float refit decides
  the keyframes (``tests/test_torch_legacy.py`` feeds its trackers the
  reference's filter for the same reason); the keypoints differ by up to
  6e-5 px, enough to move the essential matrix's inlier set by one match
  and the chained poses by ~0.1 m at the 3-frame gaps.
- With a 4-rank ``gloo`` mesh (``tests/torch_parallel_ranks.py``, once per
  module) against the same run without one on
  ``tests/test_parallel.py``'s 6-frame corridor at 96x160, ORB and the
  learned front-end (trained weights): the same keyframes and keypoints
  within 0.1 px (the reference test's tolerance) with the same valid
  masks; every rank returned the same.
- ``tools/sfm_sweep.py``'s mode table and its key that draws on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.config import SLAMConfig as JConfig
from simpleslam_tpu.core import frontend as jfrontend
from simpleslam_tpu.core.types import Features as JFeatures
from simpleslam_tpu.core.types import Matches as JMatches
from simpleslam_tpu.tools.sfm import StructureFromMotion as JSfM
from simpleslam_tpu.tools.synth import (DEFAULT_K, CorridorScene,
                                        make_trajectory)
from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core import frontend as tfrontend
from simpleslam_tpu_torch.core.types import Matches
from simpleslam_tpu_torch.tools.sfm import StructureFromMotion

import torch_parallel_ranks as R

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


class JaxKey:
    """The port's key interface backed by ``jax.random``."""

    def __init__(self, key):
        self.key = key

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, int(data)))

    def split(self, num=2):
        return tuple(JaxKey(k) for k in jax.random.split(self.key, num))

    def randint(self, shape, high, device):
        r = jax.random.randint(self.key, tuple(shape), 0,
                               jnp.maximum(jnp.int32(int(high)), 1))
        return torch.as_tensor(np.array(r), dtype=torch.int64,
                               device=device)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.spawn_ranks(4, str(tmp_path_factory.mktemp("ranks")), ["sfm"])


def _reference_filter(f0, f1, m, thresh, key=None, n_hyp=256):
    """The JAX package's F-RANSAC filter on the port's records."""
    def cv(r, cls):
        return cls(**{k: jnp.asarray(v) for k, v in r.numpy().items()})
    out = jfrontend.filter_matches_ransac(cv(f0, JFeatures), cv(f1, JFeatures),
                                         cv(m, JMatches), thresh,
                                         key=key.key, n_hyp=n_hyp)
    return Matches(*(torch.as_tensor(np.array(getattr(out, k)))
                     for k in ("idx0", "idx1", "score", "valid")))


def test_sfm_follows_reference(tmp_path, monkeypatch):
    n_frames = 10
    scene = CorridorScene(seed=4, hw=(160, 1226))
    T_wc = make_trajectory(n_frames, speed=0.8, yaw_rate_deg=0.0)
    frames = [np.asarray(scene.render(T_wc[i])) for i in range(n_frames)]
    gt = T_wc[:, :3, :4]

    jsfm = JSfM(JConfig(max_features=512, headless=True), DEFAULT_K,
                kf_survival=0.4, kf_max_gap=3)
    jsfm.add_frames(frames)
    ref = jsfm.run(gt_T=gt, run_gba=True)

    def port(out_dir=None, key=None):
        cfg = SLAMConfig(max_features=512, headless=True)
        sfm = StructureFromMotion(cfg, DEFAULT_K, kf_survival=0.4,
                                  kf_max_gap=3, device="cpu", key=key)
        sfm.add_frames(frames)
        return sfm.run(gt_T=gt, out_dir=out_dir, run_gba=True)

    # the port's own RANSAC: the reference test's bounds
    own = port()
    assert len(own.kf_frames) >= 4 and own.n_landmarks > 40
    assert own.ate < 1.0 and own.rte_rot_deg < 5.0
    # the reference's draws and F filter: its keyframes and map
    with monkeypatch.context() as mp:
        mp.setattr(tfrontend, "filter_matches_ransac", _reference_filter)
        res = port(str(tmp_path), JaxKey(jax.random.PRNGKey(0)))
    assert res.kf_frames == ref.kf_frames and len(res.kf_frames) >= 4
    assert abs(res.n_landmarks - ref.n_landmarks) <= 0.1 * ref.n_landmarks
    assert ref.ate < 1.0 and ref.rte_rot_deg < 5.0
    assert res.ate <= max(2 * ref.ate, 0.05), (res.ate, ref.ate)
    assert res.rte_rot_deg < 5.0
    assert (tmp_path / "sfm_final.png").exists()


@pytest.mark.parametrize("front", ["orb", "learned"])
def test_sfm_mesh_prepass_matches_sequential(ranks, front):
    res, digests = ranks
    assert len(set(digests)) == 1
    sh, seq = res["sfm"][front, "mesh"], res["sfm"][front, "none"]
    assert sh["kf"] == seq["kf"] and len(sh["kf"]) >= 2
    assert len(sh["feats"]) == len(seq["feats"]) == 6
    for a, b in zip(sh["feats"], seq["feats"]):
        np.testing.assert_array_equal(a["valid"], b["valid"])
        np.testing.assert_allclose(a["kpts"], b["kpts"], atol=0.1)


def test_sfm_sweep_modes_and_cpu_draws():
    """``tools/sfm_sweep.py``: each mode's feature source, and a key that
    draws on the CPU draws what the port's own key draws there."""
    from simpleslam_tpu_torch.tools import sfm_sweep
    from simpleslam_tpu_torch.utils.rng import TorchKey
    assert [sfm_sweep._feature_source(m) for m in sfm_sweep.MODES] == \
        ["gpu", "cpu", "gpu", "cpu", "gpu"]
    k = TorchKey(3).split()[1].fold_in(5)
    c = sfm_sweep.CpuDrawKey(TorchKey(3)).split()[1].fold_in(5)
    for high in (17, torch.tensor(9)):
        assert torch.equal(c.randint((4, 3), high, "cpu"),
                           k.randint((4, 3), high, "cpu"))


def sfm_readings(package: str, fronts, seeds, n_frames: int = 40):
    """SfM over the smoke's phase-12 sequence (phase 7's corridor: 40 frames
    at 370x1226, ``tools.synth``'s defaults) at the CLI's defaults, one
    JSON line per (front-end, RANSAC seed): keyframes, landmarks, ATE, RTE.
    ``package``: ``jax`` (the reference, on its own render) or ``port``
    (on the CPU)."""
    import json
    import time

    from simpleslam_tpu.config import parse_config as jparse
    from simpleslam_tpu_torch.config import parse_config as tparse
    from simpleslam_tpu_torch.tools import synth as tsynth
    T_wc = make_trajectory(n_frames, speed=0.5, yaw_rate_deg=0.25)
    if package == "jax":
        scene = CorridorScene(seed=0)
        frames = [np.asarray(scene.render(T)) for T in T_wc]
    else:
        scene = tsynth.CorridorScene(seed=0, device="cpu")
        frames = [scene.render(T).numpy() for T in T_wc]
    for front in fronts:
        for seed in seeds:
            argv = ["--dataset", "kitti", "--headless", "--seed", str(seed)]
            if front == "learned":
                argv.append("--use_lightglue")
            t0 = time.time()
            if package == "jax":
                sfm = JSfM(jparse(argv), DEFAULT_K)
            else:
                sfm = StructureFromMotion(tparse(argv), DEFAULT_K,
                                          device="cpu")
            sfm.add_frames(frames)
            r = sfm.run(gt_T=T_wc[:, :3, :4])
            print(json.dumps({"package": package, "front": front,
                              "seed": seed, "kf_frames": r.kf_frames,
                              "landmarks": r.n_landmarks, "ate_m": r.ate,
                              "rte_rot_deg": r.rte_rot_deg,
                              "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    # python tests/test_torch_sfm.py [--package jax|port] [--fronts
    # orb,learned] [--seeds 0,1,2,3]: the readings phase 12 of
    # chip_smoke.py holds the card to (JAX_PLATFORMS=cpu, from the root)
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default="jax", choices=["jax", "port"])
    ap.add_argument("--fronts", default="orb,learned")
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--frames", type=int, default=40)
    a = ap.parse_args()
    torch.set_num_threads(4)
    sfm_readings(a.package, a.fronts.split(","),
                 [int(s) for s in a.seeds.split(",")], a.frames)
