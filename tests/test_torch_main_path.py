"""``chip_smoke.py``'s main-path phase (5b) on the CPU at ``bench.py``'s
small size (180x410, 512 keypoints, 14 frames): the healthy run passes the
phase's own check, the check fails for a fused step whose local BA is a
no-op and for seeded weights, which never initialise, and the port's
end-to-end ATE is held to the JAX package's on the same frames.

At this size the ATE is set by which correspondences RANSAC draws, above
all in the bootstrap: over RANSAC seeds 0-5 the JAX package reads
0.39-0.95 m and the port 0.035-0.95 m on the same 14 frames (CPU;
``python tests/test_torch_fused.py --small --frames 14 --seeds
0,1,2,3,4,5 --port``; means 0.669 and 0.631 m). The packages draw
differently (``utils/rng.py``), so one seed's reading says little; the
port is held to the reference on the mean over ATE_SEEDS, within
ATE_MEAN_BAND. The bound of the check here is SMALL_ATE_MAX; the card's
(``MAIN_ATE_MAX``) is for the full size, where both packages read below
1 cm. Neither fault is caught by the ATE
bound here: the check's own counts catch them.
"""
import functools
import os
import sys

import pytest
import torch

from simpleslam_tpu_torch.core import fused
from simpleslam_tpu_torch.models import aliked as aliked_mod
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.models.pipeline import (seeded_init_,
                                                  trained_state_dicts)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 14
SMALL_ATE_MAX = 1.5
ATE_SEEDS = (0, 1, 2, 3)
# The standard deviation of one seed's ATE is 0.20 m (JAX) and 0.33 m
# (port) over seeds 0-5, so a mean over four seeds moves by 0.10-0.17 m
# with the draws alone; the band is 1.8 standard deviations of the
# difference of the two means (0.19 m).
ATE_MEAN_BAND = 0.35        # m


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


def _run(weights, seed=0):
    return _smoke().run_main_path("cpu", small=True, n_frames=N_FRAMES,
                                  weights=weights, seed=seed)


@functools.lru_cache(maxsize=None)
def _trained_run(seed):
    """One run with the trained tree per RANSAC seed, shared by the tests
    that read it (none of them changes it)."""
    return _run(trained_state_dicts(on_error="raise"), seed)


def test_main_path_check_passes_on_cpu():
    res = _trained_run(0)
    assert _smoke().main_path_ok(res, SMALL_ATE_MAX, kernel=False), res
    assert res["bootstrap_frame"] == 1 and res["keyframes"] >= 3, res
    assert res["ba_solves"] >= 1 and res["match_calls_fused_loop"] >= 2, res
    assert 2.0 <= res["host_reads_per_frame"] <= 6.0, res


@pytest.mark.parametrize("fault", ["local_ba_noop", "seeded_weights"])
def test_main_path_check_catches_faults(fault, monkeypatch):
    weights = trained_state_dicts(on_error="raise")
    if fault == "local_ba_noop":
        monkeypatch.setattr(fused.FusedStep, "_local_ba",
                            lambda self, state: None)
    else:
        weights = (seeded_init_(aliked_mod.ALIKED(), 0).state_dict(),
                   seeded_init_(lg_mod.LightGlue(n_layers=9), 1)
                   .state_dict())
    res = _run(weights)
    assert not _smoke().main_path_ok(res, SMALL_ATE_MAX, kernel=False), res
    if fault == "seeded_weights":
        assert not res["initialised"], res
    else:
        assert res["ba_solves"] == 0 and res["ba_ran_flags"] >= 1, res


def test_small_corridor_ate_matches_reference():
    """The port's main path (its own front-end, bootstrap and fused step)
    and the JAX package's on the same frames, over ATE_SEEDS: the same
    keyframe count and no lost frame for each seed, map sizes within 10%,
    and the mean ATE within ATE_MEAN_BAND."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_fused import jax_corridor_reading
    port = [_trained_run(seed) for seed in ATE_SEEDS]
    ref = [jax_corridor_reading(True, N_FRAMES, seed) for seed in ATE_SEEDS]
    for p, r in zip(port, ref):
        assert p["lost"] == r["lost"] == 0, (p, r)
        assert p["keyframes"] == r["keyframes"], (p, r)
        assert abs(p["map_points"] - r["map_points"]) \
            <= 0.1 * r["map_points"], (p, r)
    ate_p = [p["ate_m"] for p in port]
    ate_r = [r["ate_m"] for r in ref]
    assert abs(sum(ate_p) - sum(ate_r)) / len(ATE_SEEDS) <= ATE_MEAN_BAND, \
        (ate_p, ate_r)
