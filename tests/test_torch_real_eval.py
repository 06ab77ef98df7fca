"""``tools/real_eval.py`` of the port against the JAX package's on the CPU,
on photographs written here (views of the JAX package's box and corridor
scenes, grey and colour PNG and JPEG; ``chip_smoke.write_photos``).

The learned front-end on both sides: the trained ALIKED tree and the
first three layers of the trained LightGlue (read once by the port's
checkpoint reader), at 256 keypoints.

Tolerances:
- ``build_episodes``: images equal, homographies within 1e-9 of their
  largest entry, the photometric draws equal;
- ``evaluate_pair`` with ORB: every metric equal but where the uint8 warp
  flips a level (at most 0.5% of the pixels), which moves a FAST corner
  now and then: repeatability and precision within 0.05 per episode,
  match counts within 10%;
- with the learned front-end (bf16 convolutions and projections, rounded
  at other places in the two frameworks): the means over the episodes,
  repeatability and the descriptor distances within 0.03, precision and
  recall within 0.08, match counts within 15%.
"""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
import jax
import jax.numpy as jnp
from simpleslam_tpu.models import aliked as jaliked
from simpleslam_tpu.models import lightglue as jlg
from simpleslam_tpu.models import pipeline as jpipe
from simpleslam_tpu.tools import real_eval as jre
from simpleslam_tpu.tools import synth as jsynth
from simpleslam_tpu_torch.models import checkpoint
from simpleslam_tpu_torch.models.pipeline import (LearnedExtractor,
                                                  LearnedMatcher,
                                                  from_jax_params)
from simpleslam_tpu_torch.tools import real_eval as tre

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

N_KP = 256


@pytest.fixture(scope="module")
def photo_glob(tmp_path_factory):
    hw = (120, 160)
    K = jsynth.DEFAULT_K.copy()
    K[0] *= hw[1] / jsynth.DEFAULT_HW[1]
    K[1] *= hw[0] / jsynth.DEFAULT_HW[0]
    scenes = [jsynth.BoxScene(seed=401, hw=hw, K=K),
              jsynth.CorridorScene(seed=402, hw=hw, K=K)]
    T = jsynth.make_trajectory(8, speed=1.5, yaw_rate_deg=6.0)
    d = str(tmp_path_factory.mktemp("photos"))
    chip_smoke.write_photos(d, [scenes[i % 2].render(T[i]) for i in range(8)])
    return os.path.join(d, "*")


@pytest.fixture(scope="module")
def learned_pair():
    """(JAX (det, mat), port (det, mat)) on the trained weights, LightGlue
    cut to three layers."""
    tree = checkpoint.load_frontend_tree(checkpoint.DEFAULT_DIR,
                                         on_error="raise")
    a_model = jaliked.ALIKED(desc_dim=128)
    l_model = jlg.LightGlue(dim=256, heads=4, n_layers=3)
    l_tree = {"params": {k: v for k, v in tree["lightglue"]["params"].items()
                         if not k.startswith(("self", "cross"))
                         or int(k[-1]) < 3}}
    jdet = jpipe.LearnedExtractor.__new__(jpipe.LearnedExtractor)
    jdet.name, jdet.max_kp, jdet.learned, jdet.desc_dim = \
        "aliked", N_KP, True, 128
    jdet.model = a_model
    jdet.params = jax.tree.map(jnp.asarray, tree["aliked"])
    jdet.image_hw = None
    jmat = jpipe.LearnedMatcher.__new__(jpipe.LearnedMatcher)
    jmat.name, jmat.learned, jmat.min_conf, jmat.extractor = \
        "lightglue", True, 0.7, jdet
    jmat.model, jmat.params = l_model, jax.tree.map(jnp.asarray, l_tree)
    a_sd, l_sd = from_jax_params(tree["aliked"], l_tree)
    tdet = LearnedExtractor(N_KP, device="cpu", state_dict=a_sd)
    tmat = LearnedMatcher(tdet, min_conf=0.7, n_layers=3, state_dict=l_sd)
    return (jdet, jmat), (tdet, tmat)


@pytest.mark.parametrize("hw", [None, (60, 80)])
def test_build_episodes_equal_reference(photo_glob, hw):
    import glob
    paths = sorted(glob.glob(photo_glob))
    assert tre.select_split(paths, "heldout") == \
        jre.select_split(paths, "heldout")
    assert tre.select_split(paths, "train") == jre.select_split(paths,
                                                                 "train")
    want = jre.build_episodes(paths, 3, hw, seed=5)
    got = tre.build_episodes(paths, 3, hw, seed=5)
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        assert a["path"] == b["path"] and a["photo"] == b["photo"]
        np.testing.assert_array_equal(a["img"], b["img"])
        assert np.abs(a["H"] - b["H"]).max() <= 1e-9 * np.abs(b["H"]).max()
    assert tre.build_episodes(paths, 1, hw, illum=False)[0]["photo"] is None


def _episodes(photo_glob):
    import glob
    return jre.build_episodes(sorted(glob.glob(photo_glob))[:4], 2, None,
                              seed=1)


def test_evaluate_pair_orb_matches_reference(photo_glob):
    eps = _episodes(photo_glob)
    jdet, jmat = jre._frontend("orb", N_KP, 0.7)
    tdet, tmat = tre._frontend("orb", N_KP, 0.7, device="cpu")
    n = 0
    for ep in eps:
        want = jre.evaluate_pair(jdet, jmat, ep["img"], ep["H"], ep["photo"])
        got = tre.evaluate_pair(tdet, tmat, ep["img"], ep["H"], ep["photo"])
        assert (got is None) == (want is None)
        if want is None:
            continue
        n += 1
        assert set(got) == set(want)
        assert abs(got["repeatability"] - want["repeatability"]) <= 0.05
        assert abs(got["match_precision"] - want["match_precision"]) <= 0.05
        assert abs(got["n_matches"] - want["n_matches"]) \
            <= 0.1 * max(want["n_matches"], 10)
    assert n >= 4


def test_evaluate_pair_learned_matches_reference(photo_glob, learned_pair):
    (jdet, jmat), (tdet, tmat) = learned_pair
    rows_j, rows_t = [], []
    for ep in _episodes(photo_glob):
        want = jre.evaluate_pair(jdet, jmat, ep["img"], ep["H"], ep["photo"])
        got = tre.evaluate_pair(tdet, tmat, ep["img"], ep["H"], ep["photo"])
        assert (got is None) == (want is None)
        if want is not None:
            assert set(got) == set(want)
            rows_j.append(want)
            rows_t.append(got)
    assert len(rows_j) >= 6
    mean = {k: (np.mean([r[k] for r in rows_t]),
                np.mean([r[k] for r in rows_j])) for k in rows_j[0]}
    assert mean["n_matches"][1] >= 10
    for k, tol in (("repeatability", 0.03), ("true_l2_p50", 0.03),
                   ("distractor_l2_p50", 0.03), ("match_precision", 0.08),
                   ("match_recall_vs_vis", 0.08)):
        assert abs(mean[k][0] - mean[k][1]) <= tol, (k, mean[k])
    assert abs(mean["n_matches"][0] - mean["n_matches"][1]) \
        <= 0.15 * mean["n_matches"][1]


def test_main_compare_json_prints_reference_keys(photo_glob, learned_pair,
                                                 monkeypatch, capsys):
    """``main --compare --json`` in both packages, the learned front-end
    of each replaced by the three-layer pair above."""
    (jdet, jmat), (tdet, tmat) = learned_pair
    j_frontend, t_frontend = jre._frontend, tre._frontend
    monkeypatch.setattr(jre, "_frontend", lambda name, k, c: (
        (jdet, jmat) if name == "learned" else j_frontend(name, k, c)))
    monkeypatch.setattr(tre, "_frontend", lambda name, k, c, device=None: (
        (tdet, tmat) if name == "learned" else t_frontend(name, k, c,
                                                          device=device)))
    argv = ["--glob", photo_glob, "--n", "2", "--warps", "2", "--compare",
            "--json", "--max_kp", str(N_KP)]
    assert jre.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tre.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want) == ["learned", "orb", "akaze"]
    for name in got:
        assert list(got[name]) == list(want[name]), name
        assert got[name]["n_episodes"] == want[name]["n_episodes"]
    assert tre.main(["--glob", photo_glob, "--n", "1", "--warps", "1",
                     "--frontend", "orb", "--max_kp", str(N_KP),
                     "--device", "cpu"]) == 0
    assert "aggregate:" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        tre.main(["--glob", photo_glob + ".none", "--device", "cpu"])
