"""``tools/diagnose.py desc`` against the JAX package's probe, on the CPU:
at (144, 256, 512) the reference's own ``cmd_desc`` runs over the same
frames (the port's renders of its scene; it is stopped when it reaches its
full-size pass) and the port's ``probe_desc`` over them: the visible
counts within VISIBLE_TOL, the rates and distances within DESC_TOL (the
two packages' bf16 ALIKED round differently). The full size (376x1232,
2048 keypoints) runs on the card (``python -m
simpleslam_tpu_torch.tools.diagnose desc``).

One process, one torch thread: ~45 s, mostly the reference's ALIKED.
"""
import argparse
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from simpleslam_tpu.tools import diagnose as jdiag
import simpleslam_tpu.tools.synth as jsynth
from simpleslam_tpu_torch.tools import diagnose
from simpleslam_tpu_torch.tools.synth import SCENE_FAMILIES

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

# |port - reference| on the repeat rate, the true distances' p50 and p90,
# the distractors' p50 and the share of true distances below 0.8 (largest
# seen 0.012, p90 at gap 1); the visible count relative (402 against 404
# at gap 1): the packages' bf16 ALIKED move a few keypoints
DESC_TOL = 0.03
VISIBLE_TOL = 0.02


class _Stop(Exception):
    pass


def _parse_desc(line):
    m = re.fullmatch(
        r"\[(\d+)x(\d+)\] gap=(\d+): visible=(\d+) repeat=([\d.]+) "
        r"trueL2 p50=([\d.]+) p90=([\d.]+) distractorL2 p50=([\d.]+|inf) "
        r"frac_true<0.8=([\d.]+)", line.strip())
    assert m, line
    return [float(x) for x in m.groups()]


def test_desc_matches_reference(monkeypatch):
    """The reference's ``cmd_desc`` runs over the port's renders of its
    scene (the same frames for both packages) and is stopped when it
    reaches its full-size pass."""
    class Scene:
        def __init__(self, seed, hw, K):
            if tuple(hw) != (144, 256):
                raise _Stop
            self.sc = SCENE_FAMILIES["corridor"](seed=seed, hw=hw, K=K,
                                                 device="cpu")

        def render_with_geometry(self, T):
            return tuple(t.numpy() for t in self.sc.render_with_geometry(T))

    monkeypatch.setitem(jsynth.SCENE_FAMILIES, "corridor", Scene)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(_Stop):
        jdiag.cmd_desc(argparse.Namespace(seed=0, scene="corridor"))
    ref = [_parse_desc(ln) for ln in buf.getvalue().strip().splitlines()]
    port = diagnose.probe_desc(device="cpu", sizes=((144, 256, 512),))
    assert len(ref) == len(port) == 3
    for r, p in zip(ref, port):
        assert r[:3] == [144, 256, p["gap"]]
        assert abs(p["visible"] - r[3]) <= VISIBLE_TOL * r[3]
        got = [p["repeat"], p["true_p50"], p["true_p90"],
               p["distractor_p50"], p["frac_true_below_0_8"]]
        assert p["visible"] > 100 and p["repeat"] > 0.5
        np.testing.assert_allclose(got, r[4:], rtol=0, atol=DESC_TOL)
