"""``tools/fused_cost.py`` and the fused step's ``force_branch``, on the CPU
at ``bench.py``'s small spec (180x410, 512 keypoints, the trained tree):

* the CLI prints one JSON line with finite ``static``, ``skip``, ``eval``
  and ``kf``, ordered ``skip < eval <= kf <= static``;
* each class's attention share is exactly its attention calls x
  ``4 BH Nq Nk d``, the formula the tool counts by, and equals what the
  counter saw of the plain twin's two products; 36 calls per LightGlue
  forward: none when skipping, one forward when evaluating, two on a
  keyframe with ``--tri_kf2``, and three more for 'static' (keyframe and
  global relocalisation, the essential fallback's match);
* the convolutions' count is ALIKED's convolutions counted from their
  shapes, once per step;
* the forced steps leave the caller's state untouched, and
  ``force_branch`` takes the branch reads as each class says;
* without ``--device cpu`` the tool asks for the GPU, and raises here.

One process, one torch thread: ~40 s (one bootstrap, eight forced steps).
"""
import contextlib
import io
import json
import math

import pytest
import torch

from simpleslam_tpu_torch.core.fused import FusedStep, build_fused_step
from simpleslam_tpu_torch.models import aliked as aliked_mod
from simpleslam_tpu_torch.tools import fused_cost

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


def _small_spec():
    """``bench.py``'s small spec (its ``bench_e2e_fused(small=True)``
    argv, size and camera)."""
    H, W = 180, 410
    s = W / 1232.0
    K = [[707.0912 * s, 0.0, 601.8873 * s], [0.0, 707.0912 * s, 0.487 * H],
         [0.0, 0.0, 1.0]]
    return {"argv": ["--dataset", "kitti", "--headless", "--no_viz3d",
                     "--max_features", "512", "--map_capacity", "2048",
                     "--use_lightglue", "--tri_kf2"],
            "hw": [H, W], "n_kp": 512, "desc_dim": 128,
            "desc_dtype": "float32", "K": K}


@pytest.fixture(scope="module")
def counted():
    """The CLI run once, with its pieces kept: the JSON line, the per-class
    detail, the system, the state before and after, the frame."""
    real = fused_cost.count_classes
    kept = {}

    def keep(fc, system, state, img, detail=None):
        kept.update(system=system, fc=fc, img=img, state=state,
                    before=state.clone(), detail={})
        return real(fc, system, state, img, kept["detail"])

    fused_cost.count_classes = keep
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert fused_cost.main([json.dumps(_small_spec()),
                                    "--device", "cpu"]) == 0
    finally:
        fused_cost.count_classes = real
    kept["lines"] = out.getvalue().strip().splitlines()
    return kept


def test_cli_prints_four_ordered_classes(counted):
    assert len(counted["lines"]) == 1
    got = json.loads(counted["lines"][0])
    assert sorted(got) == ["eval", "kf", "skip", "static"]
    assert all(isinstance(v, float) and math.isfinite(v) and v > 0
               for v in got.values())
    assert got["skip"] < got["eval"] <= got["kf"] <= got["static"]


@pytest.mark.parametrize("cls, forwards", [("skip", 0), ("eval", 1),
                                           ("kf", 2), ("static", 5)])
def test_attention_share_is_four_bh_n2_d_per_call(counted, cls, forwards):
    fc = counted["fc"]
    assert fc.tri_kf2 and fc.reloc and fc.global_reloc
    assert fc.assoc_wide_factor > 1.0
    d = counted["detail"][cls]
    calls = d["attention_calls"]
    assert len(calls) == 36 * forwards
    assert all(c == (4, 512, 512, 64) for c in calls)
    assert d["attention"] == sum(4 * bh * nq * nk * hd
                                 for bh, nq, nk, hd in calls)
    # on the CPU the counter sees the plain twin's products: the same
    assert d["attention_seen"] == d["attention"]
    # the share is inside the class's total
    assert d["attention"] < sum(d["ops"].values())


def test_convolutions_match_their_shapes(counted):
    """ALIKED's convolutions, counted from each one's input and weight
    shapes (2 x output elements x Cin/groups x kh x kw), are the counter's
    convolution FLOPs of every class: one extract a step."""
    det = counted["system"].detector
    want = []

    def hook(mod, inp, out):
        w = mod.weight
        want.append(2 * out.numel() * (w.shape[1] * w.shape[2]
                                       * w.shape[3]))
    hooks = [m.register_forward_hook(hook) for m in det.model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        det.fn(counted["img"].float())
    finally:
        for h in hooks:
            h.remove()
    assert len(want) > 10 and isinstance(det.model, aliked_mod.ALIKED)
    for cls, d in counted["detail"].items():
        assert d["ops"]["aten.convolution"] == sum(want), cls


def test_forced_steps_leave_the_state_untouched(counted):
    state, before = counted["state"], counted["before"]
    for f in state.__dataclass_fields__:
        a, b = getattr(state, f), getattr(before, f)
        if torch.is_tensor(a):
            assert torch.equal(a, b), f
        else:
            assert a == b, f


def test_force_branch_answers_the_policy_reads(counted):
    """Each forced step takes its class's decisions (log columns 0
    'tracked', 1 'kf', 5 'ba_ran', 6 'considered', and the compactions):
    the three frame classes on a tracked frame, 'static' through the
    whole recovery chain to a keyframe burst with compaction; an unknown
    class is refused."""
    system, fc = counted["system"], counted["fc"]
    match_fn = getattr(system.matcher, "fn_fast", None) or system.matcher.fn
    before = counted["before"]
    kf0, comp0 = int(before.kf_count), int(before.compactions)
    got = {}
    for force in ("skip", "eval", "kf", "static"):
        step = build_fused_step(fc, system.K, system.detector.fn, match_fn,
                                "cpu", force_branch=force)
        st = step(before.clone(), counted["img"])
        flags = st.log_flags[0].numpy()
        got[force] = (bool(flags[0]), int(st.kf_count) - kf0,
                      bool(flags[1]), bool(flags[6]), bool(flags[5]),
                      int(st.compactions) - comp0)
    assert got["skip"] == (True, 0, False, False, False, 0)
    assert got["eval"] == (True, 0, False, True, False, 0)
    assert got["kf"] == (True, 1, True, True, True, 0)
    assert got["static"] == (False, 1, True, True, True, 1)
    assert set(FusedStep.FORCED) == set(fused_cost.CLASSES)
    with pytest.raises(ValueError, match="force_branch"):
        build_fused_step(fc, system.K, system.detector.fn, match_fn, "cpu",
                         force_branch="burst")


def test_default_device_is_the_gpu():
    """The tool resolves its device as every entry point does: without
    ``--device cpu`` it asks for the GPU, which this machine lacks."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default would run there")
    with pytest.raises(RuntimeError, match="(?i)cuda|gpu"):
        fused_cost.main([json.dumps(_small_spec())])
