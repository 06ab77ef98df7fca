"""The port's batch and multi-device layer (``parallel/``,
``extract_batch``, ``match_batch``, ``ba_solve_batch``,
``ba_solve_sharded``, the sharded training step) against the JAX package's
on the CPU.

The multi-rank cases run once per module in four ``gloo`` processes
(``tests/torch_parallel_ranks.py``, a ``FileStore`` under the module's
tmp dir): a (4, 1) mesh and a (2, 2) dp x tp mesh of one group. The JAX
references run on the conftest's virtual 8-device mesh. The sizes are
``tests/test_parallel.py``'s: 48x64 images, descriptors 32, LightGlue
width 64 with 2 layers, 32 keypoints; BA windows of 4-6 cameras, 128-256
points, 1024-2044 edges.

Tolerances:
- keypoints: the port against the JAX package, at least 80% of the valid
  keypoints of each image within 0.1 px of one of the reference's (each
  side rounds its bf16 convolutions in its own places:
  ``tests/test_torch_models.py``); the sharded batch against the
  unsharded one within 0.1 px (the reference's own tolerance,
  ``tests/test_parallel.py``) with the same valid masks;
- matches: on the same features through both matchers' assignment, the
  valid pairs of each pair of images differ in at most max(2, 5%);
- BA: ``tests/test_parallel.py``'s: initial cost 1e-5 relative, final
  cost 5%, poses 2e-3 (5e-3 batched), points 2e-2 (5e-2 batched);
- the sharded training step (float32 models) against the unsharded
  port step on the same state and batch: metrics 1e-5 relative, the
  gathered gradient 1e-4 relative L2 and each entry within 1e-4 of
  max(1e-3, max|grad|) (float reassociation in the tp products and the
  all-reduces), the parameters after the update within 1% of the learning
  rate (Adam's update of an entry whose gradient is at float32 noise level
  follows that noise, up to twice the learning rate:
  ``tests/test_torch_train.py``).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.models import aliked as jaliked
from simpleslam_tpu.models import lightglue as jlg
from simpleslam_tpu.models import train as jtrain
from simpleslam_tpu.ops import ba as jba
from simpleslam_tpu.parallel.batch import \
    sharded_extract_and_match as j_sharded_extract_and_match
from simpleslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from simpleslam_tpu_torch.models import aliked as taliked
from simpleslam_tpu_torch.models import lightglue as tlg
from simpleslam_tpu_torch.models import train as ttrain
from simpleslam_tpu_torch.models.pipeline import to_jax_params
from simpleslam_tpu_torch.ops import ba as tba

import torch_parallel_ranks as R

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every multi-rank check, run once in one 4-rank gloo group."""
    return R.spawn_ranks(4, str(tmp_path_factory.mktemp("ranks")),
                         ["mesh", "batch", "ba", "train"])


@pytest.fixture(scope="module")
def nets():
    """(port ALIKED, port LightGlue, JAX ALIKED + params, JAX LightGlue +
    params), the JAX side carrying the port's seeded weights."""
    a, lg = R.models()
    pa, pl = to_jax_params(a.state_dict(), lg.state_dict())
    return a, lg, (jaliked.ALIKED(desc_dim=R.DESC), pa), \
        (jlg.LightGlue(dim=R.DIM, heads=4, n_layers=R.LAYERS), pl)


@pytest.fixture(scope="module")
def reference(nets):
    """The JAX package's sharded extract-and-match at dp 8."""
    _a, _lg, (ja, pa), (jl, pl) = nets
    im0, im1 = R.images()
    f0, f1, m = j_sharded_extract_and_match(
        ja, pa, jl, pl, jnp.asarray(im0.numpy()), jnp.asarray(im1.numpy()),
        jmake_mesh(8, tp=1), max_kp=R.MAX_KP, image_hw=(R.H, R.W),
        min_conf=0.0)
    return jax.tree.map(np.asarray, (f0, f1, m))


def _close_share(kt, vt, kj, vj):
    """Per image: the share of the port's valid keypoints within 0.1 px of
    one of the reference's."""
    out = []
    for b in range(kt.shape[0]):
        a, r = kt[b][vt[b]], kj[b][vj[b]]
        d = np.linalg.norm(a[:, None] - r[None], axis=-1)
        out.append(float((d.min(1) < 0.1).mean()))
    return np.array(out)


def _pairs(m, b):
    v = np.asarray(m.valid if hasattr(m, "valid") else m["valid"])[b]
    i0 = np.asarray(m.idx0 if hasattr(m, "idx0") else m["idx0"])[b][v]
    i1 = np.asarray(m.idx1 if hasattr(m, "idx1") else m["idx1"])[b][v]
    return set(zip(i0.tolist(), i1.tolist()))


def test_make_mesh_shapes_and_error(ranks):
    res, digests = ranks
    mesh = res["mesh"]
    assert mesh[()] == {"dp": 2, "tp": 2}
    assert mesh[(4, 1)] == {"dp": 4, "tp": 1}
    assert mesh[(2, 1)] == {"dp": 2, "tp": 1}
    assert "asked for 8 devices" in mesh["error"]
    assert len(set(digests)) == 1          # every rank returned the same
    # one process with no group gets a one-rank gloo group on the CPU
    import torch.distributed as dist
    from simpleslam_tpu_torch.parallel.mesh import make_mesh
    try:
        m = make_mesh()
        assert dict(zip(m.mesh_dim_names, m.shape)) == {"dp": 1, "tp": 1}
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="asked for 2 devices"):
            make_mesh(2)
    finally:
        dist.destroy_process_group()


def test_extract_batch_matches_reference_and_single_images(nets):
    a, _lg, (ja, pa), _ = nets
    im0, _ = R.images()
    fb = taliked.extract_batch(a, im0, R.MAX_KP)
    fj = jax.tree.map(np.asarray, jaliked.extract_batch(
        ja, pa, jnp.asarray(im0.numpy()), R.MAX_KP))
    assert fb.kpts.shape == (R.B_PAIRS, R.MAX_KP, 2)
    assert fb.desc.shape == (R.B_PAIRS, R.MAX_KP, R.DESC)
    share = _close_share(fb.kpts.numpy(), fb.valid.numpy(), fj.kpts,
                         fj.valid)
    assert share.min() >= 0.8, share
    # the batch equals the per-image path
    with torch.no_grad():
        for b in range(R.B_PAIRS):
            s, d = a(im0[b:b + 1])
            f = taliked.dkd_extract(s[0], d[0], R.MAX_KP)
            np.testing.assert_array_equal(f.valid.numpy(),
                                          fb.valid[b].numpy())
            np.testing.assert_allclose(f.kpts.numpy(), fb.kpts[b].numpy(),
                                       atol=1e-4)


def test_match_batch_matches_reference(nets, reference):
    _a, lg, _ja, (jl, pl) = nets
    f0, f1, _m = reference           # the reference's features, both sides
    mj = jax.tree.map(np.asarray, jlg.match_batch(
        jl, pl, jax.tree.map(jnp.asarray, f0),
        jax.tree.map(jnp.asarray, f1), (R.H, R.W), 0.0))
    from simpleslam_tpu_torch.core.types import Features

    def tf(f):
        return Features(*(torch.as_tensor(np.asarray(getattr(f, k)))
                          for k in ("kpts", "desc", "scores", "valid")))

    mt = tlg.match_batch(lg, tf(f0), tf(f1), (R.H, R.W), 0.0)
    assert mt.idx0.shape == (R.B_PAIRS, R.MAX_KP)
    assert sum(len(_pairs(mj, b)) for b in range(R.B_PAIRS)) > 20
    for b in range(R.B_PAIRS):
        pj, pt = _pairs(mj, b), _pairs(mt, b)
        assert len(pj ^ pt) <= max(2, len(pj) // 20), b
        # each pair's matches keep matches_from_assignment's order
        one = tlg.matches_from_assignment(
            lg(tf(f0).kpts[b:b + 1], tf(f0).desc[b:b + 1],
               tf(f0).valid[b:b + 1], tf(f1).kpts[b:b + 1],
               tf(f1).desc[b:b + 1], tf(f1).valid[b:b + 1],
               (R.H, R.W))[0][0].detach(), 0.0)
        np.testing.assert_array_equal(one.valid.numpy(), mt.valid[b].numpy())
        v = one.valid.numpy()
        np.testing.assert_array_equal(one.idx0.numpy()[v],
                                      mt.idx0[b].numpy()[v])


@pytest.mark.parametrize("mesh", ["dp4", "dp2tp2"])
def test_sharded_extract_and_match(ranks, nets, reference, mesh):
    """The port at dp 4 (and on the 2x2 mesh) against the JAX package at
    dp 8 and against the port's unsharded batch; every rank returned the
    whole batch."""
    res, digests = ranks
    a, lg, _ja, _jl = nets
    got = res[f"sem_{mesh}"]
    assert len(set(digests)) == 1
    im0, im1 = R.images()
    f0 = taliked.extract_batch(a, im0, R.MAX_KP)
    f1 = taliked.extract_batch(a, im1, R.MAX_KP)
    m = tlg.match_batch(lg, f0, f1, (R.H, R.W), 0.0)
    np.testing.assert_array_equal(got["f0"]["valid"], f0.valid.numpy())
    np.testing.assert_allclose(got["f0"]["kpts"], f0.kpts.numpy(), atol=0.1)
    np.testing.assert_allclose(got["f1"]["kpts"], f1.kpts.numpy(), atol=0.1)
    for b in range(R.B_PAIRS):
        assert _pairs(got["m"], b) == _pairs(m, b), b
    # identical to the separate sharded calls
    np.testing.assert_array_equal(res["extract"]["kpts"], got["f0"]["kpts"])
    for b in range(R.B_PAIRS):
        assert _pairs(res["match"], b) == _pairs(got["m"], b), b
    # against the reference's dp 8
    rf0, rf1, rm = reference
    share = _close_share(got["f0"]["kpts"], got["f0"]["valid"], rf0.kpts,
                         rf0.valid)
    assert share.min() >= 0.8, share
    assert rm.idx0.shape == got["m"]["idx0"].shape
    # a batch that does not split over dp raises, as the reference's
    # sharding does
    assert "does not split" in res["indivisible"]


def test_sharded_extract_classical_is_per_image_orb(ranks):
    from simpleslam_tpu_torch.ops.features import orb_detect_and_describe
    res, _ = ranks
    im0, _ = R.images()
    for b in (0, 5):
        f = orb_detect_and_describe((im0[b, ..., 0] * 255.0).round(),
                                    max_kp=64, fast_thresh=20.0)
        for k, v in f.numpy().items():
            np.testing.assert_array_equal(res["orb"][k][b], v, err_msg=k)


def _jax_problem(fields):
    f = list(fields)
    return jba.BAProblem(*(jnp.asarray(x) for x in f))


@pytest.mark.parametrize("per_window_k", [False, True])
def test_ba_solve_batch_matches_reference(per_window_k):
    fix = [R.ba_fixture(P_=5, L_=128, E_=2044, seed=s) for s in (0, 1, 2)]
    K = fix[0][1]
    Ks = np.stack([K * np.array([[1 + 0.05 * i], [1 + 0.05 * i], [1]],
                                np.float32) for i in range(3)])
    Kt = Ks if per_window_k else K
    stacked = [np.stack(x) for x in zip(*(f for f, _ in fix))]
    pb, xb, c0b, c1b, nb = tba.ba_solve_batch(
        R.torch_problem(stacked), torch.as_tensor(Kt), huber=2.0,
        max_iters=12)
    jpb, jxb, jc0, jc1, _jn = jax.tree.map(np.asarray, jba.ba_solve_batch(
        _jax_problem(stacked), jnp.asarray(Kt), huber=2.0, max_iters=12))
    for i, (f, _) in enumerate(fix):
        Ki = Ks[i] if per_window_k else K
        p1, x1, c0, c1, n = tba.ba_solve(R.torch_problem(f),
                                         torch.as_tensor(Ki), huber=2.0,
                                         max_iters=12)
        assert float(c1) < 0.5 * float(c0)
        np.testing.assert_allclose(float(c0b[i]), float(c0), rtol=1e-5)
        np.testing.assert_allclose(float(c1b[i]), float(c1), rtol=0.05)
        np.testing.assert_allclose(pb[i].numpy(), p1.numpy(), atol=5e-3)
        np.testing.assert_allclose(xb[i].numpy(), x1.numpy(), atol=5e-2)
        # and the JAX package's batch
        np.testing.assert_allclose(float(c0b[i]), jc0[i], rtol=1e-5)
        np.testing.assert_allclose(float(c1b[i]), jc1[i], rtol=0.05)
        np.testing.assert_allclose(pb[i].numpy(), jpb[i], atol=5e-3)
        np.testing.assert_allclose(xb[i].numpy(), jxb[i], atol=5e-2)
    assert nb.shape == (3,) and (nb > 0).all()


@pytest.mark.parametrize("mesh", ["dp4", "dp2tp2"])
def test_ba_solve_sharded_matches_reference(ranks, mesh):
    """Edges split over dp 4 (E = 2044, not divisible) and over the 2x2
    mesh's dp axis, against the port's ba_solve and the JAX package's
    ba_solve_sharded on 8 and 4x2 devices."""
    res, _ = ranks
    kw, iters, jm = ((dict(E_=2044), 12, jmake_mesh(8, tp=1))
                     if mesh == "dp4" else
                     (dict(P_=4, L_=128, E_=1024, seed=2), 8, jmake_mesh(8)))
    fields, K = R.ba_fixture(**kw)
    p1, x1, c0b, c1b, _nb = res[f"ba_{mesh}"]
    p0, x0, c0a, c1a, _na = tba.ba_solve(R.torch_problem(fields),
                                         torch.as_tensor(K), huber=2.0,
                                         max_iters=iters)
    np.testing.assert_allclose(c0b, float(c0a), rtol=1e-5)
    assert c1b < 0.5 * c0b
    np.testing.assert_allclose(c1b, float(c1a), rtol=0.05)
    np.testing.assert_allclose(p1, p0.numpy(), atol=2e-3)
    np.testing.assert_allclose(x1, x0.numpy(), atol=2e-2)
    jp, jx, jc0, jc1, _jn = jax.tree.map(np.asarray, jba.ba_solve_sharded(
        _jax_problem(fields), jnp.asarray(K), jm, huber=2.0,
        max_iters=iters))
    np.testing.assert_allclose(c0b, jc0, rtol=1e-5)
    np.testing.assert_allclose(c1b, jc1, rtol=0.05)
    np.testing.assert_allclose(p1, jp, atol=2e-3)
    np.testing.assert_allclose(x1, jx, atol=2e-2)


def _jax_sharded_step_metrics(state, batch):
    """The metrics of one ``make_sharded_train_step`` of the JAX package on
    the conftest's 8-device mesh, from the port's state (its optimizer the
    reference's own chain at the port's settings)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "make_models",
                   lambda key, **kw: (None, None, {"x": jnp.zeros(1)}))
        tx = jtrain.make_train_state(jax.random.PRNGKey(0), lr=R.TRAIN_LR,
                                     warmup=0, total_steps=10)[2]
    pa, pl = to_jax_params(state.models["aliked"].state_dict(),
                           state.models["lightglue"].state_dict())
    params = {"aliked": pa, "lightglue": pl}
    jstep = jtrain.make_sharded_train_step(
        jaliked.ALIKED(desc_dim=R.DESC, dtype=jnp.float32),
        jlg.LightGlue(dim=R.TRAIN_DIM, heads=4, n_layers=R.LAYERS,
                      dtype=jnp.float32),
        tx, R.TRAIN_HW, jmake_mesh(8))
    _, m = jstep(jtrain.TrainState(params, tx.init(params), jnp.int32(0)),
                 {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    return {k: float(v) for k, v in m.items()}


def test_sharded_train_step_equals_unsharded_step(ranks):
    """The 2x2 step on a batch whose dp halves hold 9 and 30 valid points
    against the unsharded port step: a per-shard mean of the loss would
    weight the halves equally and miss by far more than the tolerance
    (4.1% of the loss). The JAX package's sharded step on the same state
    and batch gives the port's loss terms."""
    res, _ = ranks
    got = res["train"]
    batch = R.train_batch()
    half = R.TRAIN_B // 2
    assert int(batch["pt_valid"][:half].sum()) != \
        int(batch["pt_valid"][half:].sum())
    tx, state = R.train_state()
    metrics, grad = ttrain.loss_and_grad(state.models, batch, R.TRAIN_HW)
    # the mean of the halves' losses, each normalised by its own counts,
    # is not the batch's loss
    per_half = [float(ttrain.loss_fn(
        state.models["aliked"], state.models["lightglue"],
        {k: v[s] for k, v in batch.items()}, R.TRAIN_HW)[0])
        for s in (slice(0, half), slice(half, None))]
    assert abs(np.mean(per_half) - float(metrics["total"])) > \
        1e-3 * abs(float(metrics["total"]))
    # the JAX package's sharded step at dp 4 x tp 2 on the same state and
    # batch: finite, its loss terms within test_torch_train.py's 1e-5
    jm = _jax_sharded_step_metrics(state, batch)
    for k, v in jm.items():
        assert np.isfinite(v), k
        assert abs(float(metrics[k]) - v) <= 1e-5 * max(1.0, abs(v)), k
    step = ttrain.make_train_step(tx, R.TRAIN_HW)
    state, _ = step(state, batch)
    # the dense layers of width >= 64 really were split over tp
    assert got["n_sharded"] == 26 and got["local_numel"] < state.flat.numel()
    for k, v in metrics.items():
        assert np.isfinite(got["metrics"][k])
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got["step_metrics"][k], float(v),
                                   rtol=1e-5, err_msg=k)
    g = grad.numpy()
    rel = np.linalg.norm(got["grad"] - g) / np.linalg.norm(g)
    assert rel < 1e-4, rel
    assert np.abs(got["grad"] - g).max() <= 1e-4 * max(1e-3, np.abs(g).max())
    np.testing.assert_allclose(got["params"], state.flat.numpy(),
                               atol=0.01 * R.TRAIN_LR)
    assert got["step"] == 1


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    import json
    from simpleslam_tpu_torch.utils.profiling import span, spans, torch_trace
    with torch_trace(None):
        with span("probe"):
            torch.ones(3).sum()
    assert not any(r["name"] == "probe" for r in spans())
    with torch_trace(str(tmp_path / "tr")):
        with span("probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = sorted(os.listdir(tmp_path / "tr"))
    assert [n.split("_")[0] for n in names] == ["spans", "trace"]
    f = names[1]
    assert f.endswith(".json") and os.path.getsize(tmp_path / "tr" / f) > 0
    # the span summary beside it holds the block's spans
    assert names[0] == "spans_" + f[len("trace_"):]
    with open(tmp_path / "tr" / names[0]) as fh:
        got = json.load(fh)
    assert got["totals"]["probe"]["count"] == 1
    assert [r["name"] for r in got["spans"]] == ["probe"]
