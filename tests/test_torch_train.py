"""The port's training path (``ops/attention.py::MaskedAttentionFn``,
``models/train.py``, ``models/train_frontend.py``) against the JAX
package's on the CPU, on the same inputs.

Tolerances:
- The attention's gradient (forward: the plain version on the CPU) against
  the reference's own backward ``_pad_bwd``: float32 gradients to 1e-5 of
  max(1, max|grad|) (the same expression, rounded in another order);
  bfloat16 gradients to 2^-8 of max|grad|, one bf16 step at the largest
  gradient (each side rounds a float32 result to bf16 once).
- ``loss_fn`` with both packages' models in float32: each loss term to 1e-5
  of max(1, |term|); each parameter's gradient to a relative L2 error of
  1e-4 where its norm is at least 1e-4 of the largest (the rest, such as
  the attention's k bias, whose gradient is zero but for rounding, to 1e-6
  of the largest norm). At the default bf16: each term to 2^-8 of
  max(1, |term|), the whole gradient to a relative L2 error of 2e-2 and
  each parameter's to 0.1 where its norm is at least 1e-2 of the largest
  (every convolution and projection rounds to bf16 in both packages, at
  different places).
- The schedule against optax's, which evaluates it in float32: 1e-5
  relative. The optimizer chain against optax: 1e-6 relative, and step 0
  leaves the parameters bit for bit.
- Three train steps at a tiny width, float32: losses 1e-5 of max(1, |term|),
  parameters 1.5e-5 absolute, 1% of the summed learning rate (Adam's update
  of an entry whose gradient is at float32 noise level depends on that
  noise, up to twice the learning rate).
"""
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.models import aliked as jaliked
from simpleslam_tpu.models import lightglue as jlg
from simpleslam_tpu.models import train as jtrain
from simpleslam_tpu.ops.pallas.attention import _pad_bwd
from simpleslam_tpu_torch.models import aliked as taliked
from simpleslam_tpu_torch.models import checkpoint
from simpleslam_tpu_torch.models import lightglue as tlg
from simpleslam_tpu_torch.models import train as ttrain
from simpleslam_tpu_torch.models import train_frontend
from simpleslam_tpu_torch.models.pipeline import (LearnedExtractor,
                                                  LearnedMatcher,
                                                  from_jax_params,
                                                  to_jax_params)
from simpleslam_tpu_torch.ops import attention

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
MIXES = {"self": ("f32", "f32", "bf16"), "cross": ("bf16", "bf16", "bf16"),
         "f32": ("f32", "f32", "f32")}


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------------------- #
# the differentiable attention
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mix", sorted(MIXES))
def test_attention_backward_matches_pad_bwd(mix):
    rng = np.random.default_rng(4)
    BH, N = 4, 40
    q, k, v, g = (rng.normal(size=(BH, N, 64)).astype(np.float32)
                  for _ in range(4))
    mask = rng.uniform(size=(BH, N)) > 0.3
    mask[2] = False                                    # a fully masked head
    dts = MIXES[mix]
    jin = [jnp.asarray(a).astype(J_DT[d]) for a, d in zip((q, k, v), dts)]
    want = _pad_bwd((*jin, jnp.asarray(mask)), jnp.asarray(g))
    assert want[3].dtype == jax.dtypes.float0
    tin = [torch.from_numpy(a).to(T_DT[d]).requires_grad_()
           for a, d in zip((q, k, v), dts)]
    out = attention.MaskedAttentionFn.apply(*tin, torch.from_numpy(mask))
    np.testing.assert_array_equal(
        out.detach().numpy(), attention.plain_masked_attention(
            *(t.detach() for t in tin), torch.from_numpy(mask)).numpy())
    out.backward(torch.from_numpy(g))
    for t, w, d in zip(tin, want[:3], dts):
        assert t.grad.dtype == t.dtype
        w32 = np.asarray(w.astype(jnp.float32))
        scale = max(1.0, np.abs(w32).max()) if d == "f32" \
            else np.abs(w32).max()
        tol = 1e-5 if d == "f32" else 2.0 ** -8
        np.testing.assert_allclose(t.grad.float().numpy(), w32, rtol=0,
                                   atol=tol * scale)


def test_attention_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 8, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    mask = torch.tensor([[True, False, True, True, False], [False] * 5])
    assert torch.autograd.gradcheck(attention.MaskedAttentionFn.apply,
                                    (q, k, v, mask))


def test_cpu_dispatch_differentiates_the_plain_version():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 6, 64, generator=g, requires_grad=True)
               for _ in range(3))
    mask = torch.rand(2, 6, generator=g) > 0.3
    before = (attention.cuda_masked_attention.launches,
              attention.MaskedAttentionFn.launches)
    a = torch.autograd.grad(attention.masked_attention(q, k, v, mask).sum(),
                            (q, k, v))
    b = torch.autograd.grad(attention.MaskedAttentionFn.apply(q, k, v, mask)
                            .sum(), (q, k, v))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    assert (attention.cuda_masked_attention.launches,
            attention.MaskedAttentionFn.launches) == before


# --------------------------------------------------------------------------- #
# the loss and its gradients
# --------------------------------------------------------------------------- #

B, H, W, G = 2, 48, 48, 16
DESC, DIM, LAYERS = 32, 32, 2


@pytest.fixture(scope="module")
def jax_params():
    """``init_aliked`` / ``init_lightglue``'s parameters, initialised under
    ``jax.jit`` (the same values, a fraction of the time)."""
    ka, kl = jax.random.split(jax.random.PRNGKey(0))
    pa = jax.jit(lambda k: jaliked.ALIKED(desc_dim=DESC).init(
        k, jnp.zeros((1, H, W, 1))))(ka)
    z2, zd = jnp.zeros((1, G, 2)), jnp.zeros((1, G, DESC))
    zv = jnp.ones((1, G), bool)
    pl = jax.jit(lambda k: jlg.LightGlue(dim=DIM, heads=4, n_layers=LAYERS)
                 .init(k, z2, zd, zv, z2, zd, zv, (480, 640)))(kl)
    return {"aliked": pa, "lightglue": pl}


def _batch(seed):
    return {k: np.asarray(v) for k, v in jtrain.synthetic_pair_batch(
        jax.random.PRNGKey(seed), B=B, H=H, W=W, G=G).items() if k != "Hmats"}


def _port_models(params, dt):
    sd_a, sd_l = from_jax_params(_np_tree(params["aliked"]),
                                 _np_tree(params["lightglue"]))
    a = taliked.ALIKED(desc_dim=DESC, dtype=dt)
    a.load_state_dict(sd_a, strict=True)
    lg = tlg.LightGlue(desc_dim=DESC, dim=DIM, n_layers=LAYERS, dtype=dt)
    lg.load_state_dict(sd_l, strict=True)
    return {"aliked": a, "lightglue": lg}


def _grad_trees(models, grads):
    """Per-parameter gradients as the two flax trees."""
    out, i = [], 0
    for part in ("aliked", "lightglue"):
        names = [n for n, _ in models[part].named_parameters()]
        out.append(dict(zip(names, grads[i:i + len(names)])))
        i += len(names)
    return to_jax_params(*out)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_loss_and_gradients_match_reference(jax_params, precision):
    batch = _batch(7)
    jd = J_DT[precision]
    a_model = jaliked.ALIKED(desc_dim=DESC, dtype=jd)
    l_model = jlg.LightGlue(dim=DIM, heads=4, n_layers=LAYERS, dtype=jd)
    fn = jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True),
                 static_argnums=(1, 2, 4))
    (_, want), jgrads = fn(jax_params, a_model, l_model,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           (H, W))
    models = _port_models(jax_params, T_DT[precision])
    total, got = ttrain.loss_fn(
        models["aliked"], models["lightglue"],
        {k: torch.from_numpy(v) for k, v in batch.items()}, (H, W))
    grads = torch.autograd.grad(total, ttrain.param_list(models))
    term_tol = 1e-5 if precision == "f32" else 2.0 ** -8
    assert set(got) == set(want)
    for k in want:
        ref = float(want[k])
        assert abs(float(got[k]) - ref) <= term_tol * max(1.0, abs(ref)), k

    ta, tl = _grad_trees(models, grads)
    ours = {**{"a" + k: v for k, v in _leaves(ta).items()},
            **{"l" + k: v for k, v in _leaves(tl).items()}}
    ref = {**{"a" + k: v for k, v in _leaves(jgrads["aliked"]).items()},
           **{"l" + k: v for k, v in _leaves(jgrads["lightglue"]).items()}}
    assert set(ours) == set(ref)
    norms = {k: np.linalg.norm(ref[k]) for k in ref}
    top = max(norms.values())
    if precision == "f32":
        leaf_tol, floor = 1e-4, 1e-4
    else:
        leaf_tol, floor = 0.1, 1e-2
        flat_o = np.concatenate([ours[k].ravel() for k in sorted(ref)])
        flat_r = np.concatenate([ref[k].ravel() for k in sorted(ref)])
        assert np.linalg.norm(flat_o - flat_r) <= 2e-2 * np.linalg.norm(
            flat_r)
    for k in ref:
        err = np.linalg.norm(ours[k] - ref[k])
        if norms[k] >= floor * top:
            assert err <= leaf_tol * norms[k], (k, err, norms[k])
        elif precision == "f32":
            assert err <= 1e-6 * top, (k, err, top)


# --------------------------------------------------------------------------- #
# the optimizer chain and the step
# --------------------------------------------------------------------------- #

LR, WARMUP, TOTAL = 1e-3, 1, 4


@pytest.fixture(scope="module")
def optax_tx():
    """The reference's own tx, from ``make_train_state`` (its models, which
    the chain does not depend on, replaced by one leaf)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "make_models",
                   lambda key, **kw: (None, None, {"x": jnp.zeros(1)}))
        return jtrain.make_train_state(jax.random.PRNGKey(0), lr=LR,
                                       warmup=WARMUP, total_steps=TOTAL)[2]


@pytest.mark.parametrize("lr,warmup,total", [(2e-4, 100, 4000),
                                             (1e-2, 2, 6), (1e-3, 0, 3)])
def test_schedule_matches_optax(lr, warmup, total):
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(total, warmup + 1), lr * 0.1)
    chain = ttrain.AdamWChain(lr, warmup, total)
    for count in [0, 1, 2, 3, 5, 50, 99, 100, 101, 2000, 3999, 4000, 5000]:
        np.testing.assert_allclose(chain.schedule(count),
                                   float(sched(count)), rtol=1e-5, atol=0)
    assert chain.schedule(0) == 0.0 or warmup == 0


def test_optimizer_chain_matches_optax(optax_tx):
    tx = optax_tx
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    state = tx.init(params)
    chain = ttrain.AdamWChain(LR, WARMUP, TOTAL)
    flat = torch.from_numpy(np.concatenate([params["a"].ravel(),
                                            params["b"]]))
    ostate = chain.init(flat)
    for step in range(5):
        ga = rng.normal(size=(3, 4)).astype(np.float32) * 0.1
        gb = rng.normal(size=(5,)).astype(np.float32) * 0.1
        if step == 1:
            ga[0, 0], gb[2] = np.nan, np.inf           # sanitised to 0
        if step in (2, 4):
            ga *= 40.0                                  # norm above 1: clipped
        if step == 4:
            gb[0] = -np.inf
        grads = {"a": ga, "b": gb}
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
        before = flat.clone()
        ostate, gnorm = chain.update_(
            flat, torch.from_numpy(np.concatenate([ga.ravel(), gb])), ostate)
        if step == 0:
            assert torch.equal(flat, before)           # lr(0) = 0
        want = np.concatenate([params["a"].ravel(), params["b"]])
        np.testing.assert_allclose(flat.numpy(), want, rtol=1e-6, atol=1e-7)
        g = np.concatenate([ga.ravel(), gb])
        np.testing.assert_allclose(
            float(gnorm), np.linalg.norm(np.where(np.isfinite(g), g, 0)),
            rtol=1e-6)
    assert ostate.count == 5


def test_three_train_steps_match_reference(jax_params, optax_tx):
    tx = optax_tx
    a_model = jaliked.ALIKED(desc_dim=DESC, dtype=jnp.float32)
    l_model = jlg.LightGlue(dim=DIM, heads=4, n_layers=LAYERS,
                            dtype=jnp.float32)
    jstate = jtrain.TrainState(jax_params, tx.init(jax_params), jnp.int32(0))
    jstep = jtrain.make_train_step(a_model, l_model, tx, (H, W))
    sds = from_jax_params(_np_tree(jax_params["aliked"]),
                          _np_tree(jax_params["lightglue"]))
    chain, state = ttrain.make_train_state(
        torch.Generator().manual_seed(0), lr=LR, warmup=WARMUP,
        total_steps=TOTAL, device="cpu", state_dicts=sds, desc_dim=DESC,
        dim=DIM, n_layers=LAYERS, dtype=torch.float32)
    step = ttrain.make_train_step(chain, (H, W))
    for i in range(3):
        batch = _batch(20 + i)
        jstate, want = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, got = step(state, ttrain.batch_to_device(batch, "cpu"))
        for k in want:
            ref = float(want[k])
            assert abs(float(got[k]) - ref) <= 1e-5 * max(1.0, abs(ref)), \
                (i, k)
    assert state.step == 3 and state.opt_state.count == 3
    ta, tl = to_jax_params(state.models["aliked"].state_dict(),
                           state.models["lightglue"].state_dict())
    for ours, ref in ((ta, jstate.params["aliked"]),
                      (tl, jstate.params["lightglue"])):
        o, r = _leaves(ours), _leaves(ref)
        assert set(o) == set(r)
        for k in r:
            np.testing.assert_allclose(o[k], r[k], rtol=0, atol=1.5e-5,
                                       err_msg=k)
    # the modules' parameters are views of the state's flat buffer
    assert state.models["aliked"].desc_head.weight.data_ptr() >= \
        state.flat.data_ptr()


# --------------------------------------------------------------------------- #
# weights out and back
# --------------------------------------------------------------------------- #

def test_to_jax_params_inverts_from_jax_params(jax_params):
    trees = (_np_tree(jax_params["aliked"]), _np_tree(jax_params["lightglue"]))
    back = to_jax_params(*from_jax_params(*trees))
    for t, b in zip(trees, back):
        lt, lb = _leaves(t), _leaves(b)
        assert set(lt) == set(lb)
        for k in lt:
            assert lb[k].dtype == np.float32
            np.testing.assert_array_equal(lb[k], lt[k])
    sds = from_jax_params(*trees)
    again = from_jax_params(*to_jax_params(*sds))
    for s, a in zip(sds, again):
        assert set(s) == set(a)
        for k in s:
            assert torch.equal(s[k], a[k])


TINY = ["--device", "cpu", "--batch", "1", "--hw", "48", "64", "--points",
        "8", "--scene_views", "2", "--scenes", "1", "--render_hw", "64", "96"]


def test_cli_writes_weights_that_serve(tmp_path, monkeypatch):
    out = str(tmp_path / "w.npz")
    hist = []
    assert train_frontend.main(TINY + ["--steps", "2", "--out", out],
                               history=hist) == 0
    assert len(hist) == 2 and all(np.isfinite(r["metrics"]["total"])
                                  for r in hist)
    tree = checkpoint.load_frontend_tree(out, on_error="raise")
    sds = from_jax_params(tree["aliked"], tree["lightglue"])
    ext = LearnedExtractor(128, device="cpu", state_dict=sds[0])
    mat = LearnedMatcher(ext, state_dict=sds[1])
    from simpleslam_tpu_torch.tools.synth import CorridorScene, make_trajectory
    T = make_trajectory(3)
    scene = CorridorScene(seed=0, hw=(96, 160), device="cpu")
    f0, f1 = (ext.fn(scene.render(T[i]).float()) for i in (0, 2))
    m = mat.fn(f0, f1)
    assert torch.isfinite(f0.desc).all() and m.idx0.shape == (128,)
    # SLAM_FRONTEND_CKPT serves the file by default
    monkeypatch.setenv(checkpoint.ENV_VAR, out)
    ext2 = LearnedExtractor(128, device="cpu")
    for k, v in ext2.model.state_dict().items():
        assert torch.equal(v, sds[0][k]), k
    # and a file this CLI wrote warm-starts it (on homography pairs only)
    out2 = str(tmp_path / "w2.npz")
    hist = []
    assert train_frontend.main(TINY + ["--steps", "1", "--init_from", out,
                                       "--scene_frac", "0", "--out", out2],
                               history=hist) == 0
    assert np.isfinite(hist[0]["metrics"]["total"])


def test_cli_first_step_keeps_the_repository_tree(tmp_path):
    """lr(0) = 0: one step from the repository's trained tree writes that
    tree back bit for bit, through the port's reader and writer."""
    out = str(tmp_path / "one.npz")
    assert train_frontend.main(TINY + ["--steps", "1", "--init_from",
                                       checkpoint.DEFAULT_DIR, "--out",
                                       out]) == 0
    want = checkpoint.load_frontend_tree(checkpoint.DEFAULT_DIR,
                                         on_error="raise")
    got = checkpoint.load_frontend_tree(out, on_error="raise")
    lw, lg = _leaves(want), _leaves(got)
    assert set(lw) == set(lg) and len(lw) == 289
    for k in lw:
        np.testing.assert_array_equal(lg[k], lw[k], err_msg=k)


def test_cli_without_a_gpu_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_frontend.main(["--steps", "1", "--out",
                             str(tmp_path / "x.npz")])
    assert not os.path.exists(tmp_path / "x.npz")


@pytest.mark.parametrize("extra", [["--real_frac", "0.5"],
                                   ["--families", "boxes"],
                                   ["--families", "corridor,photo"]])
def test_cli_rejects_what_is_not_ported(extra, tmp_path, monkeypatch):
    """The photograph pairs (``--real_frac``) and the other scene families
    train: two steps at TINY on photographs written here, finite losses,
    the pools each step drew recorded."""
    import chip_smoke
    from simpleslam_tpu_torch.tools import synth as tsynth
    rng = np.random.default_rng(0)
    views = [rng.integers(0, 256, (96, 128), np.uint8) for _ in range(4)]
    chip_smoke.write_photos(str(tmp_path / "ph"), views + views)
    monkeypatch.setattr(tsynth, "REAL_PHOTO_GLOB",
                        str(tmp_path / "ph" / "*"))
    hist = []
    argv = TINY + ["--steps", "2", "--out", str(tmp_path / "x.npz")] + extra
    argv[argv.index("--scenes") + 1] = "2"
    assert train_frontend.main(argv, history=hist) == 0
    assert len(hist) == 2 and os.path.exists(tmp_path / "x.npz")
    assert all(np.isfinite(v) for r in hist for v in r["metrics"].values())
    assert {r["source"] for r in hist} <= {"photo", "scene", "synthetic"}
