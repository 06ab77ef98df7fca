"""The masked attention's backward on the CPU: the port's closed-form VJP
(``ops/attention.py::plain_masked_attention_bwd``) against the reference's
``_pad_bwd`` and against float64 autograd, ``MaskedAttentionFn``'s CPU
backward, and a CPU emulation of the backward kernel's arithmetic
(``csrc/masked_attention_bwd.cu``) on the attention calls of one training
step from the trained tree. The kernel itself against float64 is in
test_torch_kernels_cuda.py (it needs the card).

Tolerances:
- against ``_pad_bwd``: float32 gradients to 1e-5 of max(1, max|grad|) (the
  same expression, rounded in another order); bf16 gradients to 2^-8 of
  max|grad|, one bf16 step at the largest gradient (each side rounds a
  float32 result to bf16 once), as tests/test_torch_train.py states;
- against float64 autograd, in float64: 1e-12 (the same products);
- the emulation against float64, each gradient's worst error over its
  largest entry: GRAD_TOL[float32] = 5e-4, GRAD_TOL[bfloat16] = 2^-5 (see
  ``test_backward_split_scheme_emulated_with_trained_weights``).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from simpleslam_tpu.ops.pallas.attention import _pad_bwd
from simpleslam_tpu_torch.models import checkpoint
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.models import train as train_mod
from simpleslam_tpu_torch.models import train_frontend
from simpleslam_tpu_torch.models.pipeline import from_jax_params
from simpleslam_tpu_torch.ops import attention

GRAD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2.0 ** -5}
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
MIXES = {"self": ("f32", "f32", "bf16"), "cross": ("bf16", "bf16", "bf16"),
         "f32": ("f32", "f32", "f32")}
SHAPES = {"dead_head": (4, 40, 40), "ragged": (3, 37, 53)}


def _inputs(seed, BH, Nq, Nk):
    """q, k, v, g float32 and a mask with the last head fully masked."""
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(BH, Nq, 64)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(BH, Nk, 64)).astype(np.float32)
            for _ in range(2))
    mask = rng.uniform(size=(BH, Nk)) > 0.3
    mask[BH - 1] = False
    return q, k, v, mask, g


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_plain_backward_matches_pad_bwd(mix, shape):
    q, k, v, mask, g = _inputs(11, *SHAPES[shape])
    dts = MIXES[mix]
    jin = [jnp.asarray(a).astype(J_DT[d]) for a, d in zip((q, k, v), dts)]
    want = _pad_bwd((*jin, jnp.asarray(mask)), jnp.asarray(g))
    got = attention.plain_masked_attention_bwd(
        *(torch.from_numpy(a).to(T_DT[d]) for a, d in zip((q, k, v), dts)),
        torch.from_numpy(mask), torch.from_numpy(g))
    for t, w, d in zip(got, want[:3], dts):
        assert t.dtype == T_DT[d]
        w32 = np.asarray(w.astype(jnp.float32))
        scale = max(1.0, np.abs(w32).max()) if d == "f32" \
            else np.abs(w32).max()
        tol = 1e-5 if d == "f32" else 2.0 ** -8
        np.testing.assert_allclose(t.float().numpy(), w32, rtol=0,
                                   atol=tol * scale)
    # the fully masked head: no gradient to q or k, dv = the mean of g
    assert not got[0][-1].float().abs().any()
    assert not got[1][-1].float().abs().any()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_backward_matches_autograd_float64(shape):
    q, k, v, mask, g = (torch.from_numpy(a) for a in
                        _inputs(12, *SHAPES[shape]))
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    out = attention.plain_masked_attention(*leaves, mask)
    want = torch.autograd.grad(out, leaves, g.double())
    got = attention.plain_masked_attention_bwd(*(t.detach() for t in leaves),
                                               mask, g.double())
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("wanted", ["q", "kv", "v", "qkv"])
def test_function_cpu_backward_honours_needs_input_grad(wanted):
    """On CPU tensors the Function's backward is the closed-form VJP, gives
    exactly the gradients that were asked for, and never reaches a
    kernel."""
    q, k, v, mask, g = (torch.from_numpy(a) for a in _inputs(13, 3, 20, 24))
    leaves = [t.clone().requires_grad_(name in wanted)
              for t, name in zip((q, k, v), "qkv")]
    before = (attention.cuda_masked_attention.launches,
              attention.cuda_masked_attention_bwd.launches,
              attention.MaskedAttentionFn.launches)
    out = attention.MaskedAttentionFn.apply(*leaves, mask)
    out.backward(g)
    want = attention.plain_masked_attention_bwd(q, k, v, mask, g)
    for t, w, name in zip(leaves, want, "qkv"):
        if name in wanted:
            assert torch.equal(t.grad, w)
        else:
            assert t.grad is None
    assert (attention.cuda_masked_attention.launches,
            attention.cuda_masked_attention_bwd.launches,
            attention.MaskedAttentionFn.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.cuda_masked_attention_bwd(q, k, v, mask, g)


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("wanted", ["q", "kv", "v", "qkv"])
def test_bwd_buffers_are_disjoint_aligned_views(mix, wanted):
    """The backward kernel's outputs and statistics scratch: one buffer
    per dtype, each gradient a (BH, N, 64) view in its input's dtype (None
    where not wanted), the float32 statistics (2, BH, Nq, 4) first; every
    view 16-byte aligned and none overlapping another."""
    dts = [T_DT[d] for d in MIXES[mix]]
    q = torch.zeros(3, 37, 64, dtype=dts[0])
    k, v = (torch.zeros(3, 53, 64, dtype=dt) for dt in dts[1:])
    needs = tuple(name in wanted for name in "qkv")
    stats, grads = attention._bwd_buffers(q, k, v, needs)
    assert stats.dtype == torch.float32 and stats.shape == (2, 3, 37, 4)
    views = [stats]
    for t, x, need in zip((q, k, v), grads, needs):
        assert (x is not None) == need
        if need:
            assert x.dtype == t.dtype and x.shape == t.shape
            assert x.is_contiguous()
            views.append(x)
    spans = sorted((x.data_ptr(), x.data_ptr() + x.numel() * x.element_size())
                   for x in views)
    assert all(a % 16 == 0 for a, _b in spans)
    assert all(b <= a2 for (_a, b), (a2, _b2) in zip(spans, spans[1:]))
    assert len({x.untyped_storage().data_ptr() for x in views}) == len(
        {x.dtype for x in views})


# --------------------------------------------------------------------------- #
# The backward kernel's arithmetic, emulated in plain torch on the CPU
# --------------------------------------------------------------------------- #

def _tf32_rna(x):
    """float32 -> TF32 rounded to nearest, ties away (cvt.rna.tf32.f32)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """float32 -> TF32 as the tensor cores read an unrounded float32."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF
            ).view(torch.float32)


def _bf16(x):
    return x.float().to(torch.bfloat16).float()


def _split(x, rnd):
    hi = rnd(x)
    return hi, rnd(x - hi)


def _product(a, b, a_bf16, b_bf16, scheme):
    """a @ b as the kernel takes it (``kernel``): bf16 against bf16 one
    exact pass; a float32 operand against a bf16 one split into bf16 hi +
    lo, two passes, lo first; float32 against float32 lo.hi + hi.lo + hi.hi
    of TF32 parts per 8-deep step. ``one_pass_tf32`` / ``one_pass_bf16``
    round each operand once (schemes the kernel does not use)."""
    if scheme == "one_pass_tf32":
        return _tf32_trunc(a) @ _tf32_trunc(b)
    if scheme == "one_pass_bf16":
        return _bf16(a) @ _bf16(b)
    if a_bf16 and b_bf16:
        return a @ b
    if b_bf16:
        hi, lo = _split(a, _bf16)
        return lo @ b + hi @ b
    if a_bf16:
        hi, lo = _split(b, _bf16)
        return a @ lo + a @ hi
    ah, al = _split(a, _tf32_rna)
    bh, bl = _split(b, _tf32_rna)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for s in range(0, a.shape[-1], 8):
        c = slice(s, s + 8)
        out = out + al[..., c] @ bh[..., c, :]
        out = out + ah[..., c] @ bl[..., c, :]
        out = out + ah[..., c] @ bh[..., c, :]
    return out


def emulate_bwd(q, k, v, mask, g, scheme="kernel", stats="backward"):
    """The backward kernel's function with its operand rounding (see
    ``_product``): S, dP, dV = P^T g, dK = dS^T q, dQ = dS k. ``stats``
    says where P's row statistics and D come from:
      backward      the kernel's: max m, l = sum exp(S - m) and
                    D = sum exp(S - m) dP / l from this S and dP;
      forward_lse   a float32 log-sum-exp of the row, P = exp(S - lse),
                    D = rowsum(g * out) with the forward kernel's P v
                    (P split into bf16 hi + lo);
      forward_pair  (max, log-sum) as two floats, D as forward_lse.
    The last two are designs the kernel does not use (its source's header
    gives their readings)."""
    qk16, v16 = q.dtype == torch.bfloat16, v.dtype == torch.bfloat16
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    S = _product(qf, kf.transpose(1, 2), qk16, qk16, scheme) / 8
    dP = _product(gf, vf.transpose(1, 2), False, v16, scheme)
    live = mask[:, None, :]
    any_live = mask.any(1)[:, None, None]
    Sm = torch.where(live, S, -math.inf)
    m = Sm.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(Sm - m)
    l_sum = e.sum(-1, keepdim=True)
    if stats == "backward":
        P = e * (1 / l_sum)
        D = (e * dP).sum(-1, keepdim=True) / l_sum
    else:
        if stats == "forward_lse":
            P = torch.exp(Sm - (m + torch.log(l_sum)))
        else:
            P = torch.exp((Sm - m) - torch.log(l_sum))
        ph, pl = _split(P, _bf16)
        if v16:
            out = pl @ vf + ph @ vf
        else:
            vh, vl = _split(vf, _bf16)
            out = ((pl @ vl + pl @ vh) + ph @ vl) + ph @ vh
        D = (gf * out).sum(-1, keepdim=True)
    P = torch.where(any_live, P, 1.0 / k.shape[1])
    dS = torch.where(live & any_live, P * (dP - D), 0.0)
    dV = _product(P.transpose(1, 2), gf, False, False, scheme)
    dK = _product(dS.transpose(1, 2), qf, False, qk16, scheme) / 8
    dQ = _product(dS, kf, False, qk16, scheme) / 8
    return dQ.to(q.dtype), dK.to(k.dtype), dV.to(v.dtype)


SCHEMES = {"kernel": {}, "forward_lse": dict(stats="forward_lse"),
           "one_pass_tf32": dict(scheme="one_pass_tf32"),
           "one_pass_bf16": dict(scheme="one_pass_bf16")}
# read in the table below, not held to a side of GRAD_TOL
READINGS = {"forward_pair": dict(stats="forward_pair")}


def capture_training_attention_calls():
    """q, k, v, mask and upstream gradient of each of the 36 attention
    calls of one ``loss_and_grad`` at the pinned width (9 layers, dim 256),
    from the trained tree, on a homography batch of 2 at 144x256 with 96
    points (BH 8, N 96)."""
    tree = checkpoint.load_frontend_tree(checkpoint.DEFAULT_DIR,
                                         on_error="raise")
    sds = from_jax_params(tree["aliked"], tree["lightglue"])
    _tx, state = train_mod.make_train_state(
        torch.Generator().manual_seed(0), device="cpu", state_dicts=sds,
        desc_dim=train_frontend.DESC_DIM, dim=train_frontend.DIM,
        n_layers=train_frontend.N_LAYERS)
    batch = train_mod.synthetic_pair_batch(torch.Generator().manual_seed(0),
                                           2, 144, 256, 96)
    batch = {k: v for k, v in batch.items() if k != "Hmats"}
    calls = []

    def capture(q, k, v, m):
        out = attention.masked_attention(q, k, v, m)
        rec = [t.detach().clone() for t in (q, k, v, m)] + [None]
        out.register_hook(lambda grad: rec.__setitem__(4, grad.clone()))
        calls.append(rec)
        return out

    orig = lg_mod.masked_attention
    lg_mod.masked_attention = capture
    try:
        train_mod.loss_and_grad(state.models, batch, (144, 256))
    finally:
        lg_mod.masked_attention = orig
    return [tuple(c) for c in calls]


@pytest.fixture(scope="module")
def training_attention_calls():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield capture_training_attention_calls()
    torch.set_num_threads(n_threads)


def worst_grad_errors(calls, fn):
    """{dtype: worst error against float64 over the calls and dq, dk, dv,
    each over its largest entry}."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for q, k, v, m, g in calls:
        ref = attention.plain_masked_attention_bwd(q.double(), k.double(),
                                                   v.double(), m, g.double())
        for got, want in zip(fn(q, k, v, m, g), ref):
            err = (got.double() - want).abs().max() / want.abs().max()
            worst[got.dtype] = max(worst[got.dtype], err.item())
    return worst


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_backward_split_scheme_emulated_with_trained_weights(
        training_attention_calls, scheme):
    """The kernel's scheme stays within GRAD_TOL of float64 on a training
    step's attention calls from the trained tree (the self-attention's
    logits reach ~740 there), and the designs it rejects exceed it: a
    float32 forward log-sum-exp rounds P's row sums by ~3e-5, and one
    tensor-core pass is too coarse. CPU readings (one thread) over the
    float32 / bf16 gradients: kernel 9.0e-5 / 5.1e-3, plain float32
    9.8e-5 / 5.1e-3, forward lse 1.5e-3 / 0.57, one TF32 pass 0.042 /
    0.013, one bf16 pass 0.31 / 0.086; forward (max, log-sum) with D from
    the forward's output, a reading, 1.05e-4 / 0.033. GRAD_TOL is about
    5x the kernel's and plain float32's readings."""
    calls = training_attention_calls
    assert len(calls) == 36 and all(c[4] is not None for c in calls)
    assert {str(c[0].dtype) for c in calls} == {"torch.float32",
                                                "torch.bfloat16"}
    max_logit = max((q.double() @ k.double().transpose(1, 2)).abs().max()
                    .item() / 8.0 for q, k, _v, _m, _g in calls)
    assert max_logit > 500, max_logit
    worst = worst_grad_errors(
        calls, lambda *a: emulate_bwd(*a, **SCHEMES[scheme]))
    within = all(worst[dt] <= GRAD_TOL[dt] for dt in GRAD_TOL)
    if scheme == "kernel":
        assert within, worst
    else:
        assert not within, worst


if __name__ == "__main__":
    # The emulation's readings: worst error / max|grad| against float64,
    # float32 and bf16 gradients apart.
    torch.set_num_threads(1)
    all_calls = capture_training_attention_calls()
    logit = max((q.double() @ k.double().transpose(1, 2)).abs().max()
                .item() / 8.0 for q, k, _v, _m, _g in all_calls)
    print(f"max|logit| {logit:.1f}")
    rows = {"plain_float32": attention.plain_masked_attention_bwd}
    rows.update({s: (lambda *a, kw=kw: emulate_bwd(*a, **kw))
                 for s, kw in {**SCHEMES, **READINGS}.items()})
    for name, fn in rows.items():
        w = worst_grad_errors(all_calls, fn)
        print(name, {str(k)[6:]: f"{v:.2e}" for k, v in w.items()})
