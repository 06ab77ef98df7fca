"""Masked attention: the port's plain version against the JAX package's
XLA path and its Pallas kernel (interpret mode on the CPU), and a CPU
emulation of the CUDA kernel's arithmetic on the trained matcher's own
attention inputs. The CUDA kernel against the plain version is in
test_torch_kernels_cuda.py, which imports no JAX so that it runs on the
GPU machine.

Tolerance 2e-5 absolute between the plain version and the reference: both
sides compute in float32, and the only difference is the order of the
sums. The emulation is held to float64 at EMU_TOL = 1e-4 of
max(1, max|v|) (see its test)."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simpleslam_tpu.models.pipeline import _load_repo_checkpoint
from simpleslam_tpu.ops.pallas.attention import (pallas_masked_attention,
                                                 xla_masked_attention)
from simpleslam_tpu.tools.synth import (DEFAULT_HW, DEFAULT_K, CorridorScene,
                                        make_trajectory)
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.models.pipeline import (LearnedExtractor,
                                                  LearnedMatcher,
                                                  from_jax_params)
from simpleslam_tpu_torch.ops import attention

TOL = 2e-5
EMU_TOL = 1e-4


def _inputs(seed, BH=4, N=256, d=64, dead_head=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(BH, N, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(BH, N)) > 0.3
    if dead_head is not None:
        mask[dead_head] = False
    return q, k, v, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_xla_reference(seed):
    q, k, v, mask = _inputs(seed)
    want = np.asarray(xla_masked_attention(*map(jnp.asarray, (q, k, v)),
                                           jnp.asarray(mask)))
    got = attention.plain_masked_attention(*map(torch.from_numpy,
                                                (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_plain_matches_pallas_interpret():
    q, k, v, mask = _inputs(2)
    want = np.asarray(pallas_masked_attention(
        *map(jnp.asarray, (q, k, v)), jnp.asarray(mask), block_q=128,
        interpret=True))
    got = attention.masked_attention(*map(torch.from_numpy,
                                          (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_fully_masked_head_finite_and_matches_reference():
    q, k, v, mask = _inputs(3, dead_head=1)
    got = attention.plain_masked_attention(*map(torch.from_numpy,
                                                (q, k, v, mask))).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(xla_masked_attention(*map(jnp.asarray, (q, k, v)),
                                           jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=TOL)


def test_bf16_inputs_upcast_like_reference():
    q, k, v, mask = _inputs(4, N=128)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = attention.plain_masked_attention(qb, kb, vb,
                                           torch.from_numpy(mask)).numpy()
    want = np.asarray(xla_masked_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (qb, kb, vb)), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=TOL)


def test_cpu_tensors_never_reach_the_kernel():
    q, k, v, mask = _inputs(5, N=64)
    before = attention.cuda_masked_attention.launches
    attention.masked_attention(*map(torch.from_numpy, (q, k, v, mask)))
    assert attention.cuda_masked_attention.launches == before
    with pytest.raises(ValueError):
        attention.cuda_masked_attention(*map(torch.from_numpy,
                                             (q, k, v, mask)))


# --------------------------------------------------------------------------- #
# The CUDA kernel's arithmetic, emulated in plain torch on the CPU
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


def emulate(q, k, v, mask, qk="split3_tf32", pv="split2_bf16"):
    """The kernel's function with its operand rounding: q k^T per 8-dim
    step as lo.hi + hi.lo + hi.hi of TF32 parts (``split3_tf32``; bf16 q
    and k take one exact pass), an online softmax over 64-key tiles in key
    groups (every G-th tile; G = 2 for float32 q, 3 for bf16) merged at the
    end, and P v as lo.v + hi.v of a bf16-split P (a float32 v split too). The other ``qk``/``pv``
    values are the schemes the kernel does not use: one bf16 pass, one
    TF32 pass, three bf16 passes."""
    BH, Nq, d = q.shape
    Nk = k.shape[1]
    if q.dtype == torch.bfloat16:
        S = q.float() @ k.float().transpose(1, 2)
    elif qk == "split3_tf32":
        qh, ql = _split(q, _tf32_rna)
        kh, kl = _split(k, _tf32_rna)
        S = torch.zeros(BH, Nq, Nk)
        for s in range(0, d, 8):
            c = slice(s, s + 8)
            S = S + ql[..., c] @ kh[..., c].transpose(1, 2)
            S = S + qh[..., c] @ kl[..., c].transpose(1, 2)
            S = S + qh[..., c] @ kh[..., c].transpose(1, 2)
    elif qk == "split3_bf16":
        qh, ql = _split(q, _bf16)
        kh, kl = _split(k, _bf16)
        S = (ql @ kh.transpose(1, 2) + qh @ kl.transpose(1, 2)
             + qh @ kh.transpose(1, 2))
    else:
        rnd = {"bf16": _bf16, "tf32": _tf32_trunc}[qk]
        S = rnd(q) @ rnd(k).transpose(1, 2)
    bias = torch.where(mask, 0.0, -1e9).float()
    S = S / math.sqrt(d) + bias[:, None, :]
    vf = v.float()
    parts = []
    n_groups = 3 if q.dtype == torch.bfloat16 else 2
    for grp in range(n_groups):
        M = torch.full((BH, Nq, 1), -math.inf)
        L = torch.zeros(BH, Nq, 1)
        O = torch.zeros(BH, Nq, d)
        for j0 in range(64 * grp, Nk, 64 * n_groups):
            st, vt = S[:, :, j0:j0 + 64], vf[:, j0:j0 + 64]
            M_new = torch.maximum(M, st.amax(-1, keepdim=True))
            corr, p = torch.exp(M - M_new), torch.exp(st - M_new)
            L = L * corr + p.sum(-1, keepdim=True)
            if pv == "split2_bf16":
                ph, pl = _split(p, _bf16)
                if v.dtype == torch.float32:
                    vh, vl = _split(vt, _bf16)
                    pv_t = ((pl @ vl + pl @ vh) + ph @ vl) + ph @ vh
                else:
                    pv_t = pl @ vt + ph @ vt
            else:
                rnd = {"bf16": _bf16, "tf32": _tf32_trunc}[pv]
                pv_t = rnd(p) @ rnd(vt)
            O = O * corr + pv_t
            M = M_new
        parts.append((M, L, O))
    Mx = torch.stack([M for M, _L, _O in parts]).amax(0)
    L = sum(L * torch.exp(M - Mx) for M, L, _O in parts)
    O = sum(O * torch.exp(M - Mx) for M, _L, O in parts)
    return O / torch.clamp(L, min=1e-30)


SCHEMES = {"kernel": {}, "one_pass_bf16": dict(qk="bf16", pv="bf16"),
           "one_pass_tf32": dict(qk="tf32", pv="tf32"),
           "three_pass_bf16": dict(qk="split3_bf16")}


def capture_trained_attention_calls():
    """q, k, v, mask of each of the 36 attention calls of a 9-layer
    LightGlue forward with the trained checkpoint (converted in memory as
    tests/test_torch_slam.py does), on ALIKED's 256 keypoints of two
    corridor frames at 160x512."""
    ck = _load_repo_checkpoint(on_error="raise")
    a_sd, l_sd = from_jax_params(jax.tree.map(np.asarray, ck["aliked"]),
                                 jax.tree.map(np.asarray, ck["lightglue"]))
    hw = (160, 512)
    K = DEFAULT_K.copy()
    K[0] *= hw[1] / DEFAULT_HW[1]
    K[1] *= hw[0] / DEFAULT_HW[0]
    scene = CorridorScene(seed=0, hw=hw, K=K)
    T_wc = make_trajectory(2, speed=1.0)
    ext = LearnedExtractor(256, device="cpu", state_dict=a_sd)
    mat = LearnedMatcher(ext, state_dict=l_sd)
    f0, f1 = (ext.fn(torch.from_numpy(scene.render(T)).float())
              for T in T_wc)
    calls = []

    def capture(q, k, v, m):
        calls.append((q.clone(), k.clone(), v.clone(), m.clone()))
        return attention.plain_masked_attention(q, k, v, m)

    orig = lg_mod.masked_attention
    lg_mod.masked_attention = capture
    try:
        with torch.no_grad():
            mat.model(f0.kpts[None], f0.desc[None], f0.valid[None],
                      f1.kpts[None], f1.desc[None], f1.valid[None], hw)
    finally:
        lg_mod.masked_attention = orig
    return calls


@pytest.fixture(scope="module")
def trained_attention_calls():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield capture_trained_attention_calls()
    torch.set_num_threads(n_threads)


def reference64(q, k, v, mask):
    """The function in float64 (the plain version computes in float32)."""
    logits = q.double() @ k.double().transpose(1, 2) / math.sqrt(q.shape[-1])
    logits = torch.where(mask[:, None, :], logits,
                         torch.full_like(logits, -1e9))
    return torch.softmax(logits, -1) @ v.double()


def _worst_error(calls, fn):
    """Worst error against float64 over the calls, over max(1, max|v|)."""
    worst = 0.0
    for q, k, v, m in calls:
        ref = reference64(q, k, v, m)
        err = (fn(q, k, v, m).double() - ref).abs()[m.any(1)].max().item()
        worst = max(worst, err / max(1.0, v.float().abs().max().item()))
    return worst


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_kernel_split_scheme_emulated_with_trained_weights(
        trained_attention_calls, scheme):
    """The kernel's scheme stays within EMU_TOL of float64 on the trained
    matcher's attention inputs (self-attention logits reach ~800 there),
    and each cheaper scheme exceeds it, so the bound separates them (CPU
    readings: kernel 1.9e-5, plain float32 2.5e-5, one bf16 pass 8e-2, one
    TF32 pass 1.3e-2, three bf16 passes 2.1e-4)."""
    calls = trained_attention_calls
    assert len(calls) == 36
    assert {str(c[0].dtype) for c in calls} == {"torch.float32",
                                                "torch.bfloat16"}
    max_logit = max((q.double() @ k.double().transpose(1, 2)).abs().max()
                    .item() / 8.0 for q, k, _v, _m in calls)
    assert max_logit > 500, max_logit
    worst = _worst_error(calls, lambda *a: emulate(*a, **SCHEMES[scheme]))
    if scheme == "kernel":
        plain = _worst_error(calls, attention.plain_masked_attention)
        assert worst <= EMU_TOL, (worst, plain)
    else:
        assert worst > EMU_TOL, worst


if __name__ == "__main__":
    # The emulation table of PERF.md: worst error / max(1, max|v|) against
    # float64, self-attention (float32 q, k) and cross-attention (bf16)
    # calls apart.
    torch.set_num_threads(1)
    all_calls = capture_trained_attention_calls()
    for name, calls in (("self", [c for c in all_calls
                                  if c[0].dtype == torch.float32]),
                        ("cross", [c for c in all_calls
                                   if c[0].dtype == torch.bfloat16])):
        logit = max((q.double() @ k.double().transpose(1, 2)).abs().max()
                    .item() / 8.0 for q, k, _v, _m in calls)
        row = {"plain_float32": _worst_error(
            calls, attention.plain_masked_attention)}
        for scheme, kw in SCHEMES.items():
            row[scheme] = _worst_error(calls,
                                       lambda *a, kw=kw: emulate(*a, **kw))
        print(name, f"max|logit| {logit:.1f}",
              {k: f"{v:.2e}" for k, v in row.items()})
