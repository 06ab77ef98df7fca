"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the reproducibility of BA's sums, on an NVIDIA GPU. Imports
no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Every test here skips without a GPU (a CUDA kernel has no CPU mode).

Tolerances. Against the plain float32 version, TOL = 2e-5 absolute on
unit-normal inputs, and scaled by max(1, max|v|) where v is scaled (the
output is a softmax-weighted average of v and carries its scale). The kernel's products are float32-accurate but not float32
products: float32 q k^T is three TF32 passes (hi.hi + hi.lo + lo.hi, each
part rounded to TF32, about 2^-21 relative per product) and P v two bf16
passes of a hi/lo-split P (about 2^-17 relative), accumulated in float32 on
the tensor cores; plain float32 rounds each product and sum once. At
trained-scale logits (|logit| ~ 800) float32 itself is off by ~3e-5 of
max|v|, so there both are held to a float64 run at TRAINED_TOL = 1e-4 of
max(1, max|v|) (the CPU emulation of the scheme reads 1.9e-5 there,
tests/test_torch_attention.py).

The backward kernel is held to the float64 VJP at GRAD_TOL (each
gradient's worst error over its largest entry: 5e-4 float32, 2^-5 bf16),
the bound its CPU emulation meets on a training step's attention calls
from the trained tree (tests/test_torch_attention_bwd.py); plain float32's
own distance is reported beside it."""
import numpy as np
import pytest
import torch

from simpleslam_tpu_torch.ops import attention

TOL = 2e-5
TRAINED_TOL = 1e-4
# The backward kernel against the float64 VJP, each gradient's worst error
# over its largest entry: the bound its CPU emulation meets on a training
# step's attention calls from the trained tree, about 5x that reading and
# plain float32's (tests/test_torch_attention_bwd.py).
GRAD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2.0 ** -5}
F32, BF16 = torch.float32, torch.bfloat16
MIXES = {"self": (F32, F32, BF16), "cross": (BF16, BF16, BF16),
         "f32": (F32, F32, F32)}


def _inputs(seed, BH, N, d=64, dead_head=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(BH, N, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(BH, N)) > 0.3
    if dead_head is not None:
        mask[dead_head] = False
    return q, k, v, mask


def _heads_view(a, dtype, device):
    """(BH, N, 64) as LightGlue lays it out at batch 1: one (1, N, BH*64)
    projection split into heads, a strided view (strides (64, BH*64, 1))."""
    BH, N, d = a.shape
    full = torch.from_numpy(np.ascontiguousarray(a.transpose(1, 0, 2))
                            ).reshape(1, N, BH * d).to(device, dtype)
    return full.reshape(1, N, BH, d).transpose(1, 2).reshape(BH, N, d)


def _reference64(q, k, v, mask):
    """The function in float64 (the plain version computes in float32)."""
    logits = q.double() @ k.double().transpose(1, 2) / 8.0
    logits = torch.where(mask[:, None, :], logits,
                         torch.full_like(logits, -1e9))
    return torch.softmax(logits, -1) @ v.double()


def _err(got, want, v, live):
    return ((got.double() - want.double()).abs()[live].max().item()
            / max(1.0, v.float().abs().max().item()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Nq,Nk,mix", [
    (4, 256, 256, "f32"), (4, 2048, 2048, "f32"), (4, 2048, 2048, "cross"),
    (3, 200, 77, "f32"), (4, 256, 256, "self"), (4, 2048, 2048, "self"),
    (3, 200, 77, "self"), (3, 200, 77, "cross"), (4, 4096, 4096, "f32"),
    (4, 4096, 4096, "self"), (4, 4096, 4096, "cross")])
def test_masked_attention_kernel_matches_plain(cuda, BH, Nq, Nk, mix):
    """Contiguous operands in each dtype mix, with a fully masked head."""
    q, _k, _v, _m = _inputs(6, BH, Nq)
    _q, k, v, mask = _inputs(7, BH, Nk, dead_head=BH - 1)
    qt, kt, vt = (torch.from_numpy(a).to(cuda, t)
                  for a, t in zip((q, k, v), MIXES[mix]))
    mt = torch.from_numpy(mask).to(cuda)
    before = attention.cuda_masked_attention.launches
    got = attention.masked_attention(qt, kt, vt, mt)
    torch.cuda.synchronize()
    assert attention.cuda_masked_attention.launches == before + 1
    want = attention.plain_masked_attention(qt, kt, vt, mt)
    assert torch.isfinite(got).all()
    live = torch.from_numpy(mask.any(1)).to(cuda)
    err = (got - want).abs()[live].max().item()
    assert err <= TOL, err


@pytest.mark.cuda
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("BH,Nq,Nk", [(4, 2048, 2048), (4, 4096, 4096),
                                      (4, 200, 77)])
def test_masked_attention_kernel_takes_lightglue_views(cuda, BH, Nq, Nk, mix):
    """Strided q/k/v views and a broadcast mask (head stride 0), as
    models/lightglue.py hands them over, give the result of contiguous
    copies; the call is one launch and the views are not copied."""
    q, _k, _v, _m = _inputs(9, BH, Nq)
    _q, k, v, mask = _inputs(10, BH, Nk)
    tq, tk, tv = MIXES[mix]
    qv, kv, vv = _heads_view(q, tq, cuda), _heads_view(k, tk, cuda), \
        _heads_view(v, tv, cuda)
    assert not qv.is_contiguous() and qv.stride() == (64, BH * 64, 1)
    mv = torch.from_numpy(mask[:1]).to(cuda)[:, None, :].expand(
        1, BH, Nk).reshape(BH, Nk)
    assert mv.stride() == (0, 1)
    before = attention.cuda_masked_attention.launches
    got = attention.cuda_masked_attention(qv, kv, vv, mv)
    assert attention.cuda_masked_attention.launches == before + 1
    want = attention.cuda_masked_attention(
        *(t.contiguous() for t in (qv, kv, vv, mv)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    plain = attention.plain_masked_attention(qv, kv, vv, mv)
    assert _err(got, plain, vv, mv.any(1)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["self", "f32"])
def test_masked_attention_kernel_at_trained_scale(cuda, mix):
    """q and k scaled so that max|logit| is ~800, as the trained matcher's
    self-attention reaches, and |v| up to ~45: the kernel against float64
    (plain float32's own error is in the message)."""
    BH, N = 4, 1024
    q, k, v, mask = _inputs(11, BH, N)
    logits = np.einsum("bnd,bmd->bnm", q, k) / 8.0
    c = np.sqrt(800.0 / np.abs(logits).max())
    qt, kt, vt = (torch.from_numpy(a).to(cuda, t) for a, t in
                  zip((q * c, k * c, 10.0 * v), MIXES[mix]))
    mt = torch.from_numpy(mask).to(cuda)
    ref = _reference64(qt, kt, vt, mt)
    assert 700 < (qt.double() @ kt.double().transpose(1, 2)).abs().max() / 8
    got = attention.cuda_masked_attention(qt, kt, vt, mt)
    plain = attention.plain_masked_attention(qt, kt, vt, mt)
    live = mt.any(1)
    err = _err(got, ref, vt, live)
    assert err <= TRAINED_TOL, (err, _err(plain, ref, vt, live))


@pytest.mark.cuda
def test_masked_attention_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v, mask = _inputs(8, 2, 64, d=32)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, mask)]
    with pytest.raises(ValueError, match="head dim 64"):
        attention.cuda_masked_attention(*args)
    q, k, v, mask = (torch.from_numpy(a).to(cuda)
                     for a in _inputs(8, 2, 64))
    with pytest.raises(ValueError, match="dtypes"):
        attention.cuda_masked_attention(q.bfloat16(), k.bfloat16(), v, mask)
    with pytest.raises(ValueError, match="dtypes"):
        attention.cuda_masked_attention(q, k.bfloat16(), v.bfloat16(), mask)
    with pytest.raises(ValueError, match="contiguous head dim"):
        wide = torch.cat([q, q], -1)[..., ::2]
        attention.cuda_masked_attention(wide, k, v, mask)
    before = attention.cuda_masked_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        misaligned = q.reshape(2, 32, 128)[..., 1:65]
        attention.cuda_masked_attention(misaligned, k[:, :32], v[:, :32],
                                        mask[:, :32])
    # each variant's key limit: all-float32 holds 24064 keys, the
    # self-attention mix (bf16 v) 286208
    k_long = torch.randn(1, 24065, 64, device=cuda)
    m_long = torch.ones(1, 24065, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="at most 24064 keys"):
        attention.cuda_masked_attention(q[:1], k_long, k_long, m_long)
    assert attention.cuda_masked_attention.launches == before
    out = attention.cuda_masked_attention(q[:1], k_long, k_long.bfloat16(),
                                          m_long)
    assert torch.isfinite(out).all()


def _grad_errors(got, q, k, v, mask, g):
    """Each of dq, dk, dv against the float64 VJP, over its largest entry:
    [(dtype, kernel error, plain float32's error)]."""
    want = attention.plain_masked_attention_bwd(q.double(), k.double(),
                                                v.double(), mask, g.double())
    plain = attention.plain_masked_attention_bwd(q, k, v, mask, g)
    out = []
    for a, p, w in zip(got, plain, want):
        assert a.dtype == p.dtype and a.shape == w.shape
        scale = w.abs().max().item() or 1.0   # all zero (a lone key): absolute
        out.append((a.dtype, (a.double() - w).abs().max().item() / scale,
                    (p.double() - w).abs().max().item() / scale))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["self", "cross"])
def test_masked_attention_diff_forward_is_the_kernel(cuda, mix):
    """At training shapes (BH 32, N 96) with gradients: the forward is one
    kernel launch, the serving kernel's output bit for bit, within TOL of
    the plain version; the backward is one call of the backward kernel
    (and no plain op), its dq, dk and dv within GRAD_TOL of the float64
    VJP; a call without gradients goes straight to the kernel."""
    q, k, v, mask = _inputs(17, 32, 96, dead_head=5)
    g = torch.from_numpy(_inputs(18, 32, 96)[0]).to(cuda)
    dts = MIXES[mix]
    leaves = [torch.from_numpy(a).to(cuda, t).requires_grad_()
              for a, t in zip((q, k, v), dts)]
    mt = torch.from_numpy(mask).to(cuda)
    n_kernel = attention.cuda_masked_attention.launches
    n_diff = attention.MaskedAttentionFn.launches
    n_bwd = attention.cuda_masked_attention_bwd.launches
    out = attention.masked_attention(*leaves, mt)
    assert attention.cuda_masked_attention.launches == n_kernel + 1
    assert attention.MaskedAttentionFn.launches == n_diff + 1
    got = torch.autograd.grad(out, leaves, g)
    assert attention.cuda_masked_attention_bwd.launches == n_bwd + 1
    torch.cuda.synchronize()
    detached = [t.detach() for t in leaves]
    assert torch.equal(out, attention.cuda_masked_attention(*detached, mt))
    plain = attention.plain_masked_attention(*detached, mt)
    live = mt.any(1)
    assert (out - plain).abs()[live].max().item() <= TOL
    errs = _grad_errors(got, *detached, mt, g)
    assert all(e <= GRAD_TOL[dt] for dt, e, _p in errs), errs
    assert not got[0][5].float().abs().any()     # the dead head
    assert not got[1][5].float().abs().any()
    with torch.no_grad():
        attention.masked_attention(*leaves, mt)
    assert attention.MaskedAttentionFn.launches == n_diff + 1
    assert attention.cuda_masked_attention.launches == n_kernel + 3


@pytest.mark.cuda
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("BH,Nq,Nk,layout", [
    (32, 96, 96, "views"), (4, 200, 77, "views"), (3, 200, 77, "contiguous"),
    (4, 2048, 2048, "contiguous"), (4, 2048, 2048, "views"),
    # Nq != Nk across the tile and cluster edges: 3 query + 5 key blocks
    # of 128 rows (one cluster of 8), 3 + 6 (two launches), ragged tiles
    (2, 300, 600, "contiguous"), (2, 300, 700, "views"),
    (3, 33, 300, "contiguous"), (2, 64, 65, "contiguous"),
    (2, 1, 1, "contiguous")])
def test_masked_attention_bwd_kernel_matches_float64(cuda, BH, Nq, Nk,
                                                     layout, mix):
    """The backward kernel's dq, dk, dv within GRAD_TOL of the float64 VJP
    (each over its largest entry; plain float32's own distance is in the
    message): contiguous operands with a fully masked head, and the strided
    views LightGlue hands over with a broadcast mask and a strided upstream
    gradient, which give the bits of contiguous copies without a copy."""
    q, _k, _v, _m = _inputs(19, BH, Nq)
    _q, k, v, mask = _inputs(20, BH, Nk, dead_head=BH - 1)
    g = _inputs(21, BH, Nq)[0]
    if layout == "views":
        qt, kt, vt = (_heads_view(a, t, cuda)
                      for a, t in zip((q, k, v), MIXES[mix]))
        gt = _heads_view(g, F32, cuda)
        mt = torch.from_numpy(mask[:1]).to(cuda)[:, None, :].expand(
            1, BH, Nk).reshape(BH, Nk)
        assert not gt.is_contiguous() and mt.stride() == (0, 1)
    else:
        qt, kt, vt = (torch.from_numpy(a).to(cuda, t)
                      for a, t in zip((q, k, v), MIXES[mix]))
        gt = torch.from_numpy(g).to(cuda)
        mt = torch.from_numpy(mask).to(cuda)
    copies = attention.cuda_masked_attention_bwd.g_copies
    got = attention.cuda_masked_attention_bwd(qt, kt, vt, mt, gt)
    assert attention.cuda_masked_attention_bwd.g_copies == copies
    again = attention.cuda_masked_attention_bwd(qt, kt, vt, mt, gt)
    torch.cuda.synchronize()
    assert all(torch.isfinite(a.float()).all() for a in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if layout == "views":
        want = attention.cuda_masked_attention_bwd(
            *(t.contiguous() for t in (qt, kt, vt, mt, gt)))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        assert not got[0][-1].float().abs().any()
        assert not got[1][-1].float().abs().any()
    errs = _grad_errors(got, qt, kt, vt, mt, gt)
    assert all(e <= GRAD_TOL[dt] for dt, e, _p in errs), errs


@pytest.mark.cuda
@pytest.mark.parametrize("BH,N", [(8, 96), (3, 600)])
@pytest.mark.parametrize("mix", ["self", "cross"])
@pytest.mark.parametrize("needs", [(True, False, False),
                                   (False, True, False),
                                   (False, False, True),
                                   (False, True, True)])
def test_masked_attention_bwd_kernel_computes_what_is_needed(cuda, needs,
                                                             mix, BH, N):
    """A gradient that is not needed is not computed (its pointer is null:
    no pass 2 without dq, no key blocks without dk and dv); the ones that
    are equal the full call's bit for bit, in one launch (N 96) and in two
    (N 600, pass 1 split over two key halves)."""
    q, k, v, mask = _inputs(24, BH, N, dead_head=min(3, BH - 1))
    qt, kt, vt = (torch.from_numpy(a).to(cuda, t)
                  for a, t in zip((q, k, v), MIXES[mix]))
    mt = torch.from_numpy(mask).to(cuda)
    g = torch.randn(BH, N, 64, device=cuda)
    full = attention.cuda_masked_attention_bwd(qt, kt, vt, mt, g)
    part = attention.cuda_masked_attention_bwd(qt, kt, vt, mt, g,
                                               needs=needs)
    torch.cuda.synchronize()
    for a, b, need in zip(part, full, needs):
        assert (a is not None) == need
        if need:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_masked_attention_bwd_kernel_at_its_key_limit(cuda, mix):
    """Nk = the kernel's own limit (its shared memory does not grow with
    Nk) against a ragged query count: within GRAD_TOL of float64, in two
    launches."""
    _fn, max_keys = attention._bind_bwd()
    Nk = max_keys[(0, 0)]
    g = torch.Generator(device="cpu").manual_seed(25)
    q = torch.randn(1, 70, 64, generator=g)
    k, v = (torch.randn(1, Nk, 64, generator=g) for _ in range(2))
    mask = torch.rand(1, Nk, generator=g) > 0.3
    qt, kt, vt = (t.to(cuda, dt) for t, dt in zip((q, k, v), MIXES[mix]))
    mt, gt = mask.to(cuda), torch.randn(1, 70, 64, device=cuda)
    assert attention.bwd_kernels_per_call(70, Nk) == 2
    got = attention.cuda_masked_attention_bwd(qt, kt, vt, mt, gt)
    torch.cuda.synchronize()
    errs = _grad_errors(got, qt, kt, vt, mt, gt)
    assert all(e <= GRAD_TOL[dt] for dt, e, _p in errs), errs


@pytest.mark.cuda
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_masked_attention_bwd_orientations_agree(cuda, mix):
    """The key blocks form S^T = k q^T and dP^T = v g^T, the query blocks
    S and dP (whose products the row statistics come from): the two must
    agree bit for bit. With one live key a head and logits near 800 (one
    float32 step there is 6e-5), P is exactly 1 and dP - D exactly 0 only
    if they do: then dq and dk are exactly 0 and dv is the sum of g over
    the queries (three TF32 passes of 1 * g, ~2^-21 relative; sharp where
    dv is float32, the all-float32 mix, whose S product the self mix
    shares). Heads put the live key in several key tiles and warps' rows,
    in one launch (N 96) and in two (N 1100)."""
    for N in (96, 1100):
        BH = 8
        g = torch.Generator(device="cpu").manual_seed(26)
        q, k, v = (torch.randn(BH, N, 64, generator=g) for _ in range(3))
        gt = torch.randn(BH, 8, 64, generator=g)
        mask = torch.zeros(BH, N, dtype=torch.bool)
        cols = [(5 + 37 * b) % N for b in range(BH)]
        for b, j in enumerate(cols):
            mask[b, j] = True
            k[b, j] = q[b, :8].mean(0)
        q = q[:, :8]
        logit = (q.double() @ k.double().transpose(1, 2))[
            torch.arange(BH), :, cols] / 8.0
        c = torch.sqrt(800.0 / logit.abs().max(1).values.clamp_min(1e-3))
        q, k = q * c[:, None, None], k * c[:, None, None]
        qt, kt, vt = (t.to(cuda, dt) for t, dt in zip((q, k, v), MIXES[mix]))
        mt, gc = mask.to(cuda), gt.to(cuda)
        dq, dk, dv = attention.cuda_masked_attention_bwd(qt, kt, vt, mt, gc)
        torch.cuda.synchronize()
        assert not dq.float().abs().any(), (N, dq.float().abs().max())
        assert not dk.float().abs().any(), (N, dk.float().abs().max())
        want = gt.double().sum(1)
        got = dv.double().cpu()[torch.arange(BH), cols]
        tol = 2e-6 * gt.double().abs().sum(1)
        if mix != "f32":   # dv rounds to bf16 once
            tol = tol + 2.0 ** -8 * want.abs()
        assert ((got - want).abs() <= tol).all(), (
            N, ((got - want).abs() / gt.double().abs().sum(1)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Nq,Nk,needs,kernels", [
    (32, 96, 96, (True, True, True), 1), (4, 200, 77, (True, True, True), 1),
    (2, 300, 600, (True, True, True), 1), (2, 300, 700, (True, True, True), 2),
    (4, 2048, 2048, (True, True, True), 2),
    (4, 2048, 2048, (True, False, False), 2)])
def test_masked_attention_bwd_kernels_per_call(cuda, BH, Nq, Nk, needs,
                                               kernels):
    """One backward call runs the device kernels the library says
    (torch.profiler): one where a head's blocks fit a cluster of 8, two
    (statistics, then gradients) otherwise, whatever is wanted. The profiler
    now and then records fewer device kernels than ran; a session is
    taken again, and the most kernels any of three sessions records
    counts."""
    from torch.profiler import ProfilerActivity, profile
    assert attention.bwd_kernels_per_call(Nq, Nk) == kernels
    q, _k, _v, _m = _inputs(28, BH, Nq)
    _q, k, v, mask = _inputs(29, BH, Nk)
    qt, kt, vt = (torch.from_numpy(a).to(cuda, t)
                  for a, t in zip((q, k, v), MIXES["self"]))
    mt = torch.from_numpy(mask).to(cuda)
    g = torch.randn(BH, Nq, 64, device=cuda)

    def call():
        attention.cuda_masked_attention_bwd(qt, kt, vt, mt, g, needs=needs)

    call()
    torch.cuda.synchronize()
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        names = max(names, seen, key=len)
    assert len(names) == kernels, names
    assert all("masked_attention_bwd_kernel" in n for n in names), names


@pytest.mark.cuda
def test_masked_attention_bwd_kernel_rejects_without_launch(cuda):
    """Past the key limit, and on what the kernel does not take, the
    wrapper raises before any launch; an upstream gradient without a
    contiguous head dim (``out.sum()``'s) is copied once, and counted."""
    q, k, v, mask = (torch.from_numpy(a).to(cuda) for a in _inputs(22, 2, 64))
    g = torch.randn(q.shape, device=cuda)
    _fn, max_keys = attention._bind_bwd()
    limit = max_keys[(0, 0)]
    assert limit >= 2048 and set(max_keys.values()) == {limit}
    before = attention.cuda_masked_attention_bwd.launches
    k_long = torch.zeros(1, limit + 1, 64, device=cuda)
    m_long = torch.ones(1, limit + 1, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match=f"at most {limit} keys"):
        attention.cuda_masked_attention_bwd(q[:1], k_long, k_long, m_long,
                                            g[:1])
    with pytest.raises(ValueError, match="g must be float32"):
        attention.cuda_masked_attention_bwd(q, k, v, mask, g.double())
    with pytest.raises(ValueError, match="dtypes"):
        attention.cuda_masked_attention_bwd(q, k.bfloat16(), v, mask, g)
    assert attention.cuda_masked_attention_bwd.launches == before
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    copies = attention.cuda_masked_attention_bwd.g_copies
    attention.MaskedAttentionFn.apply(*leaves, mask).sum().backward()
    assert attention.cuda_masked_attention_bwd.g_copies == copies + 1
    assert attention.cuda_masked_attention_bwd.launches == before + 1
    want = attention.plain_masked_attention_bwd(q, k, v, mask,
                                                torch.ones_like(q))
    for t, w in zip(leaves, want):
        assert (t.grad - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["self", "cross"])
def test_masked_attention_diff_kernels_per_call(cuda, mix):
    """One forward plus backward through the Function at (BH 32, N 96)
    runs exactly two device kernels (torch.profiler): the forward and the
    backward (statistics and gradients in one launch, a cluster a
    head)."""
    from torch.profiler import ProfilerActivity, profile
    q, k, v, mask = _inputs(23, 32, 96)
    leaves = [torch.from_numpy(a).to(cuda, t).requires_grad_()
              for a, t in zip((q, k, v), MIXES[mix])]
    mt = torch.from_numpy(mask).to(cuda)
    g = torch.randn(32, 96, 64, device=cuda)

    def call():
        torch.autograd.grad(attention.masked_attention(*leaves, mt), leaves,
                            g)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2, names
    assert sum("masked_attention_kernel" in n for n in names) == 1, names
    assert sum("masked_attention_bwd_kernel" in n for n in names) == 1, names


@pytest.mark.cuda
def test_ba_segment_sums_are_reproducible_on_cuda(cuda):
    """BA's block sums on the card come out the same on every run and
    equal the CPU's bit for bit (edge order within each segment)."""
    from simpleslam_tpu_torch.ops.ba import _segment_sum
    g = torch.Generator().manual_seed(0)
    index = torch.randint(0, 5000, (10000,), generator=g)
    values = torch.randn(10000, 6, 3, generator=g)
    runs = [_segment_sum(values.to(cuda), index.to(cuda), 5000).cpu()
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], _segment_sum(values, index, 5000))
