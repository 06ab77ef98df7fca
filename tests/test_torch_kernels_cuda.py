"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the reproducibility of BA's sums, on an NVIDIA GPU. Imports
no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Every test here skips without a GPU (a CUDA kernel has no CPU mode).
Tolerance 2e-5 absolute: kernel and plain version both compute in float32
and differ only in the order of the sums."""
import numpy as np
import pytest
import torch

from simpleslam_tpu_torch.ops import attention

TOL = 2e-5


def _inputs(seed, BH, N, d=64, dead_head=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(BH, N, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.uniform(size=(BH, N)) > 0.3
    if dead_head is not None:
        mask[dead_head] = False
    return q, k, v, mask


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Nq,Nk,dtype", [(4, 256, 256, torch.float32),
                                            (4, 2048, 2048, torch.float32),
                                            (4, 2048, 2048, torch.bfloat16),
                                            (3, 200, 77, torch.float32)])
def test_masked_attention_kernel_matches_plain(cuda, BH, Nq, Nk, dtype):
    q, _k, _v, _m = _inputs(6, BH, Nq)
    _q, k, v, mask = _inputs(7, BH, Nk, dead_head=BH - 1)
    qt, kt, vt = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
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
def test_masked_attention_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v, mask = _inputs(8, 2, 64, d=32)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v, mask)]
    with pytest.raises(ValueError, match="head dim 64"):
        attention.cuda_masked_attention(*args)


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
