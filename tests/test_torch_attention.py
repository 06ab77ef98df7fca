"""Masked attention: the port's plain version against the JAX package's
XLA path and its Pallas kernel (interpret mode on the CPU). The CUDA
kernel against the plain version is in test_torch_kernels_cuda.py, which
imports no JAX so that it runs on the GPU machine.

Tolerance 2e-5 absolute: both sides compute in float32, and the only
difference is the order of the sums."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from simpleslam_tpu.ops.pallas.attention import (pallas_masked_attention,
                                                 xla_masked_attention)
from simpleslam_tpu_torch.ops import attention

TOL = 2e-5


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
