"""Explicit randomness: a small key object in place of ``jax.random`` keys.

The JAX package threads ``jax.random`` keys through every RANSAC call and
derives the key of a (frame, decision site) as
``fold_in(fold_in(base, frame_no), site)`` (``simpleslam_tpu/core/fused.py``,
``SITE_*`` and ``frame_key``). The port keeps that derivation behind a
three-method interface, so any implementation can be passed in:

* ``fold_in(data) -> key``     derive a child key from an integer;
* ``split(num=2) -> keys``     derive ``num`` independent keys;
* ``randint(shape, high, device) -> int64 tensor`` uniform in
  ``[0, max(high, 1))``; ``high`` may be a 0-d tensor on the device.

:class:`TorchKey` is the default, backed by ``torch.Generator``. A key backed
by ``jax.random`` (written in the tests) makes the port draw exactly the
reference's minimal sets, which is how RANSAC parity is tested. Torch cannot
reproduce threefry draws, so production runs differ from the reference in
which samples they draw, not in what they do with them.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

SITE_PNP, SITE_PREV_MATCH, SITE_ESS, SITE_RELOC = 0, 1, 2, 3
SITE_KF_MATCH, SITE_KF_MATCH2 = 4, 5
SITE_LOOP = 6
SITE_GRELOC = 7

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finaliser: a bijective 64-bit hash."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class TorchKey:
    """Counter-free key: a 64-bit state hashed on every derivation, seeding
    a fresh ``torch.Generator`` for each draw (so a key draws the same
    numbers however often it is used, like a ``jax.random`` key)."""

    def __init__(self, seed: int):
        self.state = _mix64(int(seed) & _MASK64)

    @classmethod
    def _from_state(cls, state: int) -> "TorchKey":
        k = cls.__new__(cls)
        k.state = state
        return k

    def fold_in(self, data: int) -> "TorchKey":
        return TorchKey._from_state(
            _mix64(self.state ^ _mix64(int(data) & _MASK64)))

    def split(self, num: int = 2) -> Tuple["TorchKey", ...]:
        return tuple(self.fold_in((1 << 40) + i) for i in range(num))

    def randint(self, shape, high: Union[int, torch.Tensor],
                device: torch.device) -> torch.Tensor:
        g = torch.Generator(device=device)
        g.manual_seed(self.state & ((1 << 63) - 1))
        u = torch.rand(tuple(shape), generator=g, device=device,
                       dtype=torch.float64)
        hi = torch.clamp(torch.as_tensor(high, device=device), min=1)
        return torch.minimum((u * hi).long(), hi.long() - 1)


def frame_key(base, frame_no: int, site: int):
    """Key of one (frame, decision site): the reference's derivation."""
    return base.fold_in(int(frame_no)).fold_in(int(site))
