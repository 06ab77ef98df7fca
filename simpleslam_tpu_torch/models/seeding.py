"""Seeded weights for the port's ``nn.Module``s (the counterpart of flax's
``Module.init`` with its default initialisers)."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def seeded_init_(module: nn.Module,
                 seed: Union[int, torch.Generator]) -> nn.Module:
    """Deterministic init from a ``torch.Generator`` (or a seed for a new
    one), flax's defaults: kernels LeCun-normal (std 1/sqrt(fan_in)),
    biases 0, norm scales 1. Leaves are drawn in sorted name order."""
    g = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    for name, p in sorted(module.named_parameters()):
        leaf = name.rpartition(".")[2]
        if leaf == "bias":
            p.zero_()
        elif "Norm" in name:
            p.fill_(1.0)
        else:
            fan_in = int(np.prod(p.shape[1:]))
            p.copy_(torch.randn(p.shape, generator=g) / np.sqrt(fan_in))
    return module
