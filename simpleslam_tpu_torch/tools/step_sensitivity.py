"""How far one training step moves when every attention output is perturbed.

    python -m simpleslam_tpu_torch.tools.step_sensitivity --device cpu

From the trained tree, on pool batches at the training defaults (batch 8,
144x256 crops of a corridor rendered at 376x1232, 96 points), one step's
loss terms and gradient are computed with the plain attention, then again
with each attention output moved by uniform noise of ``eps * max(1,
max|v|)`` (the scale of the per-call tolerances). One JSON line per
(model dtype, batch, eps): the largest loss-term change over max(1,
|term|), the gradient norm's relative change and the gradient's relative
L2 change. ``chip_smoke.py`` takes the tolerances of its kernel-vs-plain
step from these readings.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from simpleslam_tpu_torch.models import checkpoint
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.models import train as train_mod
from simpleslam_tpu_torch.models.pipeline import from_jax_params
from simpleslam_tpu_torch.ops import attention


def main(argv=None) -> int:
    p = argparse.ArgumentParser("step_sensitivity")
    p.add_argument("--device", default=None)
    p.add_argument("--eps", type=float, nargs="+",
                   default=[1e-7, 2e-6, 2e-5])
    p.add_argument("--batches", type=int, nargs="+",
                   default=list(range(5, 13)))
    a = p.parse_args(argv)
    tree = checkpoint.load_frontend_tree(on_error="raise")
    sds = from_jax_params(tree["aliked"], tree["lightglue"])
    hw = (144, 256)
    pool = train_mod.ScenePairPool(hw, n_views=4, n_scenes=1,
                                   render_hw=(376, 1232), seed=1,
                                   device=a.device)
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        _tx, state = train_mod.make_train_state(
            torch.Generator().manual_seed(0), device=a.device,
            state_dicts=sds, desc_dim=128, dim=256, n_layers=9, dtype=dtype)
        dev = state.flat.device
        for seed in a.batches:
            rng = np.random.default_rng(seed)
            batch = train_mod.batch_to_device(train_mod.photometric_augment(
                rng, pool.batch(rng, 8, 96)), dev)
            m0, g0 = train_mod.loss_and_grad(state.models, batch, hw)
            g0 = torch.nan_to_num(g0, 0.0, 0.0, 0.0)
            for eps in a.eps:
                gen = torch.Generator(device=dev).manual_seed(seed)

                def noisy(q, k, v, m):
                    out = attention.plain_masked_attention(q, k, v, m)
                    s = max(1.0, v.detach().float().abs().max().item())
                    noise = 2 * torch.rand(out.shape, generator=gen,
                                           device=dev) - 1
                    return out + eps * s * noise

                lg_mod.masked_attention = noisy
                try:
                    m1, g1 = train_mod.loss_and_grad(state.models, batch, hw)
                finally:
                    lg_mod.masked_attention = attention.masked_attention
                g1 = torch.nan_to_num(g1, 0.0, 0.0, 0.0)
                n0 = float(torch.linalg.vector_norm(g0))
                print(json.dumps({
                    "models": name, "batch": seed, "eps": eps,
                    "term_change": max(abs(float(m1[k]) - float(m0[k]))
                                       / max(1.0, abs(float(m0[k])))
                                       for k in m0),
                    "gnorm": n0, "gnorm_rel_change": abs(
                        float(torch.linalg.vector_norm(g1)) - n0) / n0,
                    "grad_rel_l2": float(torch.linalg.vector_norm(g1 - g0))
                    / n0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
