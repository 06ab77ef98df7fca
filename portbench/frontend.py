"""What both drivers build at set-up: the weights and the port's models,
and the reference's parameters beside them."""
from __future__ import annotations

import os

import torch

from portbench import harness
from portbench.reference import models as ref_models
from portbench.reference import weights as ref_weights


def weights_tree(cfg, seed: int):
    """The flax-layout tree of both models: the trained tree the
    configuration names, read by the port's reader and held to the
    reference's digest; or, where it names none (CPU tests), normal draws
    from ``seed`` in the port's shapes (std ``seeded_std``, one number or
    one for each model by its name; norm scales about 1)."""
    if cfg.get("weights"):
        from simpleslam_tpu_torch.models import checkpoint
        tree = checkpoint.load_frontend_tree(
            os.path.join(harness.ROOT, cfg["weights"]), on_error="raise")
        ref_weights.verify(tree)
        return tree
    from simpleslam_tpu_torch.models.pipeline import state_dict_to_jax_tree
    a, lg = build_models(cfg, None, "cpu")
    gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
    tree = {}
    for name, sd in (("aliked", a.state_dict()), ("lightglue",
                                                  lg.state_dict())):
        std = cfg["seeded_std"]
        std = std[name] if isinstance(std, dict) else std
        drawn = {}
        for k, v in sd.items():
            r = torch.randn(v.shape, generator=gen) * std
            norm_scale = k.endswith("weight") and v.dim() == 1
            drawn[k] = 1.0 + r if norm_scale else r
        tree[name] = state_dict_to_jax_tree(drawn)
    return tree


def build_models(cfg, tree, device):
    """The port's ALIKED and LightGlue at the configuration's widths, with
    ``tree``'s weights (None: left as constructed)."""
    from simpleslam_tpu_torch.models import aliked as aliked_mod
    from simpleslam_tpu_torch.models import lightglue as lg_mod
    from simpleslam_tpu_torch.models.pipeline import from_jax_params
    a_cfg, l_cfg = cfg["aliked"], cfg["lightglue"]
    a = aliked_mod.ALIKED(desc_dim=a_cfg["desc_dim"],
                          channels=tuple(a_cfg["channels"]))
    lg = lg_mod.LightGlue(desc_dim=a_cfg["desc_dim"], dim=l_cfg["dim"],
                          heads=l_cfg["heads"], n_layers=l_cfg["layers"])
    if tree is not None:
        sa, sl = from_jax_params(tree["aliked"], tree["lightglue"])
        a.load_state_dict(sa, strict=True)
        lg.load_state_dict(sl, strict=True)
    return a.to(device).eval(), lg.to(device).eval()


def reference_params(tree, device):
    """(ALIKED, LightGlue) parameters for the reference, from the tree as
    stored."""
    return (ref_models.params_to(tree["aliked"]["params"], device),
            ref_models.params_to(tree["lightglue"]["params"], device))
