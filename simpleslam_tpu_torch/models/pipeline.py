"""Learned front-end wiring: ALIKED extraction + LightGlue matching behind
the frontend facade (the counterpart of ``simpleslam_tpu/models/pipeline.py``).

The topology is pinned to the reference's trained checkpoints: descriptor
dim 128, ALIKED channels 32/64/128/128, LightGlue dim 256, 4 heads, 9 layers.
Weights, as in the reference: an explicit state_dict wins; otherwise the
models are seeded (``torch.Generator``) and then grafted with every leaf of
the trained tree (``SLAM_FRONTEND_CKPT``, else
``checkpoints/learned_frontend``) whose name and shape match. The tree is
read by ``models/checkpoint.py`` and converted by :func:`from_jax_params`;
with no tree, or one that fails to read, a warning names the path and the
seeded weights stay.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.models import checkpoint
from simpleslam_tpu_torch.models import aliked as aliked_mod
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.models.seeding import seeded_init_
from simpleslam_tpu_torch.utils.device import resolve_device

DESC_DIM = 128

# flax leaf name -> torch leaf name (models/torch_import.py's convention)
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def jax_tree_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """One flax parameter tree (nested dicts of arrays, with or without
    the leading ``params`` collection) -> a torch state_dict: conv kernels
    HWIO -> OIHW, dense kernels (in, out) -> (out, in)."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    sd = {}
    for path, t in _flatten(params).items():
        mod, _, leaf = path.rpartition(".")
        if leaf == "kernel":
            t = t.transpose(3, 2, 0, 1) if t.ndim == 4 else t.T
        key = f"{mod}.{_LEAF_TO_TORCH.get(leaf, leaf)}" if mod else leaf
        sd[key] = torch.from_numpy(np.ascontiguousarray(t, np.float32))
    return sd


def from_jax_params(aliked_np: Mapping, lightglue_np: Mapping
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """The JAX package's ALIKED and LightGlue parameter trees (numpy) ->
    (aliked_state_dict, lightglue_state_dict) for ``load_state_dict``."""
    return jax_tree_to_state_dict(aliked_np), \
        jax_tree_to_state_dict(lightglue_np)


def state_dict_to_jax_tree(sd: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of :func:`jax_tree_to_state_dict`: a torch state_dict ->
    ``{"params": ...}`` of float32 numpy leaves with flax names (conv
    kernels OIHW -> HWIO, dense kernels (out, in) -> (in, out), norm
    weights -> ``scale``)."""
    tree: dict = {}
    for key, t in sd.items():
        mod, _, leaf = key.rpartition(".")
        a = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            if a.ndim == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for part in mod.split(".") if mod else []:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def to_jax_params(aliked_sd: Mapping[str, torch.Tensor],
                  lightglue_sd: Mapping[str, torch.Tensor]
                  ) -> Tuple[dict, dict]:
    """(aliked_state_dict, lightglue_state_dict) -> the JAX package's two
    parameter trees (numpy); the inverse of :func:`from_jax_params`."""
    return state_dict_to_jax_tree(aliked_sd), \
        state_dict_to_jax_tree(lightglue_sd)


def trained_state_dicts(path: Optional[str] = None, on_error: str = "warn"
                        ) -> Optional[Tuple[Dict[str, torch.Tensor],
                                            Dict[str, torch.Tensor]]]:
    """(aliked_state_dict, lightglue_state_dict) of the trained tree, or
    None (see ``checkpoint.load_frontend_tree``)."""
    tree = checkpoint.load_frontend_tree(path, on_error=on_error)
    return None if tree is None else from_jax_params(tree["aliked"],
                                                     tree["lightglue"])


def _init_weights(module: nn.Module, seed: int,
                  state_dict: Optional[Mapping], part: int) -> None:
    """An explicit state_dict, else seeded and grafted with the trained
    tree's matching leaves (part 0: ALIKED, 1: LightGlue)."""
    if state_dict is not None:
        module.load_state_dict(state_dict, strict=True)
        return
    seeded_init_(module, seed)
    trained = trained_state_dicts()
    if trained is not None:
        checkpoint.graft_matching(module, trained[part])


class LearnedExtractor:
    """ALIKED bundle satisfying the frontend Detector protocol."""

    def __init__(self, max_kp: int, seed: int = 0, desc_dim: int = DESC_DIM,
                 device=None, state_dict: Optional[Mapping] = None):
        self.name = "aliked"
        self.max_kp = max_kp
        self.learned = True
        self.desc_dim = desc_dim
        self.device = resolve_device(device)
        self.model = aliked_mod.ALIKED(desc_dim=desc_dim)
        _init_weights(self.model, seed, state_dict, 0)
        self.model.to(self.device).eval()
        self.image_hw: Optional[Tuple[int, int]] = None

    @torch.no_grad()
    def fn(self, gray: torch.Tensor) -> Features:
        """(H, W) float grey [0..255] on the device -> padded Features."""
        self.image_hw = tuple(gray.shape[:2])
        img = aliked_mod.preprocess_image(gray)
        score, desc_map = self.model(img[None])
        return aliked_mod.dkd_extract(score[0], desc_map[0], self.max_kp)

    def extract_batch(self, images: torch.Tensor) -> Features:
        """(B, H, W, 1) float [0, 1] on the device -> batched Features (the
        throughput mode)."""
        return aliked_mod.extract_batch(self.model, images, self.max_kp)


class LearnedMatcher:
    """LightGlue bundle satisfying the frontend Matcher protocol."""

    def __init__(self, extractor: LearnedExtractor, min_conf: float = 0.7,
                 seed: int = 1, n_layers: int = 9,
                 state_dict: Optional[Mapping] = None):
        self.name = "lightglue"
        self.learned = True
        self.min_conf = float(min_conf)
        self.extractor = extractor
        self.device = extractor.device
        self.model = lg_mod.LightGlue(desc_dim=extractor.desc_dim,
                                      n_layers=n_layers)
        _init_weights(self.model, seed, state_dict, 1)
        self.model.to(self.device).eval()
        self.calls = 0

    def fn(self, feats0: Features, feats1: Features) -> Matches:
        hw = self.extractor.image_hw or (480, 640)
        self.calls += 1
        return lg_mod.match_pair(self.model, feats0, feats1,
                                 (int(hw[0]), int(hw[1])), self.min_conf)


def build_learned_extractor(args, n_pad: int, device=None,
                            state_dict=None) -> LearnedExtractor:
    return LearnedExtractor(max_kp=n_pad, seed=int(getattr(args, "seed", 0)),
                            device=device, state_dict=state_dict)


def build_learned_matcher(args, extractor: LearnedExtractor,
                          state_dict=None) -> LearnedMatcher:
    return LearnedMatcher(extractor,
                          min_conf=float(getattr(args, "min_conf", 0.7)),
                          seed=int(getattr(args, "seed", 0)) + 1,
                          state_dict=state_dict)
