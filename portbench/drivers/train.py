"""Training steps of the front-end back to back, as a trainer whose input
workers keep up sees them: the port's step (``models/train.py::
make_train_step``) over a ring of batches built on the device at set-up.

Set-up renders the scene-pair pool from the seed, builds the ring
(``ScenePairPool.batch``, ``photometric_augment``, ``batch_to_device``),
makes the step with its models and optimizer state from the trained tree,
and drives it through its first three steps (the ring's first three
batches), which warm every shape and are what the check compares; the
window then steps on through the ring. Traffic parameters: ``ring`` (the
batches in it), ``check_steps`` and ``ref_block`` (pairs the reference
takes at once).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from portbench import frontend
from portbench.flops import counts
from portbench.reference import judge
from portbench.reference import loss as ref_loss
from portbench.reference import precision
from portbench.reference.weights import flat_leaves

RANGES = ("step",)


def flax_name(name: str, p: torch.Tensor) -> str:
    """A port parameter's name -> its leaf's path in the tree."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel" if p.dim() > 1 else "scale"
    return "/".join(parts)


class Driver:
    unit = "pairs"

    def __init__(self, cell, cfg, seed, device, impl="port"):
        self.cell, self.cfg, self.seed = cell, cfg, int(seed)
        self.tr, self.t = cell["traffic"], cfg["train"]
        self.device = torch.device(device)
        self.impl = impl
        self.hw = tuple(cfg["image_hw"])
        self.steps = 0
        self.history = []        # the ring batch each step took
        self.first = []

    def setup(self):
        from simpleslam_tpu_torch.models import train as train_mod
        t, dev = self.t, self.device
        self.tree = frontend.weights_tree(self.cfg, self.seed)
        pool = train_mod.ScenePairPool(
            self.hw, n_views=t["scene_views"], seed=self.seed,
            n_scenes=t["scenes"], render_hw=self.hw,
            families=tuple(t["families"]), device=dev)
        rng = np.random.default_rng(self.seed)
        self.ring = [train_mod.batch_to_device(train_mod.photometric_augment(
            rng, pool.batch(rng, t["batch_pairs"], t["points"])), dev)
            for _ in range(self.tr["ring"])]
        self.valid = [b["pt_valid"].sum(1).tolist() for b in self.ring]
        n = self.tr["check_steps"]
        if self.impl != "port":
            self.readings = self.reference_steps(precision.CONTROL, n)
            return
        from simpleslam_tpu_torch.models.pipeline import from_jax_params
        sds = from_jax_params(self.tree["aliked"], self.tree["lightglue"])
        lg = self.cfg["lightglue"]
        tx, self.state = train_mod.make_train_state(
            torch.Generator().manual_seed(0), lr=t["lr"], warmup=t["warmup"],
            total_steps=t["total_steps"], device=dev, state_dicts=sds,
            desc_dim=self.cfg["aliked"]["desc_dim"], dim=lg["dim"],
            n_layers=lg["layers"])
        self.step_fn = train_mod.make_train_step(tx, self.hw)
        flat0 = self.state.flat.clone()
        for i in range(n):
            self.call()
            if i == 0:
                g1 = self.state.opt_state.mu / (1 - tx.B1)
        change = self.state.flat - flat0
        self.readings = self.by_leaf(g1, change)

    def by_leaf(self, g1, change):
        """{terms, grad, change} of the port's first steps: the loss terms
        of each, and per leaf the norms of the first gradient and of the
        change."""
        grad, chg, off = {}, {}, 0
        for part in ("aliked", "lightglue"):
            for name, p in self.state.models[part].named_parameters():
                leaf = flax_name(f"{part}.{name}", p)
                sl = slice(off, off + p.numel())
                grad[leaf] = float(torch.linalg.vector_norm(g1[sl]))
                chg[leaf] = float(torch.linalg.vector_norm(change[sl]))
                off += p.numel()
        terms = [{k: float(v) for k, v in m.items()} for m in self.first]
        return {"terms": terms, "grad": grad, "change": chg}

    def call(self):
        if self.impl != "port":
            return
        b = self.steps % len(self.ring)
        batch = self.ring[b]
        self.history.append(b)
        with record_function("step"):
            self.state, metrics = self.step_fn(self.state, batch)
        if len(self.first) < self.tr["check_steps"]:
            self.first.append(metrics)
        self.steps += 1

    def work(self, calls):
        return calls * self.t["batch_pairs"]

    def end_to_end(self, calls, seconds):
        return {"train_pairs_per_s": self.work(calls) / seconds}

    def counters(self):
        from simpleslam_tpu_torch.ops import attention
        return {"attn_fwd_launches": attention.cuda_masked_attention.launches,
                "attn_bwd_launches":
                    attention.cuda_masked_attention_bwd.launches}

    def traced(self, first_call, calls):
        ops, fwd, bwd = 0, [], []
        for b in self.history[first_call:first_call + calls]:
            v = self.valid[b]
            ops += counts.train_step_ops(self.cfg, *self.hw, v)
            for x in counts.attention_calls(self.cfg, v, v):
                fwd.append(counts.attention_fwd(self.cfg, x))
                bwd.append(counts.attention_bwd(self.cfg, x))
        return {"model_ops": ops, "attn_fwd": fwd, "attn_bwd": bwd,
                "ranges": RANGES, "range_calls": {"step": calls}}

    def release(self):
        self.state = self.step_fn = None

    # ------------------------------------------------------------------ #
    def reference_steps(self, prec, n):
        """The reference's first ``n`` steps from the same tree and
        batches, each batch in blocks of ``ref_block`` pairs whose
        gradients add up to the batch's."""
        precision.no_tf32()
        t = self.t
        pa, pl = frontend.reference_params(self.tree, self.device)
        leaves = flat_leaves({"aliked": pa, "lightglue": pl})
        p0 = {k: v.clone() for k, v in leaves.items()}
        opt = ref_loss.AdamW(t["lr"], t["warmup"], t["total_steps"])
        blk = self.tr["ref_block"]
        terms_all, g1 = [], None
        for s in range(n):
            batch = self.ring[s]
            B = batch["img0"].shape[0]
            n_valid = torch.clamp(batch["pt_valid"].sum(), min=1)
            grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
            terms = {}
            for b0 in range(0, B, blk):
                sub = {k: v[b0:b0 + blk] for k, v in batch.items()}
                for v in leaves.values():
                    v.requires_grad_(True)
                with torch.enable_grad():
                    total, tm = ref_loss.loss(pa, pl, sub, self.hw, prec,
                                              n_valid,
                                              sub["img0"].shape[0] / B)
                    gs = torch.autograd.grad(total, list(leaves.values()))
                for (k, acc), g in zip(grads.items(), gs):
                    acc.add_(g)
                for k, v in tm.items():
                    terms[k] = terms.get(k, 0.0) + float(v.detach())
                del total, tm, gs
            for v in leaves.values():
                v.requires_grad_(False)
            g = opt.step(leaves, grads)
            if s == 0:
                g1 = {k: float(torch.linalg.vector_norm(v))
                      for k, v in g.items()}
            terms_all.append(terms)
        change = {k: float(torch.linalg.vector_norm(v - p0[k]))
                  for k, v in leaves.items()}
        return {"terms": terms_all, "grad": g1, "change": change}

    def check(self):
        """[(unit, {number: reading})]: the first steps, as the window's
        step took them, held to the reference's."""
        ref = self.reference_steps(precision.STATED,
                                   self.tr["check_steps"])
        got = self.readings
        return [(f"steps 1-{self.tr['check_steps']}", judge.train(
            got["terms"], ref["terms"], got["grad"], ref["grad"],
            got["change"], ref["change"]))]
