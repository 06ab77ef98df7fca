"""Offline extraction and matching of a recorded drive: one caller, calls
back to back. Each call extracts ``frames_per_call`` consecutive frames
with ``extract_batch`` and matches their consecutive pairs with
``match_batch``. The drive's frames are rendered on the card at set-up
from the seed and cut into batches that the calls take in turn.

Traffic parameters (the cell file's ``traffic``): ``frames`` of the drive,
``frames_per_call``, ``speed_m`` a frame, ``corner_frames`` and
``closure_frac`` of the rounded-square lap, ``K`` the camera, ``sample_calls``
the calls kept (drawn from the seed) for the check, ``ref_block`` frames or
pairs the reference takes at once. The cell's ``lost_margin`` is the margin
in nats of a sure match for ``match_lost`` (``reference/judge.py``).
"""
from __future__ import annotations

import random

import numpy as np
import torch
from torch.profiler import record_function

from portbench import frontend
from portbench.flops import counts
from portbench.reference import judge
from portbench.reference import models as ref_models
from portbench.reference import precision

RANGES = ("extract", "match")


class Driver:
    unit = "pairs"

    def __init__(self, cell, cfg, seed, device, impl="port"):
        self.cell, self.cfg, self.seed = cell, cfg, int(seed)
        self.tr = cell["traffic"]
        self.device = torch.device(device)
        self.impl = impl
        self.hw = tuple(cfg["image_hw"])
        self.k = cfg["max_keypoints"]
        self.min_conf = cfg["min_conf"]
        self.calls = 0
        self.history = []        # the batch each call took
        self.kept = []
        self.pick = random.Random(self.seed)

    # ------------------------------------------------------------------ #
    def setup(self):
        self.tree = frontend.weights_tree(self.cfg, self.seed)
        if self.impl == "port":
            self.models = frontend.build_models(self.cfg, self.tree,
                                                self.device)
        else:
            self.params = frontend.reference_params(self.tree, self.device)
        frames = self.render()
        n = self.tr["frames_per_call"]
        self.batches = [frames[s:s + n] for s in
                        range(0, frames.shape[0] - n + 1, n - 1)]
        self.valid = []          # one call on each batch warms every shape
        for b in self.batches:
            f, _m = self.run(b)
            self.valid.append(f["valid"].sum(1).tolist())

    def render(self):
        """The drive's frames, (F, H, W, 1) float32 in [0, 1] on the
        device: ``CorridorScene`` seeded by the run's seed along a
        rounded-square lap."""
        from simpleslam_tpu_torch.tools.synth import (
            CorridorScene, make_square_loop_trajectory)
        tr = self.tr
        T = make_square_loop_trajectory(
            tr["frames"], speed=tr["speed_m"],
            closure_frac=tr["closure_frac"],
            corner_frames=tr["corner_frames"])
        wall = float(max(10.0, np.abs(T[:, 0, 3]).max() + 6.0))
        scene = CorridorScene(seed=self.seed, hw=self.hw,
                              K=np.asarray(tr["K"]), device=self.device,
                              wall_x=wall)
        grey = torch.stack([scene.render(t) for t in T])
        return (grey.float() / 255.0)[..., None]

    # ------------------------------------------------------------------ #
    def run(self, imgs):
        """One call: (features, matches) as dicts of tensors with a
        leading batch axis."""
        if self.impl != "port":
            return self.run_reference(imgs, precision.CONTROL)
        from simpleslam_tpu_torch.models.aliked import extract_batch
        from simpleslam_tpu_torch.models.lightglue import match_batch
        a, lg = self.models
        with record_function("extract"):
            f = extract_batch(a, imgs, self.k)
        with record_function("match"):
            m = match_batch(lg, f.map(lambda t: t[:-1]),
                            f.map(lambda t: t[1:]), self.hw, self.min_conf)
        return vars(f), vars(m)

    @torch.no_grad()
    def run_reference(self, imgs, prec):
        """The reference in the program's place, at precision ``prec``
        (the control)."""
        precision.no_tf32()
        pa, pl = self.params
        blk = self.tr["ref_block"]
        feats = []
        for s in range(0, imgs.shape[0], blk):
            score, dmap = ref_models.aliked(pa, imgs[s:s + blk, ..., 0], prec)
            feats += [ref_models.dkd(score[i], dmap[i], self.k)
                      for i in range(score.shape[0])]
        f = dict(zip(("kpts", "desc", "scores", "valid"),
                     (torch.stack(x) for x in zip(*feats))))
        m = {k: [] for k in ("idx0", "idx1", "score", "valid")}
        for s in range(0, imgs.shape[0] - 1, blk):
            e = min(s + blk, imgs.shape[0] - 1)
            P, _, _ = ref_models.lightglue(
                pl, f["kpts"][s:e], f["desc"][s:e], f["valid"][s:e],
                f["kpts"][s + 1:e + 1], f["desc"][s + 1:e + 1],
                f["valid"][s + 1:e + 1], self.hw, prec)
            for p in P:
                nn1, ok = ref_models.mutual_matches(p, self.min_conf)
                rows = torch.arange(p.shape[0], device=p.device)
                m["idx0"].append(rows)
                m["idx1"].append(nn1)
                m["score"].append(torch.where(ok, p[rows, nn1], 0.0))
                m["valid"].append(ok)
        return f, {k: torch.stack(v) for k, v in m.items()}

    def call(self):
        """One timed call; the calls kept for the check are a sample of
        ``sample_calls`` drawn from the seed (reservoir)."""
        b = self.calls % len(self.batches)
        out = self.run(self.batches[b])
        self.history.append(b)
        n = self.tr["sample_calls"]
        if self.calls < n:
            self.kept.append((b, out))
        else:
            j = self.pick.randrange(self.calls + 1)
            if j < n:
                self.kept[j] = (b, out)
        self.calls += 1

    def work(self, calls):
        return calls * (self.tr["frames_per_call"] - 1)

    def end_to_end(self, calls, seconds):
        return {"pairs_per_s": self.work(calls) / seconds}

    # ------------------------------------------------------------------ #
    def counters(self):
        from simpleslam_tpu_torch.ops import attention
        return {"attn_fwd_launches": attention.cuda_masked_attention.launches}

    def traced(self, first_call, calls):
        """What the calls ``first_call`` .. + ``calls`` did, counted from
        shapes: model operations and the attention calls."""
        ops, fwd = 0, []
        for b in self.history[first_call:first_call + calls]:
            v = self.valid[b]
            ops += len(v) * counts.aliked_ops(self.cfg, *self.hw)
            n0, n1 = v[:-1], v[1:]
            ops += sum(counts.lightglue_ops(self.cfg, a, b)
                       for a, b in zip(n0, n1))
            fwd += [counts.attention_fwd(self.cfg, x)
                    for x in counts.attention_calls(self.cfg, n0, n1)]
        return {"model_ops": ops, "attn_fwd": fwd, "ranges": RANGES,
                "range_calls": {r: calls for r in RANGES}}

    def release(self):
        self.models = None

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def check(self):
        """[(unit, {number: reading})] of every frame and pair of the kept
        calls, held to the reference at the configuration's precision."""
        precision.no_tf32()
        pa, pl = frontend.reference_params(self.tree, self.device)
        blk = self.tr["ref_block"]
        prec = precision.STATED
        out = []
        for b, (f, m) in self.kept:
            imgs = self.batches[b]
            for s in range(0, imgs.shape[0], blk):
                score, dmap = ref_models.aliked(pa, imgs[s:s + blk, ..., 0],
                                                prec)
                for i in range(score.shape[0]):
                    fi = s + i
                    out.append((f"frame {b}:{fi}", judge.features(
                        score[i], dmap[i], f["kpts"][fi], f["desc"][fi],
                        f["scores"][fi], f["valid"][fi], self.k)))
                del score, dmap
            n = imgs.shape[0] - 1
            for s in range(0, n, blk):
                e = min(s + blk, n)
                P, _, _ = ref_models.lightglue(
                    pl, f["kpts"][s:e], f["desc"][s:e], f["valid"][s:e],
                    f["kpts"][s + 1:e + 1], f["desc"][s + 1:e + 1],
                    f["valid"][s + 1:e + 1], self.hw, prec)
                for i, p in enumerate(P):
                    pi = s + i
                    out.append((f"pair {b}:{pi}", judge.matches(
                        p, m["idx0"][pi], m["idx1"][pi], m["score"][pi],
                        m["valid"][pi], self.min_conf,
                        self.cell["lost_margin"])))
                del P
        return out
