"""Self-supervised training of the learned front-end (ALIKED + LightGlue):
the counterpart of ``simpleslam_tpu/models/train.py``.

Pairs of views with exact dense correspondences -- procedural noise images
warped by random homographies (:func:`synthetic_pair_batch`), crops of
rendered views (the corridor, box and photograph families) with raycast
correspondences (:class:`ScenePairPool`) and photographs warped by random
homographies (:class:`PhotoPairPool`, over :func:`train_photo_paths`) --
drive

  * a descriptor InfoNCE loss at corresponding points, both directions,
  * a score repeatability loss and a peak-alignment loss (view 0's NMS
    peaks carried into view 1 must peak there),
  * LightGlue's assignment negative log-likelihood at the ground-truth
    correspondences, plus matchability supervision.

The step is eager PyTorch: the loss, ``torch.autograd.grad`` over every
parameter, then the reference's optax chain (:class:`AdamWChain`) on one
flat float32 buffer that the modules' parameters are views of. LightGlue's
attention takes ``ops/attention.py::MaskedAttentionFn`` on the GPU: the
CUDA kernel forward, the plain expression's backward.

Randomness is injected: each random function is split into its draws (from
a ``torch.Generator`` or, where the reference uses numpy, an
``np.random.Generator`` in the reference's order) and a deterministic
function of them, so the tests feed in what ``jax.random`` drew.

The sharded step (``shard_params_for_tp``, ``make_sharded_train_step``)
runs over a (dp, tp) ``DeviceMesh`` (``parallel/mesh.py``): the batch split
over 'dp', the dense layers the reference's rule picks split along their
outputs over 'tp'.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from simpleslam_tpu_torch.models import aliked as aliked_mod
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.ops.epipolar import fit_homography
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.profiling import span
from simpleslam_tpu_torch.utils.resize import (resize_area,
                                               resize_bicubic_like_jax,
                                               resize_linear)

OCTAVES = (4, 8, 16)
MARGIN = 6
MAG = 0.12          # homography corner jitter, a fraction of the image size


# --------------------------------------------------------------------------- #
# Models, optimizer, state
# --------------------------------------------------------------------------- #

def make_models(generator: torch.Generator, desc_dim: int = 64,
                dim: int = 128, n_layers: int = 3,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, nn.Module]:
    """{"aliked": ..., "lightglue": ...} with seeded weights, 4 heads."""
    return {"aliked": aliked_mod.init_aliked(generator, desc_dim, dtype),
            "lightglue": lg_mod.init_lightglue(generator, desc_dim, dim, 4,
                                               n_layers, dtype)}


class OptState(NamedTuple):
    count: int               # updates applied (optax's count, host side)
    mu: torch.Tensor         # flat first moment
    nu: torch.Tensor         # flat second moment


class AdamWChain:
    """The reference's optax chain on flat float32 tensors, in order:

    1. every non-finite gradient entry -> 0;
    2. ``clip_by_global_norm(max_norm)``: ``g * max_norm / ||g||`` only
       when ``||g|| >= max_norm`` (no epsilon);
    3. ``adamw``: Adam moments with bias correction, ``eps`` outside the
       square root, weight decay on every entry, the update
       ``-lr * (adam + wd * p)``;
    4. ``lr = warmup_cosine_decay_schedule(0, lr, warmup,
       max(total, warmup + 1), 0.1 lr)`` at the count BEFORE the update,
       so the first update is exactly zero.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adamw's defaults
    WEIGHT_DECAY, MAX_NORM = 1e-4, 1.0

    def __init__(self, lr: float, warmup: int = 100,
                 total_steps: int = 10000):
        self.lr, self.warmup = float(lr), int(warmup)
        self.decay_steps = max(int(total_steps), self.warmup + 1) \
            - self.warmup
        self.alpha = 0.0 if self.lr == 0.0 else 0.1

    def schedule(self, count: int) -> float:
        """``optax.warmup_cosine_decay_schedule`` at ``count``."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        t = min(count - self.warmup, self.decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / self.decay_steps))
        return self.lr * ((1.0 - self.alpha) * cos + self.alpha)

    def init(self, flat: torch.Tensor) -> OptState:
        return OptState(0, torch.zeros_like(flat), torch.zeros_like(flat))

    @torch.no_grad()
    def update_(self, flat: torch.Tensor, grad: torch.Tensor,
                state: OptState, norm_fn=None
                ) -> Tuple[OptState, torch.Tensor]:
        """Apply one update to ``flat`` in place; returns the new state and
        the global norm of the sanitised gradient (0-d, on the device).
        ``norm_fn(g)``: that norm when ``flat`` holds only a shard of the
        parameters (the sharded step's)."""
        b1, b2 = self.B1, self.B2
        g = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
        gnorm = torch.linalg.vector_norm(g) if norm_fn is None \
            else norm_fn(g)
        g = torch.where(gnorm < self.MAX_NORM, g,
                        g / gnorm * self.MAX_NORM)
        mu = (1 - b1) * g + b1 * state.mu
        nu = (1 - b2) * (g * g) + b2 * state.nu
        count = state.count + 1
        u = (mu / (1 - b1 ** count)) \
            / (torch.sqrt(nu / (1 - b2 ** count)) + self.EPS)
        u = u + self.WEIGHT_DECAY * flat
        flat.add_(u * -self.schedule(state.count))
        return OptState(count, mu, nu), gnorm


class TrainState(NamedTuple):
    models: Dict[str, nn.Module]     # "aliked", "lightglue"
    flat: torch.Tensor               # every parameter, concatenated
    opt_state: OptState
    step: int


def param_list(models: Dict[str, nn.Module]) -> List[nn.Parameter]:
    """ALIKED's parameters, then LightGlue's, in module order."""
    return list(models["aliked"].parameters()) + \
        list(models["lightglue"].parameters())


@torch.no_grad()
def flatten_params_(params: Sequence[nn.Parameter]) -> torch.Tensor:
    """Concatenate ``params`` into one buffer and make each parameter a
    view of it, so an update of the buffer updates the modules."""
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    off = 0
    for p in params:
        p.data = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return flat


def make_train_state(generator: torch.Generator, lr: float = 1e-4,
                     warmup: int = 100, total_steps: int = 10000,
                     device=None, state_dicts=None, **model_kw
                     ) -> Tuple[AdamWChain, TrainState]:
    """(optimizer chain, state) of seeded models on ``device`` (None: the
    GPU), or of ``state_dicts`` = (aliked, lightglue) loaded strictly."""
    device = resolve_device(device)
    models = make_models(generator, **model_kw)
    if state_dicts is not None:
        models["aliked"].load_state_dict(state_dicts[0], strict=True)
        models["lightglue"].load_state_dict(state_dicts[1], strict=True)
    for m in models.values():
        m.to(device).train()
    flat = flatten_params_(param_list(models))
    tx = AdamWChain(lr, warmup, total_steps)
    return tx, TrainState(models, flat, tx.init(flat), 0)


# --------------------------------------------------------------------------- #
# Synthetic homography pair batches
# --------------------------------------------------------------------------- #

def synthetic_pair_draws(generator: torch.Generator, B: int, H: int, W: int,
                         G: int) -> Dict[str, object]:
    """The random inputs of :func:`synthetic_pair_batch`, on the
    generator's device: ``coarse`` (one (B, H/o + 2, W/o + 2) uniform grid
    per octave o), ``jitter`` (B, 4, 2) corner offsets in [-MAG, MAG] and
    ``x1``/``y1`` (B, G) view-1 points inside the margin."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=dev)

    return {"coarse": [uniform((B, H // o + 2, W // o + 2), 0.0, 1.0)
                       for o in OCTAVES],
            "jitter": uniform((B, 4, 2), -MAG, MAG),
            "x1": uniform((B, G), MARGIN, W - MARGIN),
            "y1": uniform((B, G), MARGIN, H - MARGIN)}


def _smooth_noise(coarse: Sequence[torch.Tensor], H: int, W: int
                  ) -> torch.Tensor:
    """Octaves of bicubic-upsampled uniform noise, each image scaled to
    [0, 1]: (B, H, W)."""
    imgs = torch.zeros((coarse[0].shape[0], H, W), device=coarse[0].device)
    for i, c in enumerate(coarse):
        imgs = imgs + resize_bicubic_like_jax(c, (H, W)) / (i + 1)
    lo = imgs.amin(dim=(1, 2), keepdim=True)
    hi = imgs.amax(dim=(1, 2), keepdim=True)
    return (imgs - lo) / torch.clamp(hi - lo, min=1e-6)


def _random_homography(jitter: torch.Tensor, H: int, W: int
                       ) -> torch.Tensor:
    """(B, 4, 2) corner jitter -> (B, 3, 3) homographies mapping view-0
    pixels to view 1."""
    corners0 = torch.tensor([[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0],
                             [W - 1.0, H - 1.0]], device=jitter.device)
    corners1 = corners0 + jitter * torch.tensor([float(W), float(H)],
                                                device=jitter.device)
    return fit_homography(corners0.expand_as(corners1), corners1)


def _warp_points(Hm: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (B, 3, 3) homographies to (B, N, 2) points, keeping the sign
    of the homogeneous coordinate."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    q = ph @ Hm.transpose(-1, -2)
    z = q[..., 2:3]
    return q[..., :2] / torch.clamp(z.abs(), min=1e-9) * torch.sign(z)


def _pixel_grid(H: int, W: int, device) -> torch.Tensor:
    """(H * W, 2) float32 (x, y) of every pixel, row-major."""
    yy, xx = torch.meshgrid(torch.arange(H, device=device),
                            torch.arange(W, device=device), indexing="ij")
    return torch.stack([xx, yy], -1).reshape(-1, 2).float()


def _warp_image(img: torch.Tensor, Hm_inv: torch.Tensor) -> torch.Tensor:
    """(B, H, W) images sampled bilinearly at ``Hm_inv``(pixel)."""
    B, H, W = img.shape
    dst = _pixel_grid(H, W, img.device).expand(B, -1, -1)
    src = _warp_points(Hm_inv, dst)
    x = torch.clamp(src[..., 0], 0, W - 1.001)
    y = torch.clamp(src[..., 1], 0, H - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    fx, fy = x - x0, y - y0
    flat = img.reshape(B, -1)

    def at(yi, xi):
        return flat.gather(1, yi * W + xi)

    v = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
         + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)
    return v.reshape(B, H, W)


def synthetic_pair_batch_from_draws(draws: Dict[str, object], H: int,
                                    W: int) -> Dict[str, torch.Tensor]:
    """The batch of correspondence-labelled homography pairs that
    ``draws`` determine: img0/img1 (B, H, W, 1) in [0, 1], pts0/pts1
    (B, G, 2) with img1(pts1) = img0(pts0), pt_valid (B, G), Hmats
    (B, 3, 3), and the dense view-0 -> view-1 field warp01 (B, H, W, 2)
    with warp_valid (B, H, W)."""
    m = MARGIN
    img0 = _smooth_noise(draws["coarse"], H, W)
    Hmats = _random_homography(draws["jitter"], H, W)
    Hinv = torch.linalg.inv(Hmats)
    img1 = _warp_image(img0, Hmats)          # img1(x) = img0(H x)
    pts1 = torch.stack([draws["x1"], draws["y1"]], -1)
    pts0 = _warp_points(Hmats, pts1)
    valid = ((pts0[..., 0] >= m) & (pts0[..., 0] < W - m)
             & (pts0[..., 1] >= m) & (pts0[..., 1] < H - m))
    B = img0.shape[0]
    grid = _pixel_grid(H, W, img0.device).expand(B, -1, -1)
    w01 = _warp_points(Hinv, grid).reshape(B, H, W, 2)
    wv = ((w01[..., 0] >= m) & (w01[..., 0] < W - m)
          & (w01[..., 1] >= m) & (w01[..., 1] < H - m))
    return dict(img0=img0[..., None], img1=img1[..., None], pts0=pts0,
                pts1=pts1, pt_valid=valid, Hmats=Hmats, warp01=w01,
                warp_valid=wv)


def synthetic_pair_batch(generator: torch.Generator, B: int, H: int, W: int,
                         G: int) -> Dict[str, torch.Tensor]:
    """Homography pairs drawn from ``generator``, on its device."""
    return synthetic_pair_batch_from_draws(
        synthetic_pair_draws(generator, B, H, W, G), H, W)


# --------------------------------------------------------------------------- #
# Scene-pair batches (rendered corridor views, real parallax)
# --------------------------------------------------------------------------- #

def _pair_arrays(B: int, H: int, W: int, G: int) -> Dict[str, np.ndarray]:
    """The zeroed arrays of a pair batch, in the layout of
    :func:`synthetic_pair_batch` without Hmats."""
    return dict(img0=np.zeros((B, H, W, 1), np.float32),
                img1=np.zeros((B, H, W, 1), np.float32),
                pts0=np.zeros((B, G, 2), np.float32),
                pts1=np.zeros((B, G, 2), np.float32),
                pt_valid=np.zeros((B, G), bool),
                warp01=np.zeros((B, H, W, 2), np.float32),
                warp_valid=np.zeros((B, H, W), bool))


def _sample_points(rng: np.random.Generator, out: Dict[str, np.ndarray],
                   b: int, in0: np.ndarray) -> None:
    """Sample ``b``'s sparse correspondences: up to G view-0 pixels drawn
    without replacement where the warp is valid inside the margin
    ``in0``, with their warped positions (the reference's draw)."""
    G, W = out["pts0"].shape[1], in0.shape[1]
    cand = np.flatnonzero((out["warp_valid"][b] & in0).reshape(-1))
    if len(cand):
        sel = rng.choice(cand, size=min(G, len(cand)), replace=False)
        k = len(sel)
        out["pts0"][b, :k] = np.stack([(sel % W), (sel // W)], 1)
        out["pts1"][b, :k] = out["warp01"][b].reshape(-1, 2)[sel]
        out["pt_valid"][b, :k] = True


class ScenePairPool:
    """Views of rendered scenes (image, raycast hit point, ray depth), the
    blocks alternating over ``families`` (``corridor``, ``boxes``,
    ``photo``); :meth:`batch` samples nearby-view pairs with exact,
    occlusion-checked correspondences. The reference's K scaling,
    trajectories and per-scene seeds; the photo family takes the training
    photographs (:func:`train_photo_paths`). The views are rendered on
    ``device`` (None: the GPU) and kept on the host for :meth:`batch`,
    whose draws follow the reference's order, so one
    ``np.random.Generator`` gives the same crops, pairs and points. The
    reference's disk cache of rendered blocks is dropped: a view renders on
    the card in milliseconds. An unknown family raises ``KeyError``, as the
    reference's lookup does."""

    def __init__(self, hw, n_views: int = 160, seed: int = 0,
                 n_scenes: int = 4, render_hw=None,
                 families: Tuple[str, ...] = ("corridor",), device=None):
        from simpleslam_tpu_torch.tools.synth import (DEFAULT_K,
                                                      SCENE_FAMILIES,
                                                      make_trajectory)
        H, W = hw
        Hr, Wr = render_hw if render_hw is not None else (H, W)
        if Hr < H or Wr < W:
            raise ValueError("render_hw must contain the crop hw")
        s = Wr / 1232.0
        K = DEFAULT_K.copy()
        K[0] *= s
        K[1] *= s
        K[1, 2] = 0.487 * Hr
        self.K = K.astype(np.float64)
        self.hw = (H, W)
        self.render_hw = (Hr, Wr)
        rng = np.random.default_rng(seed)
        per = max(2, n_views // n_scenes)
        imgs, pts, depth, poses = [], [], [], []
        for sc in range(n_scenes):
            fam = families[sc % len(families)]
            T = make_trajectory(per, speed=float(rng.uniform(0.2, 0.8)),
                                yaw_rate_deg=float(rng.uniform(0.0, 0.8)))
            # the photo family's default photographs are the held-out
            # split; training renders take the disjoint training half
            fam_kw = {"photos": train_photo_paths()} if fam == "photo" \
                else {}
            scene = SCENE_FAMILIES[fam](seed=seed + sc, hw=(Hr, Wr), K=K,
                                        device=resolve_device(device),
                                        **fam_kw)
            for i in range(per):
                img, hit, t = scene.render_with_geometry(T[i])
                imgs.append(img.cpu().numpy())
                pts.append(hit.float().cpu().numpy())
                depth.append(np.nan_to_num(t.cpu().numpy(), posinf=1e9)
                             .astype(np.float32))
                poses.append(T[i].astype(np.float64))
        self.set_views(imgs, pts, depth, poses, per)

    def set_views(self, imgs, pts, depth, poses, per: int) -> None:
        """Replace the pool's views (lists of (Hr, Wr) uint8 images,
        (Hr, Wr, 3) float32 hit points, (Hr, Wr) float32 depths, 4x4
        poses; ``per`` views per scene block)."""
        self.imgs, self.pts, self.depth, self.poses = \
            list(imgs), list(pts), list(depth), list(poses)
        self.n = len(self.imgs)
        self._per = per

    def batch(self, rng: np.random.Generator, B: int, G: int,
              max_gap: int = 4,
              scale_jitter: float = 0.25) -> Dict[str, np.ndarray]:
        """Correspondence-labelled view pairs (numpy), the dict layout of
        :func:`synthetic_pair_batch` without Hmats. Each sample is a random
        crop of both views; view 1 is cropped at a jittered size and
        resized to ``hw`` (cv2's INTER_AREA when shrinking, INTER_LINEAR
        otherwise). warp01/warp_valid hold the raycast correspondence of
        every view-0 crop pixel."""
        H, W = self.hw
        Hr, Wr = self.render_hw
        K = self.K
        out = _pair_arrays(B, H, W, G)
        img0, img1, warp01, warp_valid = (out[k] for k in (
            "img0", "img1", "warp01", "warp_valid"))
        m = MARGIN
        yy, xx = np.mgrid[0:H, 0:W]
        in0 = (xx >= m) & (xx < W - m) & (yy >= m) & (yy < H - m)
        for b in range(B):
            i = int(rng.integers(0, self.n))
            blk = i // self._per
            lo_i, hi_i = blk * self._per, min((blk + 1) * self._per,
                                              self.n) - 1
            j = int(np.clip(i + rng.integers(1, max_gap + 1)
                            * (1 if rng.random() < 0.5 else -1), lo_i, hi_i))
            if j == i:
                j = min(i + 1, hi_i)
            s = float(np.exp(rng.uniform(-np.log(1 + scale_jitter),
                                         np.log(1 + scale_jitter)))) \
                if scale_jitter > 0 else 1.0
            H1 = int(np.clip(round(H * s), 32, Hr))
            W1 = int(np.clip(round(W * s), 32, Wr))
            ox0 = int(rng.integers(0, Wr - W + 1))
            oy0 = int(rng.integers(0, Hr - H + 1))
            # centre view 1's crop on the projected centre of view 0's
            Xc0 = self.pts[i][oy0 + H // 2, ox0 + W // 2]
            T1c = np.linalg.inv(self.poses[j])
            pc = T1c[:3, :3] @ Xc0 + T1c[:3, 3]
            zc = max(float(pc[2]), 1e-3)
            uc = float(pc[0] / zc * K[0, 0] + K[0, 2])
            vc = float(pc[1] / zc * K[1, 1] + K[1, 2])
            jx = float(rng.uniform(-0.25, 0.25)) * W1
            jy = float(rng.uniform(-0.25, 0.25)) * H1
            ox1 = int(np.clip(round(uc - W1 / 2 + jx), 0, Wr - W1))
            oy1 = int(np.clip(round(vc - H1 / 2 + jy), 0, Hr - H1))
            img0[b, ..., 0] = self.imgs[i][oy0:oy0 + H, ox0:ox0 + W] / 255.0
            crop1 = torch.from_numpy(
                self.imgs[j][oy1:oy1 + H1, ox1:ox1 + W1].astype(np.float32))
            resize = resize_area if s > 1 else resize_linear
            img1[b, ..., 0] = resize(crop1, (H, W)).numpy() / 255.0
            sx, sy = W / W1, H / H1

            # dense warp: every view-0 crop pixel's hit point in view 1
            Xw = self.pts[i][oy0:oy0 + H, ox0:ox0 + W].reshape(-1, 3)
            Xc = Xw @ T1c[:3, :3].T + T1c[:3, 3]
            z = Xc[:, 2]
            uv = (Xc[:, :2] / np.maximum(z[:, None], 1e-6)) \
                * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
            # occlusion: view 1's ray depth at uv must match |Xc|
            ui = np.clip(uv[:, 0].astype(int), 0, Wr - 1)
            vi = np.clip(uv[:, 1].astype(int), 0, Hr - 1)
            d1 = self.depth[j][vi, ui]
            r1 = np.linalg.norm(Xc, axis=1)
            inb_r = (z > 0.2) & (uv[:, 0] >= 0) & (uv[:, 0] < Wr) \
                & (uv[:, 1] >= 0) & (uv[:, 1] < Hr)
            vis = inb_r & (np.abs(d1 - r1) < 0.15 * np.maximum(r1, 1.0))
            u1 = (uv[:, 0] - ox1) * sx
            v1 = (uv[:, 1] - oy1) * sy
            in_crop1 = (u1 >= m) & (u1 < W - m) & (v1 >= m) & (v1 < H - m)
            warp01[b] = np.stack([u1, v1], 1).reshape(H, W, 2)
            warp_valid[b] = (vis & in_crop1).reshape(H, W)

            _sample_points(rng, out, b, in0)
        return out


class PhotoPairPool:
    """Homography pairs over photographs (the training half,
    :func:`train_photo_paths`): real sensor statistics that the renderer
    cannot make. Each sample is a random (H, W) crop of a random photograph
    at one of its pre-scales (halvings by ``INTER_AREA``), warped by a
    random homography (:meth:`_random_h`), with the exact dense
    correspondence field; the dict layout of :class:`ScenePairPool`.
    :meth:`batch` draws from the generator in the reference's order, so
    one ``np.random.Generator`` gives the reference's crops, homographies
    and points. The photographs are read and normalised on the host; each
    batch's warps run on ``device`` (None: the GPU), one upload and one
    read-back a batch."""

    def __init__(self, hw, paths, seed: int = 0, device=None):
        from simpleslam_tpu_torch.utils.imgproc import imread_gray
        self.device = resolve_device(device)
        H, W = hw
        self.hw = (int(H), int(W))
        self.imgs = []
        for p in paths:
            img = imread_gray(p)
            if img is None:
                continue
            img = img.astype(np.float32)
            # per-photo contrast normalisation, in the reference's numpy
            # expression (its dtype follows numpy's promotion rules)
            lo, hi = np.percentile(img, [2, 98])
            img = np.clip((img - lo) / max(hi - lo, 1.0), 0.0, 1.0)
            # pre-scales: the pipeline's texture scale varies with depth
            pyr = [img]
            for _ in range(2):
                if min(pyr[-1].shape) < 2 * min(H, W):
                    break
                pyr.append(resize_area(
                    torch.from_numpy(pyr[-1]),
                    (pyr[-1].shape[0] // 2, pyr[-1].shape[1] // 2)).numpy())
            self.imgs.extend(p2 for p2 in pyr
                             if p2.shape[0] >= H + 8 and p2.shape[1] >= W + 8)
        if not self.imgs:
            raise FileNotFoundError("PhotoPairPool: no usable photos")

    @staticmethod
    def _random_h(rng: np.random.Generator, H: int, W: int,
                  mag: float = 0.15) -> np.ndarray:
        """Corner-jitter homography composed with a random similarity
        (rotation up to 15 degrees, scale exp(+-0.22)) about the crop
        centre, float64."""
        from simpleslam_tpu_torch.utils.imgproc import (
            get_perspective_transform, get_rotation_matrix_2d)
        c0 = np.float32([[0, 0], [W - 1, 0], [0, H - 1], [W - 1, H - 1]])
        c1 = c0 + rng.uniform(-mag, mag, (4, 2)).astype(np.float32) \
            * np.float32([W, H])
        Hm = get_perspective_transform(c0, c1)
        ang = rng.uniform(-15.0, 15.0)
        s = float(np.exp(rng.uniform(-0.22, 0.22)))
        S = np.eye(3)
        S[:2] = get_rotation_matrix_2d((W / 2.0, H / 2.0), ang, s)
        return (S @ Hm).astype(np.float64)

    def batch(self, rng: np.random.Generator, B: int, G: int
              ) -> Dict[str, np.ndarray]:
        """Warped-crop pairs (numpy), the layout of
        :meth:`ScenePairPool.batch`."""
        from simpleslam_tpu_torch.utils.imgproc import warp_perspective
        H, W = self.hw
        out = _pair_arrays(B, H, W, G)
        img0, img1, warp01, warp_valid = (out[k] for k in (
            "img0", "img1", "warp01", "warp_valid"))
        m = MARGIN
        yy, xx = np.mgrid[0:H, 0:W]
        in0 = (xx >= m) & (xx < W - m) & (yy >= m) & (yy < H - m)
        grid = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(-1, 3) \
            .astype(np.float64)
        crops, mats = [], []
        for b in range(B):
            src = self.imgs[int(rng.integers(0, len(self.imgs)))]
            oy = int(rng.integers(0, src.shape[0] - H + 1))
            ox = int(rng.integers(0, src.shape[1] - W + 1))
            crop = src[oy:oy + H, ox:ox + W]
            Hm = self._random_h(rng, H, W)
            img0[b, ..., 0] = crop
            crops.append(crop)
            mats.append(Hm.astype(np.float32))
            q = grid @ Hm.T
            uv = q[:, :2] / np.maximum(np.abs(q[:, 2:3]), 1e-9) \
                * np.sign(q[:, 2:3])
            warp01[b] = uv.reshape(H, W, 2).astype(np.float32)
            wv = ((uv[:, 0] >= m) & (uv[:, 0] < W - m)
                  & (uv[:, 1] >= m) & (uv[:, 1] < H - m)).reshape(H, W)
            warp_valid[b] = wv
            _sample_points(rng, out, b, in0)
        # the warps draw nothing: all of them on the device at once
        dev_crops = torch.from_numpy(np.stack(crops)).to(self.device)
        img1[..., 0] = torch.stack([
            warp_perspective(dev_crops[b], mats[b], (W, H))
            for b in range(B)]).cpu().numpy()
        return out


def train_photo_paths() -> list:
    """The training photographs: the odd-indexed half of
    ``tools/synth.py::REAL_PHOTO_GLOB``'s sorted matches, plus matplotlib's
    ``grace_hopper.jpg`` where matplotlib is installed. The even half is
    held out for evaluation (``PhotoScene``'s default textures,
    ``tools/real_eval.py --split heldout``)."""
    import glob as globmod
    import os

    from simpleslam_tpu_torch.tools import synth

    paths = sorted(globmod.glob(synth.REAL_PHOTO_GLOB))[1::2]
    try:
        import matplotlib

        gh = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data",
                          "sample_data", "grace_hopper.jpg")
        if os.path.exists(gh):
            paths.append(gh)
    except Exception:
        pass
    return paths


def photometric_augment(rng: np.random.Generator,
                        batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Independent brightness/contrast/gamma/noise jitter per view (numpy,
    the reference's draws in its order)."""
    out = dict(batch)
    for k in ("img0", "img1"):
        img = np.asarray(batch[k], np.float32)
        B = img.shape[0]
        gain = rng.uniform(0.6, 1.4, (B, 1, 1, 1)).astype(np.float32)
        bias = rng.uniform(-0.15, 0.15, (B, 1, 1, 1)).astype(np.float32)
        gamma = rng.uniform(0.7, 1.4, (B, 1, 1, 1)).astype(np.float32)
        noise = rng.normal(0, rng.uniform(0.0, 0.03),
                           img.shape).astype(np.float32)
        img = np.clip(img, 0, 1) ** gamma
        img = np.clip(img * gain + bias + noise, 0.0, 1.0)
        out[k] = img
    return out


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #

def _bilinear_sample(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                     ) -> torch.Tensor:
    """``aliked._bilinear_sample`` over a batch: (B, Hf, Wf, C) at (B, N)
    coordinates -> (B, N, C)."""
    B, Hf, Wf, C = fmap.shape
    x = torch.clamp(x, 0.0, Wf - 1.001)
    y = torch.clamp(y, 0.0, Hf - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    base = y0 * Wf + x0
    idx = aliked_mod._flat_index(
        torch.stack([base, base + 1, base + Wf, base + Wf + 1], -1), Hf * Wf)
    rows = torch.arange(B, device=fmap.device)[:, None, None]
    v = fmap.reshape(B, Hf * Wf, C)[rows, idx]                 # (B, N, 4, C)
    return (v[..., 0, :] * ((1 - fx) * (1 - fy))
            + v[..., 1, :] * (fx * (1 - fy))
            + v[..., 2, :] * ((1 - fx) * fy) + v[..., 3, :] * (fx * fy))


def _sample_many(desc_map: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, Hf, Wf, D) half-resolution maps at full-resolution (B, G, 2)
    pixels -> (B, G, D) unit descriptors."""
    d = _bilinear_sample(desc_map, pts[..., 0] * 0.5, pts[..., 1] * 0.5)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-8)


def _peak_align_loss(score0, score1, warp01, wvalid, n_peaks: int = 128,
                     r: int = 3, tau: float = 0.5) -> torch.Tensor:
    """Detector repeatability by peak alignment, (B,) losses: view 0's
    strongest NMS peaks (chosen without gradient) are carried through the
    dense warp into view 1, whose score map must peak at the warped pixel
    within its (2r+1)^2 window (a local softmax NLL)."""
    B, H, W = score0.shape
    dev = score0.device
    nms = aliked_mod._nms_mask(score0, 2)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    border = 8
    inb = ((xx >= border) & (xx < W - border)
           & (yy >= border) & (yy < H - border))
    gated = torch.where(nms & inb & wvalid, score0,
                        torch.full_like(score0, -math.inf))
    v, idx = torch.topk(gated.detach().reshape(B, -1), n_peaks)
    ok = torch.isfinite(v)
    q = warp01.reshape(B, H * W, 2).gather(
        1, idx[..., None].expand(-1, -1, 2))                  # (B, P, 2)
    ok &= (q[..., 0] >= r + 1) & (q[..., 0] < W - r - 1) \
        & (q[..., 1] >= r + 1) & (q[..., 1] < H - r - 1)
    qx = torch.clamp(torch.round(q[..., 0]).long(), r, W - 1 - r)
    qy = torch.clamp(torch.round(q[..., 1]).long(), r, H - 1 - r)
    d = torch.arange(-r, r + 1, device=dev)
    win = ((qy[..., None, None] + d[:, None]) * W
           + qx[..., None, None] + d[None, :]).reshape(B, n_peaks, -1)
    Wn = score1.reshape(B, 1, H * W).expand(B, n_peaks, H * W).gather(2, win)
    logp = torch.log_softmax(Wn / tau, -1)
    center = (2 * r + 1) * r + r
    return -torch.where(ok, logp[..., center], torch.zeros_like(v)).sum(-1) \
        / torch.clamp(ok.sum(-1), min=1)


def loss_fn(aliked: nn.Module, lightglue: nn.Module,
            batch: Dict[str, torch.Tensor], image_hw: Tuple[int, int],
            n_valid: Optional[torch.Tensor] = None,
            batch_share: Optional[float] = None):
    """(total, {"desc", "rep", "peak", "match", "sig", "total"}), 0-d
    tensors on the batch's device.

    For a shard of a batch (the sharded step): ``n_valid`` is the whole
    batch's valid-point count and ``batch_share`` the shard's share of its
    samples, so each term is the shard's part of the whole batch's term
    and the parts add up to it."""
    score0, dmap0 = aliked(batch["img0"])
    score1, dmap1 = aliked(batch["img1"])
    pts0, pts1 = batch["pts0"], batch["pts1"]
    pv = batch["pt_valid"]
    if n_valid is None:
        n_valid = torch.clamp(pv.sum(), min=1)

    def share(mean):
        return mean if batch_share is None else mean * batch_share

    d0 = _sample_many(dmap0, pts0)            # (B, G, D)
    d1 = _sample_many(dmap1, pts1)

    # descriptor InfoNCE within each pair, both directions
    sim = torch.einsum("bgd,bhd->bgh", d0, d1) / 0.1
    sim01 = torch.where(pv[:, None, :], sim, torch.full_like(sim, -1e9))
    logp01 = torch.log_softmax(sim01, -1)
    sim10 = torch.where(pv[:, :, None], sim, torch.full_like(sim, -1e9))
    logp10 = torch.log_softmax(sim10, -2)
    diag = (torch.diagonal(logp01, dim1=1, dim2=2)
            + torch.diagonal(logp10, dim1=1, dim2=2)) * 0.5
    zero = torch.zeros_like(diag)
    l_desc = -torch.where(pv, diag, zero).sum() / n_valid

    # score repeatability: score1 at pts1 should equal score0 at pts0
    s0 = _bilinear_sample(score0[..., None], pts0[..., 0],
                          pts0[..., 1])[..., 0]
    s1 = _bilinear_sample(score1[..., None], pts1[..., 0],
                          pts1[..., 1])[..., 0]
    l_rep = torch.where(pv, (s0 - s1) ** 2, zero).sum() / n_valid

    if "warp01" in batch:
        l_peak = share(_peak_align_loss(score0, score1, batch["warp01"],
                                        batch["warp_valid"]).mean())
    else:
        l_peak = torch.zeros((), device=score0.device)
    # anti-collapse; the magnitude penalty is clamped
    l_reg = share(torch.relu(1.0 - torch.std(score0, dim=(1, 2),
                                             correction=0)).mean()
                  + 0.01 * torch.clamp(score0 ** 2, max=1e4).mean())

    # LightGlue assignment NLL at the ground-truth correspondences
    P, sig0, _sig1 = lightglue(pts0, d0, pv, pts1, d1, pv, image_hw)
    diagP = torch.diagonal(P, dim1=1, dim2=2)
    l_match = -torch.where(pv, torch.log(diagP + 1e-9), zero).sum() / n_valid
    sig0c = torch.clamp(sig0, 1e-6, 1.0 - 1e-6)
    l_sig = -share(torch.where(pv, torch.log(sig0c),
                               torch.log(1.0 - sig0c)).mean())

    total = (l_desc + 0.5 * l_rep + 0.5 * l_peak + 0.1 * l_reg
             + l_match + 0.1 * l_sig)
    return total, {"desc": l_desc, "rep": l_rep, "peak": l_peak,
                   "match": l_match, "sig": l_sig, "total": total}


def loss_and_grad(models: Dict[str, nn.Module],
                  batch: Dict[str, torch.Tensor], image_hw: Tuple[int, int]):
    """(loss metrics, the flat gradient over :func:`param_list`)."""
    params = param_list(models)
    with span("train.forward"):
        total, metrics = loss_fn(models["aliked"], models["lightglue"],
                                 batch, image_hw)
    with span("train.backward"):
        grads = torch.autograd.grad(total, params)
        flat = torch.cat([g.reshape(-1) for g in grads])
    return {k: v.detach() for k, v in metrics.items()}, flat


def make_train_step(tx: AdamWChain, image_hw: Tuple[int, int]):
    """``train_step(state, batch) -> (state, metrics)``: the loss, its
    gradient and one update of the state's parameters in place."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics, grad = loss_and_grad(state.models, batch, image_hw)
        with span("train.optimizer"):
            opt_state, _gnorm = tx.update_(state.flat, grad,
                                           state.opt_state)
        return state._replace(opt_state=opt_state, step=state.step + 1), \
            metrics

    return train_step


# --------------------------------------------------------------------------- #
# Sharded training over a (dp, tp) mesh
# --------------------------------------------------------------------------- #

class _CopyToTP(torch.autograd.Function):
    """Identity forward; backward sums the input gradient over the tp group
    (each rank's column slice of a layer gives part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather column slices along the last axis over the tp group;
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group, rank, n):
        ctx.rank, ctx.k = rank, y.shape[-1]
        parts = [torch.empty_like(y) for _ in range(n)]
        torch.distributed.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.k:(ctx.rank + 1) * ctx.k], None, None, \
            None


class ColumnParallelDense(nn.Module):
    """``lightglue.Dense`` with its output features split over the tp
    group: this rank holds rows ``[rank k, (rank + 1) k)`` of the weight
    (``weight.tp_sharded`` is set), computes that slice of the output and
    all-gathers the rest; the bias is replicated and added after the
    gather, as the dense layer adds it after the product."""

    def __init__(self, dense: nn.Module, group, rank: int, n: int):
        super().__init__()
        k = dense.out_features // n
        self.group, self.rank, self.n = group, rank, n
        self.dtype = dense.dtype
        self.weight = nn.Parameter(
            dense.weight.detach()[rank * k:(rank + 1) * k].clone())
        self.weight.tp_sharded = True
        self.bias = None if dense.bias is None else \
            nn.Parameter(dense.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x = _CopyToTP.apply(x, self.group)
        y = x.to(dt) @ self.weight.to(dt).T
        y = _GatherFromTP.apply(y, self.group, self.rank, self.n)
        return y + self.bias.to(dt) if self.bias is not None else y


def _tp_rule(weight: torch.Tensor, tp: int) -> bool:
    """The reference's rule: a dense kernel whose output width divides by
    tp and is at least 64 is split along its outputs."""
    return weight.dim() == 2 and weight.shape[0] % tp == 0 \
        and weight.shape[0] >= 64


def shard_params_for_tp(models: Dict[str, nn.Module], mesh
                        ) -> Dict[str, nn.Module]:
    """This rank's copy of ``models``: every dense layer that the
    reference's rule splits over 'tp' becomes a
    :class:`ColumnParallelDense` holding this rank's rows; everything else
    is replicated. The input models are left as they are."""
    import copy

    from simpleslam_tpu_torch.parallel.mesh import axis_index, axis_size

    tp = axis_size(mesh, "tp")
    out = {k: copy.deepcopy(m) for k, m in models.items()}
    if tp == 1:
        return out
    group, rank = mesh.get_group("tp"), axis_index(mesh, "tp")
    for m in out.values():
        for parent in list(m.modules()):
            for name, child in list(parent.named_children()):
                if isinstance(child, lg_mod.Dense) \
                        and _tp_rule(child.weight, tp):
                    setattr(parent, name,
                            ColumnParallelDense(child, group, rank, tp))
    return out


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """A train state whose parameters and optimizer moments are this
    rank's shards (:func:`shard_params_for_tp`) of ``state``'s."""
    from simpleslam_tpu_torch.parallel.mesh import axis_index, axis_size

    models = shard_params_for_tp(state.models, mesh)
    tp, rank = axis_size(mesh, "tp"), axis_index(mesh, "tp")

    def local(vec: torch.Tensor) -> torch.Tensor:
        parts, off = [], 0
        for p_full, p in zip(param_list(state.models), param_list(models)):
            v = vec[off:off + p_full.numel()].view_as(p_full)
            if getattr(p, "tp_sharded", False):
                k = p_full.shape[0] // tp
                v = v[rank * k:(rank + 1) * k]
            parts.append(v.reshape(-1))
            off += p_full.numel()
        return torch.cat(parts)

    flat = flatten_params_(param_list(models))
    opt = state.opt_state
    return TrainState(models, flat, OptState(opt.count, local(opt.mu),
                                             local(opt.nu)), state.step)


def gather_flat(models: Dict[str, nn.Module], vec: torch.Tensor, mesh
                ) -> torch.Tensor:
    """A vector laid out as the sharded ``models``' flat buffer (their
    parameters or gradients) -> the whole, laid out as the unsharded
    models' buffer (:func:`param_list` order)."""
    from simpleslam_tpu_torch.parallel.mesh import axis_size

    tp = axis_size(mesh, "tp")
    parts, off = [], 0
    for p in param_list(models):
        v = vec[off:off + p.numel()].view_as(p)
        off += p.numel()
        if getattr(p, "tp_sharded", False) and tp > 1:
            got = [torch.empty_like(v) for _ in range(tp)]
            torch.distributed.all_gather(got, v.contiguous(),
                                         group=mesh.get_group("tp"))
            v = torch.cat(got)
        parts.append(v.reshape(-1))
    return torch.cat(parts)


def sharded_loss_and_grad(models: Dict[str, nn.Module],
                          batch: Dict[str, torch.Tensor],
                          image_hw: Tuple[int, int], mesh):
    """:func:`loss_and_grad` over a (dp, tp) mesh: this rank's dp slice of
    the whole ``batch``, its terms scaled by the whole batch's valid count
    and sample count, the metrics and the gradient (laid out as the
    sharded models' flat buffer) summed over the dp group."""
    from simpleslam_tpu_torch.parallel.mesh import dp_slice

    B = batch["img0"].shape[0]
    s = dp_slice(mesh, B)
    params = param_list(models)
    group = mesh.get_group("dp")
    with span("train.forward"):
        total, metrics = loss_fn(
            models["aliked"], models["lightglue"],
            {k: v[s] for k, v in batch.items()}, image_hw,
            n_valid=torch.clamp(batch["pt_valid"].sum(), min=1),
            batch_share=(s.stop - s.start) / B)
    with span("train.backward"):
        grads = torch.autograd.grad(total, params)
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=group)
    names = sorted(metrics)
    m = torch.stack([metrics[k].detach().float() for k in names])
    torch.distributed.all_reduce(m, group=group)
    return dict(zip(names, m)), flat


def make_sharded_train_step(tx: AdamWChain, image_hw: Tuple[int, int],
                            mesh):
    """``train_step(state, batch) -> (state, metrics)`` over a (dp, tp)
    mesh: every rank is handed the whole batch and the state made by
    :func:`shard_train_state`; the batch is split over 'dp', the split
    dense layers over 'tp'. It equals :func:`make_train_step`'s step up to
    float reassociation: the loss terms are normalised by the whole batch,
    and the clip sees the norm of the whole gradient."""
    from simpleslam_tpu_torch.parallel.mesh import axis_size

    tp_group = mesh.get_group("tp") if axis_size(mesh, "tp") > 1 else None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics, grad = sharded_loss_and_grad(state.models, batch, image_hw,
                                              mesh)
        norm_fn = None        # without tp every rank holds the whole gradient
        if tp_group is not None:
            shard = torch.cat([            # the entries split over tp
                torch.full((p.numel(),), getattr(p, "tp_sharded", False),
                           device=grad.device)
                for p in param_list(state.models)])

            def norm_fn(g):
                sq = g * g
                zero = torch.zeros_like(sq)
                own = torch.where(shard, sq, zero).sum()
                torch.distributed.all_reduce(own, group=tp_group)
                return torch.sqrt(torch.where(shard, zero, sq).sum() + own)

        with span("train.optimizer"):
            opt_state, _gnorm = tx.update_(state.flat, grad, state.opt_state,
                                           norm_fn=norm_fn)
        return state._replace(opt_state=opt_state, step=state.step + 1), \
            metrics

    return train_step
