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

Not ported yet: the sharded step (``shard_params_for_tp``,
``make_sharded_train_step``; ROADMAP A.10).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from simpleslam_tpu_torch.models import aliked as aliked_mod
from simpleslam_tpu_torch.models import lightglue as lg_mod
from simpleslam_tpu_torch.ops.epipolar import fit_homography
from simpleslam_tpu_torch.utils.device import resolve_device
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
                state: OptState) -> Tuple[OptState, torch.Tensor]:
        """Apply one update to ``flat`` in place; returns the new state and
        the global norm of the sanitised gradient (0-d, on the device)."""
        b1, b2 = self.B1, self.B2
        g = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
        gnorm = torch.linalg.vector_norm(g)
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
            batch: Dict[str, torch.Tensor], image_hw: Tuple[int, int]):
    """(total, {"desc", "rep", "peak", "match", "sig", "total"}), 0-d
    tensors on the batch's device."""
    score0, dmap0 = aliked(batch["img0"])
    score1, dmap1 = aliked(batch["img1"])
    pts0, pts1 = batch["pts0"], batch["pts1"]
    pv = batch["pt_valid"]
    n_valid = torch.clamp(pv.sum(), min=1)

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
        l_peak = _peak_align_loss(score0, score1, batch["warp01"],
                                  batch["warp_valid"]).mean()
    else:
        l_peak = torch.zeros((), device=score0.device)
    # anti-collapse; the magnitude penalty is clamped
    l_reg = torch.relu(1.0 - torch.std(score0, dim=(1, 2), correction=0)) \
        .mean() + 0.01 * torch.clamp(score0 ** 2, max=1e4).mean()

    # LightGlue assignment NLL at the ground-truth correspondences
    P, sig0, _sig1 = lightglue(pts0, d0, pv, pts1, d1, pv, image_hw)
    diagP = torch.diagonal(P, dim1=1, dim2=2)
    l_match = -torch.where(pv, torch.log(diagP + 1e-9), zero).sum() / n_valid
    sig0c = torch.clamp(sig0, 1e-6, 1.0 - 1e-6)
    l_sig = -torch.where(pv, torch.log(sig0c), torch.log(1.0 - sig0c)).mean()

    total = (l_desc + 0.5 * l_rep + 0.5 * l_peak + 0.1 * l_reg
             + l_match + 0.1 * l_sig)
    return total, {"desc": l_desc, "rep": l_rep, "peak": l_peak,
                   "match": l_match, "sig": l_sig, "total": total}


def loss_and_grad(models: Dict[str, nn.Module],
                  batch: Dict[str, torch.Tensor], image_hw: Tuple[int, int]):
    """(loss metrics, the flat gradient over :func:`param_list`)."""
    params = param_list(models)
    total, metrics = loss_fn(models["aliked"], models["lightglue"], batch,
                             image_hw)
    grads = torch.autograd.grad(total, params)
    return {k: v.detach() for k, v in metrics.items()}, \
        torch.cat([g.reshape(-1) for g in grads])


def make_train_step(tx: AdamWChain, image_hw: Tuple[int, int]):
    """``train_step(state, batch) -> (state, metrics)``: the loss, its
    gradient and one update of the state's parameters in place."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics, grad = loss_and_grad(state.models, batch, image_hw)
        opt_state, _gnorm = tx.update_(state.flat, grad, state.opt_state)
        return state._replace(opt_state=opt_state, step=state.step + 1), \
            metrics

    return train_step
