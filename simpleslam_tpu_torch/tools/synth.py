"""Synthetic sequences (the counterpart of the corridor and box scenes of
``simpleslam_tpu/tools/synth.py``).

Three raycast scene families: a textured corridor (ground plane, two
walls, a high ceiling and a far wall, all static world geometry), a box
field (a textured ground plane and axis-aligned boxes under a flat sky,
the reference's held-out family and its loop-closure fixture) and the
corridor's geometry textured with photographs (``PhotoScene``), rendered
along a smooth KITTI-like trajectory or a closed lap. The procedural
texture is a fixed sum of random 3-D sinusoids (the boxes add hard-edged
square waves) evaluated at the hit points, anti-aliased per pixel, so
appearance is consistent across views: real parallax and stable
descriptors.

Each frame is one torch expression on the scene's device: the ray
geometry in float64, the (H, W, n_waves) texture in float32, as the
reference's numpy path computes them. The scene parameters (the random
waves) are drawn with numpy exactly as the reference draws them, so one
seed gives the same scene in both packages.

``generate_kitti_sequence`` writes a rendered sequence in the KITTI
odometry layout (``kitti/05/image_0/%06d.png``, ``kitti/poses/05.txt``,
and ``kitti/05/calib.txt`` for the ``crop`` camera) with
``utils/png.py``; ``main`` is its CLI:

    python -m simpleslam_tpu_torch.tools.synth --out D --frames 40 \
        [--scene corridor|boxes|photo] [--device cpu]

``--scene photo`` reads its photographs through ``REAL_PHOTO_GLOB`` (the
environment's ``SLAM_PHOTO_GLOB``); the repository carries none.
"""
from __future__ import annotations

import argparse
import hashlib
import os
from typing import Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.png import write_png

DEFAULT_K = np.array([[707.0912, 0.0, 601.8873],
                      [0.0, 707.0912, 183.1104],
                      [0.0, 0.0, 1.0]])
DEFAULT_HW = (370, 1226)      # KITTI grayscale camera resolution


def renderer_version() -> str:
    """Short hash of this module's source, for keying caches of renders."""
    with open(__file__, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()[:12]


def make_trajectory(n_frames: int, speed: float = 0.5,
                    yaw_rate_deg: float = 0.25) -> np.ndarray:
    """(N,4,4) T_wc camera-to-world poses: forward motion with gentle yaw."""
    out = [np.eye(4)]
    yaw = 0.0
    pos = np.zeros(3)
    for _ in range(n_frames - 1):
        yaw += np.radians(yaw_rate_deg)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                      [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        pos = pos + R @ np.array([0.0, 0.0, speed])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        out.append(T)
    return np.stack(out)


def _drive(yaw_steps, speed: float) -> np.ndarray:
    """(N,4,4) T_wc poses: yaw by each step, then advance ``speed`` along
    the camera's z axis."""
    out = [np.eye(4)]
    yaw, pos = 0.0, np.zeros(3)
    for step in yaw_steps:
        yaw += step
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)],
                      [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]])
        pos = pos + R @ np.array([0.0, 0.0, speed])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        out.append(T)
    return np.stack(out)


def make_loop_trajectory(n_frames: int, speed: float = 0.5,
                         closure_frac: float = 0.8) -> np.ndarray:
    """(N,4,4) T_wc poses on a closed circle: the constant yaw rate brings
    the camera back to its start viewpoint after ``closure_frac *
    n_frames`` frames; then it drives the same circle again."""
    n_close = max(int(round(n_frames * closure_frac)), 8)
    return _drive([2.0 * np.pi / n_close] * (n_frames - 1), speed)


def make_square_loop_trajectory(n_frames: int, speed: float = 0.5,
                                closure_frac: float = 0.8,
                                corner_frames: int = 24) -> np.ndarray:
    """(N,4,4) T_wc poses on a closed rounded square: four straights joined
    by four 90-degree arcs of ``corner_frames`` frames, closing exactly at
    ``closure_frac * n_frames`` (then the same lap again)."""
    n_close = max(int(round(n_frames * closure_frac)), 16)
    n_close -= n_close % 4                       # identical quarters
    c = min(int(corner_frames), n_close // 4 - 1)
    s_q = n_close // 4 - c                       # straight frames per side
    lap = ([0.0] * s_q + [np.pi / 2 / c] * c) * 4
    return _drive([lap[i % n_close] for i in range(n_frames - 1)], speed)


class ProceduralTexture:
    """Fixed random sum of sinusoids over R^3 -> [0, 255] intensity,
    anti-aliased: each wave is attenuated by the Gaussian pixel-integration
    factor exp(-0.5 [(footprint/2)^2 |k|^2 + (k . smear)^2]), where
    ``footprint`` is the pixel's isotropic size on the surface (metres) and
    ``smear`` the major half-axis of its surface ellipse at grazing
    incidence."""

    def __init__(self, seed: int = 0, n_waves: int = 48, device=None):
        rng = np.random.default_rng(seed)
        d = rng.normal(size=(n_waves, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        freqs = np.concatenate([rng.uniform(0.3, 1.5, n_waves // 2),
                                rng.uniform(2.0, 8.0, n_waves - n_waves // 2)])
        k = d * freqs[:, None] * 2 * np.pi
        amps = 1.0 / np.sqrt(freqs)
        self.device = resolve_device(device)

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.k = t32(k)                                  # (n, 3) rad/m
        self.knorm = t32(freqs * 2 * np.pi)              # |k|
        self.phase = t32(rng.uniform(0, 2 * np.pi, n_waves))
        self.amp = t32(amps / amps.sum())

    def __call__(self, p: torch.Tensor, footprint: torch.Tensor,
                 smear_vec: torch.Tensor) -> torch.Tensor:
        """p, smear_vec (..., 3) and footprint (...) -> (...) float32."""
        v = p.float() @ self.k.T + self.phase
        q = (0.5 * footprint.float()[..., None] * self.knorm) ** 2
        q = q + (smear_vec.float() @ self.k.T) ** 2
        s = (torch.sin(v) * (self.amp * torch.exp(-0.5 * q))).sum(-1)
        return 127.5 + 120.0 * torch.clamp(s * 2.2, -1, 1)


class CorridorScene:
    """Ground plane + two walls + far wall, textured; raycast renderer on
    the given device (None: the GPU, see ``utils/device.py``)."""

    def __init__(self, seed: int = 0, ground_y: float = 1.6,
                 wall_x: float = 10.0, hw: Tuple[int, int] = DEFAULT_HW,
                 K: np.ndarray = DEFAULT_K, device=None):
        self.device = resolve_device(device)
        self.tex = ProceduralTexture(seed, device=self.device)
        self.ground_y = ground_y
        self.wall_x = wall_x
        self.hw = hw
        self.K = np.asarray(K, np.float64)
        H, W = hw
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64))
        rays = np.stack([u, v, np.ones_like(u)], -1) @ \
            np.linalg.inv(self.K).T
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        self._rays_cam = torch.as_tensor(rays, device=self.device)

    def render(self, T_wc: np.ndarray) -> torch.Tensor:
        """(H, W) uint8 image on the scene's device."""
        return self.render_with_geometry(T_wc)[0]

    @torch.no_grad()
    def render_with_geometry(self, T_wc: np.ndarray):
        """(image u8 (H,W), hit world points (H,W,3), ray depth (H,W))."""
        T = torch.as_tensor(np.asarray(T_wc, np.float64), device=self.device)
        C = T[:3, 3]
        d = self._rays_cam @ T[:3, :3].T                 # (H, W, 3) world
        H, W = self.hw
        t_best = torch.full((H, W), float("inf"), dtype=torch.float64,
                            device=self.device)
        hit = torch.zeros((H, W, 3), dtype=torch.float64, device=self.device)
        smear = torch.zeros((H, W, 3), dtype=torch.float32,
                            device=self.device)
        inv_f = 1.0 / float(self.K[0, 0])

        def plane(axis: int, value: float, positive: bool):
            nonlocal t_best, hit, smear
            denom = d[..., axis]
            t = (value - C[axis]) / torch.where(denom.abs() < 1e-9,
                                                torch.full_like(denom, 1e-9),
                                                denom)
            facing = denom > 0 if positive else denom < 0
            ok = (t > 0.2) & facing & (t < t_best)
            p = C + t[..., None] * d
            t_best = torch.where(ok, t, t_best)
            hit = torch.where(ok[..., None], p, hit)
            d_perp = d.clone()
            d_perp[..., axis] = 0.0
            s_vec = (0.5 * inv_f * t / torch.clamp(denom.abs(), min=1e-3)
                     )[..., None] * d_perp
            mag = torch.linalg.norm(s_vec, dim=-1, keepdim=True)
            s_vec = s_vec * (torch.clamp(mag, max=25.0)
                             / torch.clamp(mag, min=1e-12))
            smear = torch.where(ok[..., None], s_vec.float(), smear)

        plane(1, self.ground_y, True)                        # ground
        plane(0, self.wall_x, True)                          # right wall
        plane(0, -self.wall_x, False)                        # left wall
        plane(1, -3.0 * self.wall_x, False)                  # high ceiling
        far_z = float(np.floor(float(T_wc[2][3]) / 10.0) * 10.0 + 200.0)
        plane(2, far_z, True)                                # far wall

        fpx = torch.clamp(t_best, 0.0, 1e4) / float(self.K[0, 0])
        img = self.tex(hit, fpx, smear)
        shade = 1.0 / (1.0 + 0.004 * torch.clamp(t_best, 0, 200))
        out = torch.clamp(img.double() * shade, 0, 255).to(torch.uint8)
        return out, hit, t_best


class BoxScene:
    """Textured ground plane + scattered axis-aligned boxes under an
    untextured sky: finite objects, occlusion boundaries and featureless
    regions, with sinusoids mixed with square waves for texture. Same
    raycast API as :class:`CorridorScene`. ``path``: an explicit camera
    path (a closed lap); the box field then covers its bounding region and
    keeps boxes off the path."""

    def __init__(self, seed: int = 0, ground_y: float = 1.6,
                 n_boxes: int = 48, hw: Tuple[int, int] = DEFAULT_HW,
                 K: np.ndarray = DEFAULT_K, span_z: float = 250.0,
                 path: np.ndarray = None, device=None):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed + 77000)
        self.tex = ProceduralTexture(seed + 50000, device=self.device)
        d = rng.normal(size=(12, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        sq_k = (d * rng.uniform(0.5, 4.0, 12)[:, None] * 2 * np.pi
                ).astype(np.float32)
        self._sq_k = torch.as_tensor(sq_k, device=self.device)
        self._sq_knorm = torch.as_tensor(np.linalg.norm(sq_k, axis=1),
                                         device=self.device)
        self._sq_phase = torch.as_tensor(
            rng.uniform(0, 2 * np.pi, 12).astype(np.float32),
            device=self.device)
        self.ground_y = ground_y
        self.hw = hw
        self.K = np.asarray(K, np.float64)
        # the box field, drawn as the reference draws it: boxes that would
        # cut a radius-2.5 tube around the camera path are redrawn
        boxes = []
        n_target = max(n_boxes, 30)
        if path is not None:
            path = np.asarray(path, np.float64)
            x_lo, x_hi = path[:, 0].min() - 25.0, path[:, 0].max() + 25.0
            z_lo, z_hi = path[:, 2].min() - 10.0, path[:, 2].max() + 25.0
        while len(boxes) < n_target:
            sx, sy, sz = rng.uniform(1.0, 6.0, 3)
            cy = rng.uniform(-18.0, ground_y)
            if path is not None:
                cx = rng.uniform(x_lo, x_hi)
                cz = rng.uniform(z_lo, z_hi)
                half_diag = 0.5 * float(np.linalg.norm([sx, sy, sz]))
                d_path = np.min(np.linalg.norm(
                    path[:, [0, 2]] - np.array([cx, cz]), axis=1))
                if d_path < 2.5 + half_diag and cy > -2.5 - sy / 2:
                    continue
            else:
                cx = rng.uniform(-25.0, 25.0)
                cz = rng.uniform(4.0, max(span_z, 250.0))
                if abs(cx) < 2.5 + sx / 2 and abs(cy) < 2.5 + sy / 2:
                    continue
            boxes.append((np.array([cx - sx / 2, cy - sy / 2, cz - sz / 2]),
                          np.array([cx + sx / 2, cy + sy / 2, cz + sz / 2])))
        self._boxes = [(torch.as_tensor(lo, device=self.device),
                        torch.as_tensor(hi, device=self.device))
                       for lo, hi in boxes]
        H, W = hw
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64))
        rays = np.stack([u, v, np.ones_like(u)], -1) @ \
            np.linalg.inv(self.K).T
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        self._rays_cam = torch.as_tensor(rays, device=self.device)

    def _texture(self, p: torch.Tensor, footprint: torch.Tensor,
                 smear_vec: torch.Tensor) -> torch.Tensor:
        """Smooth waves (0.6) + square waves attenuated by the footprint
        Gaussian on their fundamental (0.4), float32."""
        smooth = self.tex(p, footprint, smear_vec)
        sq = torch.sign(torch.sin(p.float() @ self._sq_k.T + self._sq_phase))
        q = (0.5 * footprint.float()[..., None] * self._sq_knorm) ** 2
        q = q + (smear_vec.float() @ self._sq_k.T) ** 2
        sq = (sq * torch.exp(-0.5 * q)).mean(-1)
        return torch.clamp(0.6 * smooth + 0.4 * (127.5 + 120.0 * sq), 0, 255)

    def render(self, T_wc: np.ndarray) -> torch.Tensor:
        """(H, W) uint8 image on the scene's device."""
        return self.render_with_geometry(T_wc)[0]

    @torch.no_grad()
    def render_with_geometry(self, T_wc: np.ndarray):
        """(image u8 (H,W), hit world points (H,W,3), ray depth (H,W);
        sky pixels have depth inf and hit point 0)."""
        T = torch.as_tensor(np.asarray(T_wc, np.float64), device=self.device)
        C = T[:3, 3]
        d = self._rays_cam @ T[:3, :3].T
        dn = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        H, W = self.hw
        inv_f = 1.0 / float(self.K[0, 0])

        def smear_for(axis: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            # anisotropic half-axis 0.5 (t/f) d_perp / |d.n|
            cosi = d.gather(-1, axis[..., None]).abs()[..., 0]
            d_perp = d.scatter(-1, axis[..., None], 0.0)
            sv = (0.5 * inv_f * t / torch.clamp(cosi, min=1e-3))[..., None] \
                * d_perp
            mag = torch.linalg.norm(sv, dim=-1, keepdim=True)
            return (sv * (torch.clamp(mag, max=25.0)
                          / torch.clamp(mag, min=1e-12))).float()

        tg = (self.ground_y - C[1]) / dn[..., 1]
        okg = (tg > 0.2) & (d[..., 1] > 0)
        t_best = torch.where(okg, tg, torch.full_like(tg, float("inf")))
        smear = torch.where(okg[..., None], smear_for(
            torch.ones((H, W), dtype=torch.long, device=self.device), tg),
            torch.zeros((H, W, 3), device=self.device))
        for lo, hi in self._boxes:                   # slab test per box
            t1 = (lo - C) / dn
            t2 = (hi - C) / dn
            tmin = torch.minimum(t1, t2)
            tn = tmin.max(-1).values
            tf = torch.maximum(t1, t2).min(-1).values
            ok = (tn < tf) & (tf > 0.2) & (tn > 0.2) & (tn < t_best)
            t_best = torch.where(ok, tn, t_best)
            smear = torch.where(ok[..., None],
                                smear_for(tmin.argmax(-1), tn), smear)

        hitmask = torch.isfinite(t_best)
        t_safe = torch.where(hitmask, t_best, torch.zeros_like(t_best))
        hit = C + t_safe[..., None] * d
        fpx = t_safe / float(self.K[0, 0])
        img = torch.where(hitmask, self._texture(hit, fpx, smear),
                          torch.full_like(fpx, 230.0, dtype=torch.float32))
        shade = 1.0 / (1.0 + 0.004 * torch.clamp(t_safe, 0, 200))
        out = torch.clamp(img.double() * torch.where(
            hitmask, shade, torch.ones_like(shade)), 0, 255).to(torch.uint8)
        return (out, torch.where(hitmask[..., None], hit,
                                 torch.zeros_like(hit)),
                torch.where(hitmask, t_best,
                            torch.full_like(t_best, float("inf"))))


# The reference project's photographs (its webcam calibration frames) sit
# at ``config/calibrate_camera/images`` of its checkout; this repository
# does not carry them. ``SLAM_PHOTO_GLOB`` points the port elsewhere.
REAL_PHOTO_GLOB = os.environ.get("SLAM_PHOTO_GLOB", os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "config", "calibrate_camera", "images", "*.png"))


def _default_photo_set():
    """The held-out photographs for :class:`PhotoScene`'s textures: the
    even-indexed half of ``REAL_PHOTO_GLOB``'s sorted matches (the odd half
    is the training set, ``models/train.py::train_photo_paths``)."""
    import glob as globmod

    return sorted(globmod.glob(REAL_PHOTO_GLOB))[::2]


class PhotoScene:
    """The corridor's geometry (ground, two walls, a high ceiling and a far
    wall) textured with photographs: a mip-mapped bilinear lookup of one
    photograph per plane, mirror-tiled every ``TILE_M`` metres. Same
    raycast API as :class:`CorridorScene`: ``render`` /
    ``render_with_geometry`` -> (uint8 image, (H, W, 3) hit points, (H, W)
    depth, inf where no plane is hit).

    ``photos``: the image paths (default :func:`_default_photo_set`), read
    in the order of a permutation drawn from ``seed`` as the reference
    draws it. Each is contrast-normalised and blurred into its mip levels
    on the host (numpy's percentiles, ``utils/imgproc.py``'s blur in the
    dtype numpy's arithmetic gives), then uploaded once; frames render on
    ``device`` (None: the GPU), the geometry in float64."""

    #: metres of wall covered by one photo tile (mirror-tiled beyond)
    TILE_M = 8.0
    MIP_LEVELS = 5

    def __init__(self, seed: int = 0, ground_y: float = 1.6,
                 wall_x: float = 10.0, hw: Tuple[int, int] = DEFAULT_HW,
                 K: np.ndarray = DEFAULT_K, photos=None, device=None):
        from simpleslam_tpu_torch.utils.imgproc import (gaussian_blur,
                                                        imread_gray)
        self.device = resolve_device(device)
        paths = photos or _default_photo_set()
        if not paths:
            raise FileNotFoundError("PhotoScene: no real photos available")
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(paths))
        self._pyramids = []
        for i in order:
            img = imread_gray(paths[i])
            if img is None:
                continue
            img = img.astype(np.float32)
            # per-photo contrast normalisation, in the reference's numpy
            # expression (its result dtype follows numpy's promotion rules)
            lo, hi = np.percentile(img, [2, 98])
            img = np.clip((img - lo) * (235.0 / max(hi - lo, 1.0)) + 10.0,
                          0, 255)
            pyr = [torch.from_numpy(np.ascontiguousarray(img))]
            for _l in range(self.MIP_LEVELS - 1):
                pyr.append(gaussian_blur(pyr[-1], 2.0 ** len(pyr) * 0.5))
            self._pyramids.append(torch.stack(pyr).to(self.device))
        if not self._pyramids:
            raise FileNotFoundError("PhotoScene: photos failed to load")
        self.ground_y = ground_y
        self.wall_x = wall_x
        self.hw = hw
        self.K = np.asarray(K, np.float64)
        H, W = hw
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64))
        rays = np.stack([u, v, np.ones_like(u)], -1) @ \
            np.linalg.inv(self.K).T
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        self._rays_cam = torch.as_tensor(rays, device=self.device)

    def _sample_photo(self, idx: int, pu: torch.Tensor, pv: torch.Tensor,
                      footprint: torch.Tensor) -> torch.Tensor:
        """Mip-mapped bilinear lookup of photo ``idx`` at in-plane world
        coordinates (pu, pv) in metres; ``footprint`` is the pixel's size on
        the surface in metres. The level is the nearest integer of log2 of
        the footprint in texels, half to even as ``np.rint``."""
        stack = self._pyramids[idx % len(self._pyramids)]     # (LVL, h, w)
        h, w = stack.shape[1], stack.shape[2]
        texel = self.TILE_M / w
        lvl = torch.log2(torch.clamp(footprint, min=1e-9) / texel)
        lvl = torch.clamp(torch.round(lvl), 0, stack.shape[0] - 1).long()
        x = pu / texel
        y = pv / (self.TILE_M * h / w) * h
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx2 = (x - x0).float()
        fy2 = (y - y0).float()
        x0, y0 = x0.long(), y0.long()

        def mirror(i, n):
            m = torch.remainder(i, 2 * n)
            return torch.where(m < n, m, 2 * n - 1 - m)

        out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        wsum = ((1 - fx2) * (1 - fy2), fx2 * (1 - fy2),
                (1 - fx2) * fy2, fx2 * fy2)
        offs = ((0, 0), (1, 0), (0, 1), (1, 1))
        flat = stack.reshape(-1)
        for (dx, dy), wgt in zip(offs, wsum):
            xi = mirror(x0 + dx, w)
            yi = mirror(y0 + dy, h)
            vals = flat[(lvl * h + yi) * w + xi]
            # numpy's in-place ``out += wgt * vals``: the product and the
            # sum in the stack's dtype, stored as float32
            out = (out.to(stack.dtype) + wgt.to(stack.dtype) * vals).float()
        return out

    def render(self, T_wc: np.ndarray) -> torch.Tensor:
        """(H, W) uint8 image on the scene's device."""
        return self.render_with_geometry(T_wc)[0]

    @torch.no_grad()
    def render_with_geometry(self, T_wc: np.ndarray):
        """(image u8 (H,W), hit world points (H,W,3), ray depth (H,W);
        pixels that hit no plane have depth inf and hit point 0)."""
        T = torch.as_tensor(np.asarray(T_wc, np.float64), device=self.device)
        C = T[:3, 3]
        d = self._rays_cam @ T[:3, :3].T
        H, W = self.hw
        eps = 1e-9
        t_best = torch.full((H, W), float("inf"), dtype=torch.float64,
                            device=self.device)
        hit = torch.zeros((H, W, 3), dtype=torch.float64, device=self.device)
        img = torch.full((H, W), 230.0, dtype=torch.float32,
                         device=self.device)
        inv_f = 1.0 / float(self.K[0, 0])

        def plane(axis: int, value: float, positive: bool, photo_idx: int):
            nonlocal t_best, hit, img
            denom = d[..., axis]
            t = (value - C[axis]) / torch.where(denom.abs() < eps,
                                                torch.full_like(denom, eps),
                                                denom)
            facing = denom > 0 if positive else denom < 0
            ok = (t > 0.2) & facing & (t < t_best)
            p = C + t[..., None] * d
            # footprint on the surface: depth / f, widened by the grazing
            # smear (the bound the EWA families use)
            d_perp = d.clone()
            d_perp[..., axis] = 0.0
            fp = t * inv_f * (1.0 + torch.clamp(
                torch.linalg.norm(d_perp, dim=-1)
                / torch.clamp(denom.abs(), min=1e-3), max=25.0))
            a0, a1 = [a for a in range(3) if a != axis]
            tex = self._sample_photo(photo_idx, p[..., a0], p[..., a1], fp)
            t_best = torch.where(ok, t, t_best)
            hit = torch.where(ok[..., None], p, hit)
            img = torch.where(ok, tex, img)

        plane(1, self.ground_y, True, 0)                     # ground
        plane(0, self.wall_x, True, 1)                       # right wall
        plane(0, -self.wall_x, False, 2)                     # left wall
        plane(1, -3.0 * self.wall_x, False, 3)               # ceiling
        far_z = float(np.floor(float(T_wc[2][3]) / 10.0) * 10.0 + 200.0)
        plane(2, far_z, True, 4)                             # far wall

        shade = 1.0 / (1.0 + 0.004 * torch.clamp(torch.where(
            torch.isfinite(t_best), t_best, torch.full_like(t_best, 200.0)),
            0, 200))
        out = torch.clamp(img.double() * shade, 0, 255).to(torch.uint8)
        return out, hit, t_best


SCENE_FAMILIES = {"corridor": CorridorScene, "boxes": BoxScene,
                  "photo": PhotoScene}


def render_sequence(family: str, seed: int, hw, K, n_frames: int,
                    speed: float, yaw_rate_deg: float, device=None):
    """(frames (n, H, W) uint8 on the device, T_wc (n, 4, 4)): the
    sequence ``bench.py`` renders (``render_frames_cached``), uncached."""
    T = make_trajectory(n_frames, speed=speed, yaw_rate_deg=yaw_rate_deg)
    scene = SCENE_FAMILIES[family](seed=seed, hw=tuple(hw), K=np.asarray(K),
                                   device=device)
    return torch.stack([scene.render(T[i]) for i in range(n_frames)]), T


def generate_kitti_sequence(out_dir: str, n_frames: int = 60, seed: int = 0,
                            hw: Tuple[int, int] = DEFAULT_HW,
                            speed: float = 0.5,
                            yaw_rate_deg: float = 0.25,
                            n_points: int = 0,
                            scene: str = "corridor",
                            trajectory: str = "straight",
                            closure_frac: float = 0.8,
                            corner_frames: int = 24,
                            calib: str = "fov", device=None) -> str:
    """Render a sequence on ``device`` (None: the GPU) and write it in the
    KITTI layout under ``out_dir``; returns ``out_dir``, the
    ``--base_dir`` of ``--dataset kitti``. ``calib="fov"`` scales the KITTI
    camera to the render size as the dataloader scales it to the frames;
    ``"crop"`` keeps the focal, centres the principal point and writes the
    camera to ``calib.txt``. ``trajectory``: ``straight``, ``loop`` (a
    circle) or ``square`` (both revisit the start viewpoint).
    (``n_points`` is accepted for compatibility and unused.)"""
    scene_kw = {}
    if trajectory in ("loop", "square"):
        if trajectory == "square":
            T_wc = make_square_loop_trajectory(n_frames, speed=speed,
                                               closure_frac=closure_frac,
                                               corner_frames=corner_frames)
        else:
            T_wc = make_loop_trajectory(n_frames, speed=speed,
                                        closure_frac=closure_frac)
        if scene in ("corridor", "photo"):
            scene_kw["wall_x"] = float(
                max(10.0, np.abs(T_wc[:, 0, 3]).max() + 6.0))
        else:
            # a lap sweeps every heading: a denser box field leaves no
            # view facing bare sky
            scene_kw["path"] = T_wc[:, :3, 3]
            scene_kw["n_boxes"] = 160
    else:
        T_wc = make_trajectory(n_frames, speed=speed,
                               yaw_rate_deg=yaw_rate_deg)
    H, W = hw
    Ks = DEFAULT_K.copy()
    if calib == "crop":
        Ks[0, 2] = W / 2.0
        Ks[1, 2] = H / 2.0
    else:
        Ks[0] *= W / DEFAULT_HW[1]
        Ks[1] *= H / DEFAULT_HW[0]
    sc = SCENE_FAMILIES[scene](seed=seed, hw=tuple(hw), K=Ks, device=device,
                               **scene_kw)

    img_dir = os.path.join(out_dir, "kitti", "05", "image_0")
    pose_dir = os.path.join(out_dir, "kitti", "poses")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pose_dir, exist_ok=True)
    if calib == "crop":
        P0 = np.hstack([Ks, np.zeros((3, 1))])
        P1 = P0.copy()
        P1[0, 3] = -386.1448       # KITTI seq-05 stereo baseline term (fx*b)
        with open(os.path.join(out_dir, "kitti", "05", "calib.txt"), "w") as f:
            for name_, P_ in (("P0", P0), ("P1", P1)):
                f.write(name_ + ": " + " ".join(f"{v:.12e}"
                                                for v in P_.ravel()) + "\n")
    for i in range(n_frames):
        write_png(os.path.join(img_dir, f"{i:06d}.png"),
                  sc.render(T_wc[i]).cpu().numpy())
    np.savetxt(os.path.join(pose_dir, "05.txt"),
               T_wc[:, :3, :4].reshape(n_frames, 12))
    return out_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser("synth")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--speed", type=float, default=0.5)
    p.add_argument("--yaw_rate_deg", type=float, default=0.25)
    p.add_argument("--scene", choices=sorted(SCENE_FAMILIES),
                   default="corridor")
    p.add_argument("--trajectory", choices=["straight", "loop", "square"],
                   default="straight",
                   help="'loop' drives a closed circle, 'square' a closed "
                        "rounded square; both revisit the start viewpoint")
    p.add_argument("--closure_frac", type=float, default=0.8,
                   help="loop/square: fraction of frames at which the lap "
                        "closes")
    p.add_argument("--corner_frames", type=int, default=24,
                   help="square: frames per 90-degree corner arc")
    p.add_argument("--calib", choices=["fov", "crop"], default="fov",
                   help="'fov' rescales the camera to the render size; "
                        "'crop' keeps the focal and writes calib.txt")
    p.add_argument("--hw", type=int, nargs=2, default=list(DEFAULT_HW),
                   metavar=("H", "W"),
                   help="render resolution (default: KITTI's 370 1226)")
    p.add_argument("--device", default=None,
                   help="render device (default: the GPU; 'cpu' for the "
                        "CPU)")
    a = p.parse_args(argv)
    base = generate_kitti_sequence(a.out, a.frames, a.seed,
                                   hw=(a.hw[0], a.hw[1]), speed=a.speed,
                                   yaw_rate_deg=a.yaw_rate_deg, scene=a.scene,
                                   trajectory=a.trajectory,
                                   closure_frac=a.closure_frac,
                                   corner_frames=a.corner_frames,
                                   calib=a.calib, device=a.device)
    print(f"synthetic KITTI sequence at {base} "
          f"(use --dataset kitti --base_dir {base})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
