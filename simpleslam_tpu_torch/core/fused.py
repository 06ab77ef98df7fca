"""The fused per-frame step: the whole SLAM step (extract -> associate ->
PnP -> fallback chain -> keyframe policy -> triangulation -> local BA ->
map compaction) over a fixed-shape state that stays on one device (the
counterpart of ``simpleslam_tpu/core/fused.py``).

The state is a dataclass of fixed-shape tensors with the reference's field
names: a map of capacity C (positions, descriptor rings, a per-point
observation table of O slots, stable ids), a ring of Kw keyframe slots
(slot = kf_no % Kw) and a trajectory / flag log written by row. Three
fields live on the host, because the host knows them without asking the
device: ``frame_no`` and ``log_n`` (each step adds one) and ``key`` (the
key object of ``utils/rng.py``).

Where the reference branches inside its one jitted program
(``jax.lax.cond``), the step branches in Python on a device flag read once
with ``.item()``: whether the first PnP attempt succeeded, the recovery
chain on failure (keyframe relocalisation, global relocalisation), whether
the frame is a keyframe candidate, whether it becomes a keyframe, whether
local BA runs and whether the map needs compaction. ``FusedStep.host_reads``
counts them. A healthy frame reads two flags; a keyframe four or five.
Everything else stays on the device: the association scores fixed chunks
and PnP-RANSAC fixed slots (no row compaction), solves and inverses take
the ``_ex`` variants, local BA runs its LM iterations without reads
(``ops/ba.py::ba_solve``), and numbers from the host reach the device by
fills, not copies. What still waits on the device is PyTorch's SVD and
``eigh``, which check their status on the host: the pose prediction's
re-orthonormalisation, the F/E fits and triangulation.

Behaviour is the reference's fused step: same thresholds, trigger order,
fallbacks, caps and RNG sites (``frame_key(base, frame_no, SITE_*)``), and
the same divergences from the host driver (its module docstring lists
them). ``force_branch`` answers the step's branch reads for cost
accounting (``tools/fused_cost.py``). ``apply_host_correction`` pushes a
loop closure's host-side map rewrite back into the state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.core.loop import place_vector
from simpleslam_tpu_torch.core.map import MAX_OBS_DESC
from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.ops import epipolar, pnp, se3
from simpleslam_tpu_torch.ops.ba import BAProblem, ba_solve
from simpleslam_tpu_torch.ops.maskops import take
from simpleslam_tpu_torch.ops.matching import unpack_bits
from simpleslam_tpu_torch.ops.projection import remap_bilinear
from simpleslam_tpu_torch.ops.triangulation import (projection_matrix,
                                                    triangulate_two_view,
                                                    two_view_gates)
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.rng import (SITE_ESS, SITE_GRELOC,
                                            SITE_KF_MATCH, SITE_KF_MATCH2,
                                            SITE_PNP, SITE_PREV_MATCH,
                                            SITE_RELOC, frame_key)

_LONG = torch.int64


@dataclass
class FusedState:
    """Everything the per-frame step reads and writes (see the module
    docstring; shapes as in the reference's ``FusedState``)."""
    Tcw: torch.Tensor            # (4,4) current pose
    Tcw_prev: torch.Tensor       # (4,4) previous pose
    prev_kpts: torch.Tensor      # (N,2) previous frame's features
    prev_desc: torch.Tensor      # (N,D)
    prev_valid: torch.Tensor     # (N,)
    kf_pose: torch.Tensor        # (Kw,4,4) keyframe ring
    kf_kpts: torch.Tensor        # (Kw,N,2)
    kf_desc: torch.Tensor        # (Kw,N,D)
    kf_valid: torch.Tensor       # (Kw,N)
    kf_frame_no: torch.Tensor    # (Kw,) source frame number, -1 = empty
    kf_first_row: torch.Tensor   # (Kw,) first map row created at the KF
    kf_lm_row: torch.Tensor      # (Kw,N) landmark row of each KF keypoint
    kf_place: torch.Tensor       # (Kw,P) place vectors
    kf_count: torch.Tensor       # () keyframes so far
    last_kf_frame_no: torch.Tensor  # ()
    lost_streak: torch.Tensor    # () consecutive untracked frames
    positions: torch.Tensor      # (C,3) map
    alive: torch.Tensor          # (C,)
    desc_ring: torch.Tensor      # (C,R,D)
    n_desc: torch.Tensor         # (C,)
    obs_kf: torch.Tensor         # (C,O) global KF number, -1 = empty
    obs_kp: torch.Tensor         # (C,O) keypoint index in that KF
    obs_uv: torch.Tensor         # (C,O,2)
    obs_n: torch.Tensor          # (C,)
    pid: torch.Tensor            # (C,) stable landmark id
    n_created: torch.Tensor      # () next id
    last_seen: torch.Tensor      # (C,) frame last observed
    compactions: torch.Tensor    # ()
    n_points: torch.Tensor       # () rows in use
    ba_floor_kf: torch.Tensor    # () first KF wholly after a map rewrite
    frame_no: int                # next frame number (host)
    key: Any                     # base key (host, utils/rng.py)
    log_pose: torch.Tensor       # (Fcap,4,4)
    log_flags: torch.Tensor      # (Fcap,7) tracked, kf, n_inl, n_new,
                                 # n_cand, ba_ran, considered
    log_frame: torch.Tensor      # (Fcap,) -1 = unused row
    log_n: int                   # rows written (host)

    def clone(self) -> "FusedState":
        """A deep copy (tensors cloned on their device)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone()
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


class FusedConfig(NamedTuple):
    """Static configuration of the fused step."""
    img_w: int
    img_h: int
    n_kp: int
    desc_dim: int
    kf_ring: int          # Kw
    obs_slots: int        # O
    map_capacity: int     # C
    max_new: int          # per-KF new-landmark cap
    tri_kf2: bool         # also triangulate vs the second-to-last KF
    reloc: bool           # keyframe 2D-3D relocalisation on PnP failure
    global_reloc: bool    # place-recognition relocalisation over the ring
    greloc_after: int     # consecutive lost frames before it runs
    greloc_min_sim: float  # place-vector cosine gate
    place_grid: int       # G x G descriptor pooling grid
    ba_points: int        # L: local BA's point slice
    log_capacity: int     # Fcap
    ransac_thresh: float
    ransac_hypotheses: int
    pnp_min_inliers: int
    proj_radius: float
    assoc_wide_factor: float   # widened association retry (<= 1: off)
    max_hamm: float
    max_l2: float
    kf_cooldown: int
    kf_min_inliers: float
    kf_min_ratio: float
    kf_max_disp: float
    kf_min_rot_deg: float
    min_depth: float
    max_depth: float
    tri_parallax_min_deg: float
    tri_rep_err: float
    local_ba_window: int
    local_ba_min_new_points: int
    local_ba_max_iters: int
    ba_huber: float
    evict_age: int        # landmarks unseen this many frames are evictable


def make_fused_config(cfg, img_hw: Tuple[int, int], n_kp: int,
                      desc_dim: int, log_capacity: int = 8192
                      ) -> FusedConfig:
    """The static config from a SLAMConfig, as the reference builds it."""
    H, W = int(img_hw[0]), int(img_hw[1])
    return FusedConfig(
        img_w=W, img_h=H, n_kp=int(n_kp), desc_dim=int(desc_dim),
        kf_ring=max(16, int(cfg.local_ba_window) + 6),
        obs_slots=4,
        map_capacity=int(cfg.map_capacity),
        max_new=min(1024, int(n_kp)),
        tri_kf2=bool(cfg.tri_kf2),
        reloc=bool(cfg.reloc),
        global_reloc=bool(cfg.global_reloc),
        greloc_after=int(cfg.global_reloc_after),
        greloc_min_sim=float(cfg.global_reloc_min_sim),
        place_grid=int(cfg.loop_grid),
        ba_points=min(int(cfg.fused_ba_points or 4096),
                      int(cfg.map_capacity)),
        log_capacity=int(log_capacity),
        ransac_thresh=float(cfg.ransac_thresh),
        ransac_hypotheses=int(cfg.ransac_hypotheses),
        pnp_min_inliers=int(cfg.pnp_min_inliers),
        proj_radius=float(cfg.proj_radius),
        assoc_wide_factor=float(cfg.assoc_wide_factor),
        max_hamm=float(cfg.match_max_hamm),
        max_l2=float(cfg.match_max_l2),
        kf_cooldown=int(cfg.kf_cooldown),
        kf_min_inliers=float(cfg.kf_min_inliers),
        kf_min_ratio=float(cfg.kf_min_ratio),
        kf_max_disp=float(cfg.kf_max_disp),
        kf_min_rot_deg=float(cfg.kf_min_rot_deg),
        min_depth=float(cfg.min_depth),
        max_depth=float(cfg.max_depth),
        tri_parallax_min_deg=float(cfg.triangulation_parallax_min_deg),
        tri_rep_err=float(cfg.mvt_rep_err),
        local_ba_window=int(cfg.local_ba_window),
        local_ba_min_new_points=int(cfg.local_ba_min_new_points),
        local_ba_max_iters=int(cfg.local_ba_max_iters),
        ba_huber=float(cfg.ba_huber),
        evict_age=int(cfg.map_evict_age),
    )


# --------------------------------------------------------------------------- #
# Host <-> device state conversion
# --------------------------------------------------------------------------- #

def _log_fields(fc: FusedConfig, device) -> dict:
    F = fc.log_capacity
    return dict(log_pose=torch.zeros((F, 4, 4), device=device),
                log_flags=torch.zeros((F, 7), device=device),
                log_frame=torch.full((F,), -1, dtype=_LONG, device=device),
                log_n=0)


def state_from_host(system, fc: FusedConfig, prev_feats: Features
                    ) -> FusedState:
    """The device state of a bootstrapped host ``SLAMSystem``
    (``initialised`` True). ``prev_feats``: the last processed frame's
    features (the matching anchor)."""
    wm, kfs, dev = system.world_map, system.kfs, system.device
    N, D = fc.n_kp, fc.desc_dim
    C, Kw, O = fc.map_capacity, fc.kf_ring, fc.obs_slots
    kf_np = [kf.feats.numpy() for kf in kfs]
    desc_dtype = kf_np[-1]["desc"].dtype         # uint8 (ORB) or float32
    snap = wm.snapshot(C, D, desc_dtype)

    obs_kf = np.full((C, O), -1, np.int64)
    obs_kp = np.full((C, O), -1, np.int64)
    obs_uv = np.zeros((C, O, 2), np.float32)
    obs_n = np.zeros((C,), np.int64)
    created = np.full((C,), -1, np.int64)
    for row, pid in enumerate(wm.points.keys()):
        obs = wm.points[pid].observations
        for o, (kf_idx, kp_idx, _d) in enumerate(obs[:O]):
            if kf_idx >= len(kfs) or kp_idx >= len(kf_np[kf_idx]["kpts"]):
                continue
            obs_kf[row, o] = kf_idx
            obs_kp[row, o] = kp_idx
            obs_uv[row, o] = kf_np[kf_idx]["kpts"][kp_idx]
        obs_n[row] = min(len(obs), O)
        created[row] = wm.points[pid].keyframe_idx

    kf_pose = np.tile(np.eye(4, dtype=np.float32), (Kw, 1, 1))
    kf_kpts = np.zeros((Kw, N, 2), np.float32)
    kf_desc = np.zeros((Kw, N, D), desc_dtype)
    kf_valid = np.zeros((Kw, N), bool)
    kf_frame_no = np.full((Kw,), -1, np.int64)
    kf_first_row = np.zeros((Kw,), np.int64)
    kf_lm_row = np.full((Kw, N), -1, np.int64)
    kf_place = np.zeros((Kw, _place_dim(fc, desc_dtype == np.uint8)),
                        np.float32)
    for kf in kfs[-Kw:]:
        s, f = kf.idx % Kw, kf_np[kf.idx]
        kf_pose[s] = np.asarray(kf.pose, np.float32)
        kf_kpts[s] = f["kpts"][:N]
        kf_desc[s] = f["desc"][:N]
        kf_valid[s] = f["valid"][:N]
        kf_frame_no[s] = kf.frame_idx
        rows = np.flatnonzero(created == kf.idx)
        kf_first_row[s] = int(rows.min()) if rows.size else len(wm)
        kf_place[s] = place_vector(kf.feats, (fc.img_h, fc.img_w),
                                   fc.place_grid)
    for row, pid in enumerate(wm.points.keys()):
        for (kf_idx, kp_idx, _d) in wm.points[pid].observations[:O]:
            if max(0, len(kfs) - Kw) <= kf_idx < len(kfs) and kp_idx < N:
                kf_lm_row[kf_idx % Kw, kp_idx] = row

    poses = wm.poses
    Tcw = np.asarray(poses[-1], np.float32)
    Tcw_prev = np.asarray(poses[-2] if len(poses) >= 2 else poses[-1],
                          np.float32)
    pf = prev_feats.numpy()

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def scalar(v):
        return torch.tensor(int(v), dtype=_LONG, device=dev)

    alive = t(snap["alive"])
    return FusedState(
        Tcw=t(Tcw), Tcw_prev=t(Tcw_prev),
        prev_kpts=t(pf["kpts"][:N]), prev_desc=t(pf["desc"][:N]),
        prev_valid=t(pf["valid"][:N]),
        kf_pose=t(kf_pose), kf_kpts=t(kf_kpts), kf_desc=t(kf_desc),
        kf_valid=t(kf_valid), kf_frame_no=t(kf_frame_no),
        kf_first_row=t(kf_first_row), kf_lm_row=t(kf_lm_row),
        kf_place=t(kf_place), kf_count=scalar(len(kfs)),
        last_kf_frame_no=scalar(system.last_kf_frame_no),
        lost_streak=scalar(system._lost_streak),
        positions=t(snap["positions"]), alive=alive,
        desc_ring=t(snap["desc"]), n_desc=t(snap["n_desc"], _LONG),
        obs_kf=t(obs_kf), obs_kp=t(obs_kp), obs_uv=t(obs_uv),
        obs_n=t(obs_n), pid=t(snap["pid"], _LONG),
        n_created=scalar(wm._next_pid),
        last_seen=torch.where(alive, scalar(system.frame_ids[-1]),
                              scalar(-1)),
        compactions=scalar(0), n_points=scalar(len(wm)),
        ba_floor_kf=scalar(0),
        frame_no=int(system.frame_ids[-1]) + 1, key=system._base_key,
        **_log_fields(fc, dev))


def _place_dim(fc: FusedConfig, binary: bool) -> int:
    """The place vector's width: binary descriptors pool as their bits."""
    return fc.place_grid ** 2 * fc.desc_dim * (8 if binary else 1)


def abstract_state(fc: FusedConfig, device=None,
                   desc_dtype=torch.float32) -> FusedState:
    """A zeros state with the step's shapes and dtypes (no map, no
    keyframes); ``desc_dtype``: torch.uint8 for binary descriptors."""
    N, D = fc.n_kp, fc.desc_dim
    C, Kw, O, R = fc.map_capacity, fc.kf_ring, fc.obs_slots, MAX_OBS_DESC
    P = _place_dim(fc, desc_dtype == torch.uint8)
    eye = torch.eye(4, device=device)

    def z(*shape, dtype=torch.float32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return FusedState(
        Tcw=eye.clone(), Tcw_prev=eye.clone(),
        prev_kpts=z(N, 2), prev_desc=z(N, D, dtype=desc_dtype),
        prev_valid=z(N, dtype=bool),
        kf_pose=eye.repeat(Kw, 1, 1), kf_kpts=z(Kw, N, 2),
        kf_desc=z(Kw, N, D, dtype=desc_dtype), kf_valid=z(Kw, N, dtype=bool),
        kf_frame_no=z(Kw, dtype=_LONG, fill=-1),
        kf_first_row=z(Kw, dtype=_LONG),
        kf_lm_row=z(Kw, N, dtype=_LONG, fill=-1), kf_place=z(Kw, P),
        kf_count=z(dtype=_LONG), last_kf_frame_no=z(dtype=_LONG),
        lost_streak=z(dtype=_LONG), positions=z(C, 3),
        alive=z(C, dtype=bool), desc_ring=z(C, R, D, dtype=desc_dtype),
        n_desc=z(C, dtype=_LONG), obs_kf=z(C, O, dtype=_LONG, fill=-1),
        obs_kp=z(C, O, dtype=_LONG, fill=-1), obs_uv=z(C, O, 2),
        obs_n=z(C, dtype=_LONG), pid=z(C, dtype=_LONG, fill=-1),
        n_created=z(dtype=_LONG), last_seen=z(C, dtype=_LONG, fill=-1),
        compactions=z(dtype=_LONG), n_points=z(dtype=_LONG),
        ba_floor_kf=z(dtype=_LONG), frame_no=0, key=None,
        **_log_fields(fc, device))


def sync_to_host(system, state: FusedState, fc: FusedConfig,
                 from_row: int = 0) -> dict:
    """One readback of the log, the map and the keyframe ring into the
    host ``SLAMSystem``: poses from log row ``from_row`` on are appended
    (periodic syncs pass the previous sync's ``log_n``), landmarks
    reconcile by stable id (evicted ones move to the map's archive when
    they have observations, for loop closure, and are dropped otherwise),
    new landmarks arrive with their creation observations,
    and keyframes created on the device become host ``Keyframe``s (real
    features while still in the ring, placeholders otherwise, with the
    tracked re-observations of the ring's keyframes). Returns the host
    copies."""
    from simpleslam_tpu_torch.core.keyframe import Keyframe

    names = ("log_pose", "log_flags", "log_frame", "positions", "alive",
             "n_points", "compactions", "pid", "obs_kf", "obs_kp",
             "kf_pose", "kf_frame_no", "kf_kpts", "kf_desc", "kf_valid",
             "kf_lm_row", "kf_count", "last_kf_frame_no")
    host = {k: getattr(state, k).cpu().numpy() for k in names}
    host["desc01"] = state.desc_ring[:, :2].cpu().numpy()
    host["log_n"] = state.log_n
    n_log = int(host["log_n"])
    wm = system.world_map
    for i in range(from_row, n_log):
        f = int(host["log_frame"][i])
        if f < 0:
            continue
        wm.add_pose(np.asarray(host["log_pose"][i], np.float64),
                    is_keyframe=bool(host["log_flags"][i, 1] > 0.5))
        system.frame_ids.append(f)
        if not bool(host["log_flags"][i, 0]):
            system.tracking_lost_count += 1

    n_pts = int(host["n_points"])
    pid, alive = host["pid"][:n_pts], host["alive"][:n_pts]
    dev_pids = {int(p) for p, a in zip(pid, alive) if a}
    for hp in list(wm.points.keys()):
        if hp not in dev_pids:
            if wm.points[hp].observations:
                wm.archive_point(hp)
            else:
                wm.points.pop(hp)
    grey = np.full((3,), 0.7, np.float32)
    for r in range(n_pts):
        if not alive[r]:
            continue
        p = int(pid[r])
        created = int(host["obs_kf"][r, 1])
        if created < 0:
            created = int(host["obs_kf"][r, 0])
        if wm.upsert_point(p, host["positions"][r].astype(np.float64),
                           colour=grey, keyframe_idx=created):
            mp = wm.points[p]
            for o in range(fc.obs_slots):
                kf = int(host["obs_kf"][r, o])
                if kf >= 0:
                    mp.add_observation(kf, int(host["obs_kp"][r, o]),
                                       host["desc01"][r, min(o, 1)])
    system._fused_compactions = int(host["compactions"])
    wm.version += 1

    kfc, Kw = int(host["kf_count"]), fc.kf_ring
    kf_rows = [i for i in range(from_row, n_log)
               if host["log_flags"][i, 1] > 0.5 and host["log_frame"][i] >= 0]
    kfc_start = kfc - len(kf_rows)
    N = host["kf_kpts"].shape[1]
    dev = system.device
    for j, i in enumerate(kf_rows):
        kf_no = kfc_start + j
        if kf_no < len(system.kfs):
            continue
        slot, frame_no = kf_no % Kw, int(host["log_frame"][i])
        in_ring = (kf_no >= kfc - Kw
                   and int(host["kf_frame_no"][slot]) == frame_no)
        if in_ring:
            arrays = (host["kf_kpts"][slot], host["kf_desc"][slot],
                      host["kf_valid"][slot])
            pose = host["kf_pose"][slot]
        else:
            arrays = (np.zeros((N, 2), np.float32),
                      np.zeros_like(host["kf_desc"][0]), np.zeros((N,), bool))
            pose = host["log_pose"][i]
        feats = Features(
            kpts=torch.as_tensor(arrays[0].copy(), device=dev),
            desc=torch.as_tensor(arrays[1].copy(), device=dev),
            scores=torch.zeros((N,), device=dev),
            valid=torch.as_tensor(arrays[2].copy(), device=dev))
        system.kfs.append(Keyframe(idx=kf_no, frame_idx=frame_no, path="",
                                   feats=feats,
                                   pose=np.asarray(pose, np.float64),
                                   thumb=b""))
        if in_ring:
            lm_row = host["kf_lm_row"][slot]
            for kp in np.nonzero(lm_row >= 0)[0]:
                r = int(lm_row[kp])
                if r >= n_pts or not alive[r]:
                    continue
                p = int(pid[r])
                if p not in wm.points:
                    continue
                mp = wm.points[p]
                if any(o[0] == kf_no for o in mp.observations):
                    continue
                mp.add_observation(kf_no, int(kp), arrays[1][kp])

    kf_indices = wm.keyframe_indices
    for kf in system.kfs:
        if kf.idx >= kfc - Kw:
            kf.pose = np.asarray(host["kf_pose"][kf.idx % Kw], np.float64)
            if kf.idx < len(kf_indices):
                pi = kf_indices[kf.idx]
                if 0 <= pi < len(wm.poses):
                    wm.poses[pi][:] = kf.pose
    system.last_kf_frame_no = int(host["last_kf_frame_no"])
    return host


def apply_host_correction(state: FusedState, system, fc: FusedConfig,
                          host: dict) -> FusedState:
    """Push a host-side map rewrite (a loop closure:
    ``core/loop.LoopCloser.close``) into the device state: landmark
    positions by stable pid from the host map, the ring's keyframe poses,
    ``Tcw`` and ``Tcw_prev`` from the corrected trajectory, and
    ``ba_floor_kf`` set to the keyframe count (local BA waits until its
    window has rolled past the keyframes of the old geometry). ``host``:
    the sync's copies (:func:`sync_to_host`). Observations, descriptors
    and ids are unchanged. Returns a new state; ``state`` is not
    modified."""
    wm = system.world_map
    pos = np.array(host["positions"])
    pid, alive = host["pid"], host["alive"]
    for r in range(int(host["n_points"])):
        if not alive[r]:
            continue
        hrow = wm._row.get(int(pid[r]))
        if hrow is not None:
            pos[r] = wm._positions[hrow]
    kf_pose = np.array(host["kf_pose"])
    kfc = int(host["kf_count"])
    for kf in system.kfs:
        if kfc - fc.kf_ring <= kf.idx < kfc:
            slot = kf.idx % fc.kf_ring
            if int(host["kf_frame_no"][slot]) == kf.frame_idx:
                kf_pose[slot] = kf.pose
    poses = wm.poses
    dev = state.positions.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return dataclasses.replace(
        state, positions=t(pos), kf_pose=t(kf_pose), Tcw=t(poses[-1]),
        Tcw_prev=t(poses[-2] if len(poses) >= 2 else poses[-1]),
        ba_floor_kf=state.kf_count.clone())


# --------------------------------------------------------------------------- #
# The fused per-frame step
# --------------------------------------------------------------------------- #

_row = take                   # x[i] for a 0-d index tensor, no read


def _set_row(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> None:
    """``x[i] = v`` in place for a 0-d index tensor (no read)."""
    x.index_copy_(0, i.reshape(1), v.to(x.dtype)[None])


def _scatter_max(n: int, index: torch.Tensor, values: torch.Tensor,
                 fill: int) -> torch.Tensor:
    """``full(n, fill).at[index].max(values)`` on int64 values."""
    return torch.full((n,), fill, dtype=_LONG, device=index.device) \
        .scatter_reduce(0, index, values.to(_LONG), reduce="amax")


def _put(arr: torch.Tensor, dest: torch.Tensor, vals) -> torch.Tensor:
    """``arr`` with rows ``dest`` set to ``vals``; ``dest == len(arr)`` is a
    dump row that is dropped."""
    pad = torch.zeros((1,) + arr.shape[1:], dtype=arr.dtype,
                      device=arr.device)
    out = torch.cat([arr, pad])
    if not isinstance(vals, torch.Tensor):    # a Python number: no copy
        vals = torch.full((), vals, dtype=arr.dtype, device=arr.device)
    out[dest] = vals.to(arr.dtype).expand(dest.shape + arr.shape[1:])
    return out[:-1]


class FusedStep:
    """``step(state, image) -> state``: one frame on the device. The state
    is updated in place where the reference donated it; pass
    ``state.clone()`` to keep the input.

    Counters: ``host_reads`` (branch flags read), ``ba_solves`` (local BAs
    run) and ``ba_shift`` (a device scalar: the largest change local BA
    made to a keyframe pose entry, over all solves).

    ``force_branch`` (cost accounting only, see :func:`build_fused_step`):
    branch reads answered without looking at the device.
    """

    # the answers ``force_branch`` gives the step's branch reads, by name
    # (a read not named here is made): PnP and its wide retry, keyframe
    # relocalisation, whether global relocalisation is due, its gate, then
    # the keyframe policy's consider, promote, local BA and compaction
    FORCED = {"skip": {"consider": False},
              "eval": {"consider": True, "promote": False},
              "kf": {"consider": True, "promote": True, "ba": True},
              "static": {"track": False, "reloc": False, "greloc_due": True,
                         "greloc": False, "consider": True, "promote": True,
                         "ba": True, "compact": True}}

    def __init__(self, fc: FusedConfig, K: np.ndarray,
                 extract_fn: Callable[[torch.Tensor], Features],
                 match_fn: Callable[[Features, Features], Matches],
                 device=None, undistort_maps=None, force_branch=None):
        if force_branch is not None and force_branch not in self.FORCED:
            raise ValueError(f"force_branch {force_branch!r}: one of "
                             f"{sorted(self.FORCED)} or None")
        self.forced = self.FORCED.get(force_branch, {})
        self.fc = fc
        self.undistort_maps = undistort_maps
        self.device = resolve_device(device)
        self.K = torch.as_tensor(np.asarray(K), dtype=torch.float32,
                                 device=self.device)
        self.detect = extract_fn
        self.match = match_fn
        self.host_reads = 0
        self.ba_solves = 0
        self.ba_shift = torch.zeros((), device=self.device)
        self.bgr_weights = torch.tensor([0.114, 0.587, 0.299],
                                        device=self.device)

    # ------------------------------------------------------------- helpers
    def _read(self, flag: torch.Tensor) -> bool:
        """One device flag on the host (the branch reads the step counts)."""
        self.host_reads += 1
        return bool(flag.item())

    def _branch(self, name: str, flag: torch.Tensor) -> bool:
        """The branch read ``name``, unless ``force_branch`` answers it."""
        forced = self.forced.get(name)
        return self._read(flag) if forced is None else forced

    def _scalar(self, v) -> torch.Tensor:
        """A host integer on the device, by a fill (a copy would wait)."""
        return torch.full((), v, dtype=_LONG, device=self.device)

    def _features_of(self, state: FusedState) -> Features:
        return Features(kpts=state.prev_kpts, desc=state.prev_desc,
                        scores=torch.zeros_like(state.prev_kpts[:, 0]),
                        valid=state.prev_valid)

    def _kf_features(self, state: FusedState, slot: torch.Tensor
                     ) -> Features:
        kpts = _row(state.kf_kpts, slot)
        return Features(kpts=kpts, desc=_row(state.kf_desc, slot),
                        scores=torch.zeros_like(kpts[:, 0]),
                        valid=_row(state.kf_valid, slot))

    def _place_vec(self, feats: Features) -> torch.Tensor:
        """(P,) pooled place vector, the device twin of
        ``core/loop.place_vector`` (binary descriptors unpacked MSB-first
        there and here, so cosines against ``kf_place`` are consistent)."""
        fc, G = self.fc, self.fc.place_grid
        desc = feats.desc
        desc = unpack_bits(desc, msb_first=True) \
            if desc.dtype == torch.uint8 else desc.float()
        cx = torch.clamp((feats.kpts[:, 0] / fc.img_w * G).long(), 0, G - 1)
        cy = torch.clamp((feats.kpts[:, 1] / fc.img_h * G).long(), 0, G - 1)
        cell = cy * G + cx
        oh = ((cell[:, None] == torch.arange(G * G, device=self.device))
              & feats.valid[:, None]).float()
        cv = (oh.T @ desc) / torch.clamp(oh.sum(0), min=1.0)[:, None]
        cv = cv / (torch.linalg.norm(cv, dim=1, keepdim=True) + 1e-8)
        v = cv.reshape(-1)
        return v / (torch.linalg.norm(v) + 1e-8)

    def _match_ransac(self, key, f0: Features, f1: Features) -> Matches:
        """Matcher + F-RANSAC filter; fewer than 8 matches pass through."""
        fc = self.fc
        m = self.match(f0, f1)
        p0, p1 = f0.kpts[m.idx0], f1.kpts[m.idx1]
        _F, inl, ok = epipolar.find_fundamental(
            key, p0, p1, m.valid, fc.ransac_thresh, n_hyp=fc.ransac_hypotheses)
        keep = (m.valid.sum() >= 8) & ok
        return Matches(idx0=m.idx0, idx1=m.idx1, score=m.score,
                       valid=torch.where(keep, m.valid & inl, m.valid))

    def _pnp_on_rows(self, key, state, rows, kp_idx, ok_rows, feats, T_init):
        """PnP-RANSAC of the keypoints ``kp_idx`` against map ``rows``."""
        fc = self.fc
        rows_s = torch.clamp(rows, min=0)
        ok = ok_rows & (rows >= 0) & state.alive[rows_s] & \
            (rows_s < state.n_points)
        T, _inl, n, okp = pnp.solve_pnp_ransac(
            key, state.positions[rows_s], feats.kpts[kp_idx], ok, self.K,
            fc.ransac_thresh, Tcw_init=T_init, n_hyp=fc.ransac_hypotheses)
        return T, okp & (n >= fc.pnp_min_inliers)

    # --------------------------------------------------------------- track
    def _attempt(self, state, feats, T_pred, key, radius):
        """One association + PnP pass at ``radius`` pixels."""
        fc, C = self.fc, self.fc.map_capacity
        assoc = pnp.reproject_and_match_2d3d(
            state.positions, state.alive, state.desc_ring, state.n_desc,
            feats.kpts, feats.desc, feats.valid, self.K, T_pred,
            img_w=fc.img_w, img_h=fc.img_h, radius_px=radius,
            max_hamm=fc.max_hamm, max_l2=fc.max_l2)
        n_cand = assoc.valid.sum()
        # candidates compacted into S dense slots before RANSAC
        S = min(2048, C)
        rank = torch.cumsum(assoc.valid.long(), 0) - 1
        dest = torch.where(assoc.valid & (rank < S), rank,
                           torch.full_like(rank, S))
        row_of_slot = torch.full((S + 1,), -1, dtype=_LONG,
                                 device=self.device)
        row_of_slot[dest] = torch.arange(C, device=self.device)
        row_of_slot = row_of_slot[:S]
        slot_valid = row_of_slot >= 0
        row_s = torch.clamp(row_of_slot, min=0)
        T_est, inl_s, n_inl, ok = pnp.solve_pnp_ransac(
            key, state.positions[row_s], feats.kpts[assoc.kp_idx[row_s]],
            slot_valid, self.K, fc.ransac_thresh, Tcw_init=T_pred,
            n_hyp=fc.ransac_hypotheses)
        inl = _scatter_max(C, row_s, inl_s & slot_valid, 0) > 0
        use = ok & (n_inl >= fc.pnp_min_inliers) & \
            (n_cand >= fc.pnp_min_inliers)
        return use, T_est, inl, n_inl, n_cand, assoc

    def _track(self, state: FusedState, feats: Features, frame_no: int):
        """PnP with the recovery chain -> (T_new, pnp_ok, relocd, grelocd,
        n_inl, n_cand, assoc, inl); the three flags are host bools."""
        fc, Kw = self.fc, self.fc.kf_ring
        T_pred = pnp.predict_pose_const_vel(state.Tcw_prev, state.Tcw)
        k_pnp = frame_key(state.key, frame_no, SITE_PNP)
        use, T_est, inl, n_inl, n_cand, assoc = self._attempt(
            state, feats, T_pred, k_pnp, fc.proj_radius)
        ok = self._branch("track", use)
        if not ok and fc.assoc_wide_factor > 1.0:
            use, T_est, inl, n_inl, n_cand, assoc = self._attempt(
                state, feats, T_pred, k_pnp,
                fc.proj_radius * fc.assoc_wide_factor)
            ok = self._branch("track", use)
        if ok:
            return T_est, True, False, False, n_inl, n_cand, assoc, inl

        def essential():
            m = self._match_ransac(
                frame_key(state.key, frame_no, SITE_PREV_MATCH),
                self._features_of(state), feats)
            p0, p1 = state.prev_kpts[m.idx0], feats.kpts[m.idx1]
            E, e_inl, e_ok = epipolar.find_essential(
                frame_key(state.key, frame_no, SITE_ESS), p0, p1, m.valid,
                self.K, fc.ransac_thresh, n_hyp=fc.ransac_hypotheses)
            R, t, _good, _n = epipolar.recover_pose_essential(
                E, p0, p1, e_inl, self.K)
            T_rel_last = state.Tcw @ se3.T_inverse(state.Tcw_prev)
            scale = torch.linalg.norm(T_rel_last[:3, 3])
            T_fb = se3.rt_to_T(R, t * scale) @ state.Tcw
            return torch.where(e_ok, T_fb, state.Tcw), False, False

        def greloc():
            v = self._place_vec(feats)
            sims = state.kf_place @ v
            live = (state.kf_frame_no >= 0) & \
                (torch.arange(Kw, device=self.device)
                 != (state.kf_count - 1) % Kw)
            sims = torch.where(live, sims, torch.full_like(sims, -2.0))
            best = torch.argmax(sims)
            m = self.match(self._kf_features(state, best), feats)
            T_g, ok_g = self._pnp_on_rows(
                frame_key(state.key, frame_no, SITE_GRELOC), state,
                _row(state.kf_lm_row, best)[m.idx0], m.idx1, m.valid, feats,
                _row(state.kf_pose, best))
            if self._branch("greloc",
                            (_row(sims, best) >= fc.greloc_min_sim) & ok_g):
                return T_g, False, True
            return essential()

        def greloc_or_essential():
            if fc.global_reloc and self._branch(
                    "greloc_due", state.lost_streak + 1 >= fc.greloc_after):
                return greloc()
            return essential()

        if fc.reloc:
            slot = (state.kf_count - 1) % Kw
            m = self.match(self._kf_features(state, slot), feats)
            T_r, ok_r = self._pnp_on_rows(
                frame_key(state.key, frame_no, SITE_RELOC), state,
                _row(state.kf_lm_row, slot)[m.idx0], m.idx1, m.valid, feats,
                T_pred)
            if self._branch("reloc", ok_r):
                T_new, relocd, grelocd = T_r, True, False
            else:
                T_new, relocd, grelocd = greloc_or_essential()
        else:
            T_new, relocd, grelocd = greloc_or_essential()
        return T_new, False, relocd, grelocd, n_inl, n_cand, assoc, inl

    def _refresh_rings(self, state, assoc, inl, feats, frame_no) -> None:
        """This frame's PnP-inlier descriptors into the landmark rings;
        stamps ``last_seen``."""
        sel = assoc.valid & inl
        rows = torch.arange(self.fc.map_capacity, device=self.device)
        slots = state.n_desc % state.desc_ring.shape[1]
        cur = state.desc_ring[rows, slots]
        state.desc_ring[rows, slots] = torch.where(
            sel[:, None], feats.desc[assoc.kp_idx].to(cur.dtype), cur)
        state.n_desc += sel.long()
        state.last_seen = torch.where(sel, self._scalar(frame_no),
                                      state.last_seen)

    # ------------------------------------------------------------ keyframe
    def _kf_signals(self, state, feats, matches):
        """(n_inl, ratio, median flow) against the last keyframe."""
        slot = (state.kf_count - 1) % self.fc.kf_ring
        m = matches.valid
        n_inl = m.sum()
        n_ref = torch.clamp(_row(state.kf_valid, slot).sum(), min=1)
        ratio = n_inl.float() / n_ref.float()
        d = feats.kpts[matches.idx1] - _row(state.kf_kpts, slot)[matches.idx0]
        disp = torch.hypot(d[:, 0], d[:, 1])
        s = torch.sort(torch.where(m, disp, torch.full_like(disp,
                                                            float("inf"))))[0]
        kk = torch.clamp(n_inl, min=1)
        mid = torch.stack([torch.clamp((kk - 1) // 2, min=0),
                           torch.clamp(kk // 2, min=0)])
        med = torch.where(n_inl > 0, 0.5 * s.gather(0, mid).sum(),
                          torch.zeros_like(disp[0]))
        return n_inl, ratio, med

    def _tri_candidates(self, state, feats, m, src_slot, src_kf_no):
        """Gated triangulation candidates of one (source KF, current frame)
        match set."""
        fc = self.fc
        T0, T1 = _row(state.kf_pose, src_slot), state.Tcw
        uv0 = _row(state.kf_kpts, src_slot)[m.idx0]
        uv1 = feats.kpts[m.idx1]
        X = triangulate_two_view(projection_matrix(self.K, T0),
                                 projection_matrix(self.K, T1), uv0, uv1)
        keep, _why = two_view_gates(
            X, self.K, T0, T1, uv0, uv1, min_depth=fc.min_depth,
            max_depth=fc.max_depth,
            min_parallax_deg=fc.tri_parallax_min_deg,
            max_reproj_px=fc.tri_rep_err)
        keep = keep & m.valid & torch.isfinite(X).all(1)
        d0 = _row(state.kf_desc, src_slot)[m.idx0]
        return dict(X=X, keep=keep, uv0=uv0, uv1=uv1, d0=d0, idx0=m.idx0,
                    idx1=m.idx1, src=src_kf_no.expand(keep.shape))

    def _triangulate_new(self, state, feats, cands, frame_no):
        """Dedup (one landmark per current keypoint), cap and append the
        candidates to the map; returns n_new (device)."""
        fc, N, C = self.fc, self.fc.n_kp, self.fc.map_capacity
        used = torch.zeros((N,), dtype=_LONG, device=self.device)
        for c in cands:
            c["keep"] = c["keep"] & (used[c["idx1"]] == 0)
            used = used.scatter_reduce(0, c["idx1"], c["keep"].long(),
                                       reduce="amax")
        cat = {k: torch.cat([c[k] for c in cands]) for k in cands[0]}
        keep = cat["keep"]
        rank = torch.cumsum(keep.long(), 0) - 1
        keep = keep & (rank < fc.max_new) & (state.n_points + rank < C)
        dest = torch.where(keep, state.n_points + rank,
                           torch.full_like(rank, C))
        n_new = keep.sum()
        d1 = feats.desc[cat["idx1"]]
        state.positions = _put(state.positions, dest, cat["X"])
        state.alive = _put(state.alive, dest, keep)
        state.last_seen = _put(state.last_seen, dest, frame_no)
        ring = torch.cat([state.desc_ring,
                          torch.zeros_like(state.desc_ring[:1])])
        ring[dest, 0] = cat["d0"].to(ring.dtype)
        ring[dest, 1] = d1.to(ring.dtype)
        state.desc_ring = ring[:C]
        state.n_desc = _put(state.n_desc, dest, 2)
        kf_no_cur = state.kf_count
        for name, v0, v1 in (("obs_kf", cat["src"], kf_no_cur.expand(
                                  keep.shape)),
                             ("obs_kp", cat["idx0"], cat["idx1"]),
                             ("obs_uv", cat["uv0"], cat["uv1"])):
            arr = getattr(state, name)
            out = torch.cat([arr, torch.zeros_like(arr[:1])])
            out[dest, 0] = v0.to(arr.dtype)
            out[dest, 1] = v1.to(arr.dtype)
            setattr(state, name, out[:C])
        state.pid = _put(state.pid, dest, state.n_created + rank)
        state.obs_n = _put(state.obs_n, dest, 2)
        cur_slot = state.kf_count % fc.kf_ring
        lm_row = _row(state.kf_lm_row, cur_slot).scatter_reduce(
            0, cat["idx1"], torch.where(keep, dest, torch.full_like(dest, -1)),
            reduce="amax")
        _set_row(state.kf_lm_row, cur_slot, lm_row)
        state.n_created = state.n_created + n_new
        state.n_points = torch.clamp(state.n_points + n_new, max=C)
        return n_new

    def _local_ba(self, state: FusedState) -> None:
        """Sliding-window BA on the contiguous row slice of points created
        inside the window (point-major edges, no reads)."""
        fc, dev = self.fc, self.device
        L, Kw, O, C = fc.ba_points, fc.kf_ring, fc.obs_slots, fc.map_capacity
        kfc = state.kf_count
        center = kfc - 1
        first_opt = torch.clamp(center - fc.local_ba_window + 1, min=1)
        lo_kf = torch.clamp(first_opt - 1, min=0)
        row_lo = torch.clamp(_row(state.kf_first_row, lo_kf % Kw), 0,
                             max(C - L, 0))
        rows = row_lo + torch.arange(L, device=dev)
        pts = state.positions[rows]
        okf, ouv = state.obs_kf[rows], state.obs_uv[rows]
        aliv = state.alive[rows]
        in_map = rows < state.n_points

        slots = torch.arange(Kw, device=dev)
        kf_no_of_slot = (kfc - 1) - ((kfc - 1 - slots) % Kw)
        slot_live = (kf_no_of_slot >= 0) & (kf_no_of_slot >= kfc - Kw)
        cam_free = slot_live & (kf_no_of_slot >= first_opt) & \
            (kf_no_of_slot <= center)

        e_kf = okf.reshape(-1)
        e_uv = ouv.reshape(-1, 2)
        e_pt = torch.arange(L, device=dev).repeat_interleave(O)
        e_cam = torch.where(e_kf >= 0, e_kf % Kw, torch.zeros_like(e_kf))
        kf_in_ring = (e_kf >= 0) & (e_kf > kfc - 1 - Kw) & (e_kf < kfc)
        e_valid = kf_in_ring & aliv[e_pt] & in_map[e_pt]
        pt_has_opt = _scatter_max(L, e_pt, e_valid & cam_free[e_cam], 0) > 0
        pt_free = pt_has_opt & aliv & in_map
        e_live = e_valid & pt_free[e_pt]
        cam_edges = torch.zeros((Kw,), dtype=_LONG, device=dev) \
            .scatter_add_(0, e_cam, e_live.long())
        cam_free = cam_free & (cam_edges >= 3)

        new_poses, new_points, _c0, _c1, _ng = ba_solve(
            BAProblem(poses=state.kf_pose, points=pts, cam_idx=e_cam,
                      pt_idx=e_pt, uv=e_uv, e_valid=e_live,
                      cam_free=cam_free, pt_free=pt_free),
            self.K, huber=fc.ba_huber, max_iters=fc.local_ba_max_iters,
            point_major_obs=O)
        new_points = torch.where(pt_free[:, None], new_points, pts)
        new_poses = torch.where(cam_free[:, None, None], new_poses,
                                state.kf_pose)
        self.ba_solves += 1
        self.ba_shift = torch.maximum(
            self.ba_shift, (new_poses - state.kf_pose).abs().max())
        state.positions[rows] = new_points
        state.kf_pose = new_poses
        state.Tcw = _row(state.kf_pose, center % Kw).clone()

    def _compact_map(self, state: FusedState, frame_no: int) -> None:
        """Stable compaction: drop dead rows and landmarks unseen for more
        than ``evict_age`` frames, survivors shifted down in creation order
        (the local-BA slice stays contiguous)."""
        C = self.fc.map_capacity
        in_map = torch.arange(C, device=self.device) < state.n_points
        keep = state.alive & in_map & \
            ((frame_no - state.last_seen) <= self.fc.evict_age)
        pref = torch.cumsum(keep.long(), 0)
        remap = torch.where(keep, pref - 1, torch.full_like(pref, -1))
        old_of_new = torch.argsort(torch.where(keep, 0, 1), stable=True)
        for name in ("positions", "desc_ring", "n_desc", "obs_kf", "obs_kp",
                     "obs_uv", "pid", "obs_n", "last_seen"):
            setattr(state, name, getattr(state, name)[old_of_new])
        state.alive = keep[old_of_new]
        lm = state.kf_lm_row
        state.kf_lm_row = torch.where(lm >= 0, remap[torch.clamp(lm, min=0)],
                                      torch.full_like(lm, -1))
        first = state.kf_first_row
        state.kf_first_row = torch.where(
            first > 0, pref[torch.clamp(first - 1, min=0)],
            torch.zeros_like(first))
        state.compactions = state.compactions + 1
        state.n_points = pref[C - 1].clone()

    def _maybe_keyframe(self, state, feats, frame_no, assoc, inl):
        """Keyframe policy, then on a keyframe: ring insert, triangulation,
        local BA, compaction. -> (is_kf, n_new, ba_ran, considered)."""
        fc, Kw, N, C = self.fc, self.fc.kf_ring, self.fc.n_kp, \
            self.fc.map_capacity
        prev_slot = (state.kf_count - 1) % Kw
        age = frame_no - state.last_kf_frame_no
        rot = se3.rotation_angle_deg(
            state.Tcw[:3, :3] @ _row(state.kf_pose, prev_slot)[:3, :3].T)
        zero = torch.zeros((), dtype=_LONG, device=self.device)
        if not self._branch("consider", (age > fc.kf_cooldown)
                            | (rot >= fc.kf_min_rot_deg)):
            return False, zero, False, False
        kf_m = self._match_ransac(
            frame_key(state.key, frame_no, SITE_KF_MATCH),
            self._kf_features(state, prev_slot), feats)
        n_inl, ratio, med = self._kf_signals(state, feats, kf_m)
        weak = (n_inl < fc.kf_min_inliers) | (ratio < fc.kf_min_ratio)
        if not self._branch("promote", (age > fc.kf_cooldown) | weak |
                            (med > fc.kf_max_disp)
                            | (rot > fc.kf_min_rot_deg)):
            return False, zero, False, True

        slot = state.kf_count % Kw
        lm_init = _scatter_max(N, assoc.kp_idx, torch.where(
            assoc.valid & inl, torch.arange(C, device=self.device),
            torch.full_like(assoc.kp_idx, -1)), -1)
        for name, v in (("kf_pose", state.Tcw), ("kf_kpts", feats.kpts),
                        ("kf_desc", feats.desc), ("kf_valid", feats.valid),
                        ("kf_frame_no", self._scalar(frame_no)),
                        ("kf_first_row", state.n_points),
                        ("kf_lm_row", lm_init),
                        ("kf_place", self._place_vec(feats))):
            _set_row(getattr(state, name), slot, v)
        kf_no_prev = state.kf_count - 1
        cands = [self._tri_candidates(state, feats, kf_m, prev_slot,
                                      kf_no_prev)]
        if fc.tri_kf2:
            prev2_slot = (state.kf_count - 2) % Kw
            kf_m2 = self._match_ransac(
                frame_key(state.key, frame_no, SITE_KF_MATCH2),
                self._kf_features(state, prev2_slot), feats)
            c2 = self._tri_candidates(state, feats, kf_m2, prev2_slot,
                                      kf_no_prev - 1)
            c2["keep"] = c2["keep"] & (state.kf_count >= 2)
            cands.append(c2)
        n_new = self._triangulate_new(state, feats, cands, frame_no)
        state.kf_count = state.kf_count + 1
        state.last_kf_frame_no = self._scalar(frame_no)
        past_rewrite = torch.clamp(state.kf_count - 1 - fc.local_ba_window,
                                   min=0) >= state.ba_floor_kf
        ba_ran = self._branch("ba", (n_new >= fc.local_ba_min_new_points)
                              & (state.kf_count >= 2) & past_rewrite)
        if ba_ran:
            self._local_ba(state)
        if self._branch("compact", state.n_points + fc.max_new > C):
            self._compact_map(state, frame_no)
        return True, n_new, ba_ran, True

    # ------------------------------------------------------------ the step
    @torch.no_grad()
    def __call__(self, state: FusedState, image: torch.Tensor) -> FusedState:
        """Process one frame: ``image`` (H, W) grey or (H, W, 3) BGR, uint8
        or float, on the step's device; with undistortion maps the grey
        frame is remapped (in float32, not rounded)."""
        img = image.to(self.device)
        if img.dim() == 3:
            img = img.float() @ self.bgr_weights
        else:
            img = img.float()
        if self.undistort_maps is not None:
            img = remap_bilinear(img, *self.undistort_maps)
        frame_no = state.frame_no
        feats = self.detect(img)
        T_new, pnp_ok, relocd, grelocd, n_inl, n_cand, assoc, inl = \
            self._track(state, feats, frame_no)
        tracked = pnp_ok or relocd or grelocd
        state.Tcw_prev = T_new if grelocd else state.Tcw
        state.Tcw = T_new
        state.lost_streak = torch.zeros_like(state.lost_streak) if tracked \
            else state.lost_streak + 1
        if pnp_ok:
            self._refresh_rings(state, assoc, inl, feats, frame_no)
        is_kf, n_new, ba_ran, considered = self._maybe_keyframe(
            state, feats, frame_no, assoc, inl)

        i = state.log_n % self.fc.log_capacity
        state.log_pose[i] = state.Tcw
        def host(flag):
            return torch.full((), float(flag), device=self.device)

        state.log_flags[i] = torch.stack([
            host(tracked), host(is_kf), n_inl.float(), n_new.float(),
            n_cand.float(), host(ba_ran), host(considered)])
        state.log_frame[i].fill_(frame_no)
        state.log_n += 1
        state.prev_kpts = feats.kpts
        state.prev_desc = feats.desc.to(state.prev_desc.dtype)
        state.prev_valid = feats.valid
        state.frame_no = frame_no + 1
        return state


def build_fused_step(fc: FusedConfig, K: np.ndarray,
                     extract_fn: Callable[[torch.Tensor], Features],
                     match_fn: Callable[[Features, Features], Matches],
                     device=None, undistort_maps=None,
                     force_branch=None) -> FusedStep:
    """The per-frame step (see :class:`FusedStep`). ``extract_fn``: (H, W)
    float grey -> Features (ALIKED); ``match_fn``: (Features, Features) ->
    Matches (LightGlue); ``device``: None is the GPU (raises without one),
    "cpu" the CPU; ``undistort_maps``: (mapx, mapy) on the device
    (``SLAMSystem._undistort_maps``) or None.

    ``force_branch``: COST ACCOUNTING ONLY (``tools/fused_cost.py``); never
    track with it. Where the reference forces its ``lax.cond`` arms, the
    port answers its host reads itself (``FusedStep.FORCED``):
      'skip'   -- not a candidate (no keyframe match, no burst);
      'eval'   -- a candidate evaluated (the keyframe match) and refused;
      'kf'     -- a keyframe: insert, triangulate, and local BA (XLA counts
                  both arms of the reference's BA cond inside the burst);
      'static' -- every arm in one step: PnP and its wide retry fail,
                  keyframe relocalisation fails, global relocalisation is
                  tried and refused, the essential-matrix fallback runs,
                  then the 'kf' burst with map compaction. Each arm the
                  config builds runs once, so this is the most one frame
                  can cost, the port's counterpart of XLA's both-arms
                  count of the unforced program.
    'skip', 'eval' and 'kf' leave the tracking reads real: on a frame
    that PnP tracks they count no recovery arm. The step writes its state
    in place: give a forced step a clone."""
    return FusedStep(fc, K, extract_fn, match_fn, device, undistort_maps,
                     force_branch)
