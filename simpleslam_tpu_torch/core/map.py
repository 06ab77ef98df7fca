"""World map: 3-D landmarks + camera trajectory, array-backed on the host
(the port's own copy of ``simpleslam_tpu/core/map.py``, which is numpy-only).

The single source of truth is a set of growable flat numpy arrays
(positions / colours / alive mask / per-landmark descriptor ring), so the
tracking step can snapshot the map as padded tensors in O(1) copies; the
dict-of-``MapPoint`` API is a view on top (``Map.points[pid].position``).
See the reference module for the behavioural contracts kept. Landmarks
evicted from the fused loop's device map move to ``archived`` (positions
and (keyframe, keypoint) pairs, no descriptors), where loop closure finds
them; ``upsert_point`` serves the fused loop's sync.
``fuse_closeby_duplicate_landmarks`` merges landmarks closer than a radius
(``ops/triangulation.py::MultiViewTriangulator`` calls it), over a
spatial hash of the positions (:func:`_pairs_within_radius`)."""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAX_OBS_DESC = 6  # the 2D-3D matcher compares vs the last <=6 observation
                  # descriptors (reference: pnp_utils.py:115-127)


def canon_desc(desc) -> np.ndarray:
    """Canonicalize a descriptor: binary uint8 kept raw; float L2-normalized.

    Same contract as reference landmark_utils._canon_desc (:26-41), minus the
    torch special-case (our pipeline hands numpy/jax arrays to the host map).
    """
    d = np.asarray(desc)
    if d.dtype == np.uint8:
        return d.reshape(-1)
    d = d.astype(np.float32, copy=False).reshape(-1)
    return d / (np.linalg.norm(d) + 1e-8)


class MapPoint:
    """View of one landmark inside :class:`Map` (array-backed).

    Exposes the reference ``MapPoint`` surface (landmark_utils.py:46-74):
    ``id, position, keyframe_idx, colour, observations, add_observation``.
    ``position``/``colour`` read & write the map's arrays directly.
    """

    __slots__ = ("_map", "id")

    def __init__(self, m: "Map", pid: int):
        self._map = m
        self.id = pid

    # -- array-backed attributes -------------------------------------------
    @property
    def position(self) -> np.ndarray:
        return self._map._positions[self._map._row[self.id]]

    @position.setter
    def position(self, v) -> None:
        self._map._positions[self._map._row[self.id]] = np.asarray(v, np.float64)
        self._map.version += 1   # invalidate device snapshot caches

    @property
    def colour(self) -> np.ndarray:
        return self._map._colours[self._map._row[self.id]]

    @colour.setter
    def colour(self, v) -> None:
        self._map._colours[self._map._row[self.id]] = np.asarray(v, np.float32)

    @property
    def keyframe_idx(self) -> int:
        return int(self._map._created_kf[self._map._row[self.id]])

    @property
    def observations(self) -> List[Tuple[int, int, np.ndarray]]:
        return self._map._obs[self.id]

    def add_observation(self, keyframe_idx: int, kp_idx: int, descriptor) -> None:
        self._map._add_observation(self.id, keyframe_idx, kp_idx, descriptor)

    def __repr__(self) -> str:  # pragma: no cover
        return f"MapPoint(id={self.id}, pos={self.position})"


class _PointsView:
    """Ordered dict-like view: pid -> MapPoint (insertion order, like the
    reference's dict)."""

    def __init__(self, m: "Map"):
        self._map = m

    def __getitem__(self, pid: int) -> MapPoint:
        if pid not in self._map._row:
            raise KeyError(pid)
        return MapPoint(self._map, pid)

    def __contains__(self, pid) -> bool:
        return pid in self._map._row

    def __len__(self) -> int:
        return len(self._map._row)

    def __iter__(self) -> Iterator[int]:
        return iter(self._map._row)

    def keys(self):
        return self._map._row.keys()

    def values(self):
        return (MapPoint(self._map, pid) for pid in self._map._row)

    def items(self):
        return ((pid, MapPoint(self._map, pid)) for pid in self._map._row)

    def pop(self, pid, default=None):
        if pid in self._map._row:
            self._map._remove_point(pid)
            return default
        return default


class Map:
    """3-D landmarks + full camera trajectory (array-backed).

    Reference surface (landmark_utils.py:80-160) plus padded snapshot exports.
    """

    def __init__(self, desc_dim: int = 0, desc_dtype=np.float32):
        cap = 1024
        self._positions = np.zeros((cap, 3), np.float64)
        self._colours = np.ones((cap, 3), np.float32)
        self._created_kf = np.full((cap,), -1, np.int32)
        self._obs_desc: Optional[np.ndarray] = (
            np.zeros((cap, MAX_OBS_DESC, desc_dim), desc_dtype) if desc_dim else None)
        self._obs_count = np.zeros((cap,), np.int32)
        self._row: Dict[int, int] = {}          # pid -> row (insertion ordered)
        self._obs: Dict[int, List[Tuple[int, int, np.ndarray]]] = {}
        self._n_rows = 0
        self._next_pid = 0

        self.poses: List[np.ndarray] = []        # T_cw per *frame*
        self.keyframe_indices: List[int] = []
        self.points = _PointsView(self)
        # landmarks evicted from the live (device-bounded) store, kept for
        # loop closure: pid -> (position, [(kf_idx, kp_idx)], created_kf).
        # Loop closure rewrites these positions too. Not counted by len()
        # or point_ids(); bounded by archive_cap (see archive_point).
        self.archived: Dict[int, Tuple[np.ndarray, list, int]] = {}
        self.archive_cap = 200_000
        # bumped on every landmark mutation; lets device-side snapshot
        # caches (run_slam) invalidate precisely
        self.version = 0

    # ------------------------------------------------------------- internal
    def _grow(self, need: int) -> None:
        cap = self._positions.shape[0]
        if self._n_rows + need <= cap:
            return
        new_cap = max(cap * 2, self._n_rows + need)
        def grow(a, fill=0):
            out = np.full((new_cap,) + a.shape[1:], fill, a.dtype)
            out[:cap] = a
            return out
        self._positions = grow(self._positions)
        self._colours = grow(self._colours, 1)
        self._created_kf = grow(self._created_kf, -1)
        self._obs_count = grow(self._obs_count)
        if self._obs_desc is not None:
            self._obs_desc = grow(self._obs_desc)

    def _ensure_desc_store(self, desc: np.ndarray) -> None:
        if self._obs_desc is None:
            cap = self._positions.shape[0]
            self._obs_desc = np.zeros((cap, MAX_OBS_DESC, desc.shape[0]), desc.dtype)

    def _add_observation(self, pid: int, kf_idx: int, kp_idx: int, descriptor) -> None:
        self.version += 1
        d = canon_desc(descriptor)
        self._obs[pid].append((kf_idx, kp_idx, d))
        self._ensure_desc_store(d)
        # The fast-path ring buffer assumes one descriptor family per map
        # (the real pipeline's case); heterogeneous descriptors still land in
        # the authoritative observations list above.
        if self._obs_desc.shape[-1] == d.shape[0] and self._obs_desc.dtype == d.dtype:
            row = self._row[pid]
            c = self._obs_count[row]
            self._obs_desc[row, c % MAX_OBS_DESC] = d  # ring of last 6
            self._obs_count[row] = c + 1

    def refresh_ring(self, pid: int, descriptor) -> None:
        """Update ONLY the fast-path descriptor ring (not the observation
        list): used by the tracker to keep landmark appearance current with
        the latest matched frame descriptor. Deliberately does NOT bump
        ``version`` — ring refreshes are mirrored incrementally into device
        snapshots by the caller (run_slam), and they must not trigger a full
        snapshot rebuild every frame."""
        d = canon_desc(descriptor)
        self._ensure_desc_store(d)
        if self._obs_desc.shape[-1] == d.shape[0] and self._obs_desc.dtype == d.dtype:
            row = self._row.get(pid)
            if row is None:
                return
            c = self._obs_count[row]
            self._obs_desc[row, c % MAX_OBS_DESC] = d
            self._obs_count[row] = c + 1

    def _remove_point(self, pid: int) -> None:
        # swap-free tombstone removal: compact lazily on snapshot
        self.version += 1
        del self._row[pid]
        self._obs.pop(pid, None)

    def archive_point(self, pid: int) -> None:
        """Move a live landmark into ``archived``. Descriptors are dropped
        (loop closure reads only the (kf_idx, kp_idx) pairs and the
        position). Past ``archive_cap`` landmarks the oldest 10% by
        ``created_kf`` are pruned."""
        row = self._row.get(pid)
        if row is None:
            return
        obs_pairs = [(int(k), int(kp))
                     for (k, kp, _d) in self._obs.get(pid, ())]
        self.archived[pid] = (self._positions[row].copy(), obs_pairs,
                              int(self._created_kf[row]))
        self._remove_point(pid)
        if len(self.archived) > self.archive_cap:
            drop = max(1, self.archive_cap // 10)
            oldest = sorted(self.archived.items(),
                            key=lambda kv: kv[1][2])[:drop]
            for k, _v in oldest:
                del self.archived[k]
            self.version += 1

    def upsert_point(self, pid: int, position, colour=None,
                     keyframe_idx: int = -1) -> bool:
        """Insert-or-update a landmark under an externally assigned id (the
        fused loop assigns ids; its sync reconciles by id). An existing
        point gets its position; a new one is appended. Returns True when
        the point was inserted."""
        self.version += 1
        if pid in self._row:
            self._positions[self._row[pid]] = np.asarray(position, np.float64)
            return False
        self._grow(1)
        row = self._n_rows
        self._positions[row] = np.asarray(position, np.float64)
        if colour is not None:
            self._colours[row] = np.asarray(colour, np.float32)
        self._created_kf[row] = keyframe_idx
        self._row[pid] = row
        self._obs[pid] = []
        self._n_rows += 1
        self._next_pid = max(self._next_pid, pid + 1)
        return True

    # ---------------- Camera trajectory (parity) ---------------------------
    def add_pose(self, pose_c_w: np.ndarray, is_keyframe: bool) -> None:
        pose = np.asarray(pose_c_w, np.float64)
        if pose.shape != (4, 4):
            raise AssertionError("Pose must be 4x4 homogeneous matrix")
        self.poses.append(pose.copy())
        if is_keyframe:
            self.keyframe_indices.append(len(self.poses) - 1)

    # ---------------- Landmarks (parity) ------------------------------------
    def add_points(self, pts3d: np.ndarray, colours: Optional[np.ndarray] = None,
                   keyframe_idx: int = -1) -> List[int]:
        pts3d = np.asarray(pts3d)
        if pts3d.ndim != 2 or pts3d.shape[1] != 3:
            raise ValueError("pts3d must be (N,3)")
        n = pts3d.shape[0]
        if colours is None:
            colours = np.ones_like(pts3d, dtype=np.float32)
        self._grow(n)
        rows = np.arange(self._n_rows, self._n_rows + n)
        self._positions[rows] = pts3d.astype(np.float64)
        self._colours[rows] = np.asarray(colours, np.float32)
        self._created_kf[rows] = keyframe_idx
        self.version += 1
        new_ids = list(range(self._next_pid, self._next_pid + n))
        for pid, row in zip(new_ids, rows):
            self._row[pid] = int(row)
            self._obs[pid] = []
        self._n_rows += n
        self._next_pid += n
        return new_ids

    # ---------------- Accessors (parity) ------------------------------------
    def get_point_array(self) -> np.ndarray:
        if not self._row:
            return np.empty((0, 3))
        rows = np.fromiter(self._row.values(), np.int64, len(self._row))
        return self._positions[rows].copy()

    def get_color_array(self) -> np.ndarray:
        if not self._row:
            return np.empty((0, 3), np.float32)
        rows = np.fromiter(self._row.values(), np.int64, len(self._row))
        return self._colours[rows].copy()

    def point_ids(self) -> List[int]:
        return list(self._row.keys())

    def __len__(self) -> int:
        return len(self._row)

    # ---------------- Landmark fusion (parity semantics) --------------------
    def fuse_closeby_duplicate_landmarks(self, radius: float = 0.05) -> None:
        """Average-merge landmark pairs closer than ``radius``, greedily:
        pairs sorted by (i, j) position in insertion order, the first point
        takes the mean position, the second is removed, and pairs with a
        removed point are skipped. Candidate pairs come from a spatial hash
        grid (:func:`_pairs_within_radius`)."""
        if len(self._row) < 2:
            return
        ids = list(self._row.keys())
        rows = np.fromiter(self._row.values(), np.int64, len(ids))
        pts = self._positions[rows]

        pairs = _pairs_within_radius(pts, radius)

        removed: set = set()
        for i, j in pairs:
            ida, idb = ids[i], ids[j]
            if ida in removed or idb in removed:
                continue
            ra, rb = self._row[ida], self._row[idb]
            self._positions[ra] = 0.5 * (self._positions[ra]
                                         + self._positions[rb])
            removed.add(idb)
        for pid in removed:
            self._remove_point(pid)

    # ---------------- padded snapshot export -----------------------------------
    def snapshot(self, capacity: int, desc_dim: int,
                 desc_dtype=np.float32) -> Dict[str, np.ndarray]:
        """Padded, static-shape device view of the live map.

        Returns host arrays sized ``capacity`` ready to ship to the device:
          positions (C,3) f32, colours (C,3) f32, alive (C,) bool,
          desc (C, MAX_OBS_DESC, D), n_desc (C,) i32, pid (C,) i32.
        Rows follow insertion order; ``alive`` marks the first ``len(self)``.
        """
        n = len(self._row)
        if n > capacity:
            raise ValueError(f"map has {n} points > capacity {capacity}; "
                             f"raise --map_capacity")
        rows = (np.fromiter(self._row.values(), np.int64, n)
                if n else np.empty(0, np.int64))
        out = {
            "positions": np.zeros((capacity, 3), np.float32),
            "colours": np.zeros((capacity, 3), np.float32),
            "alive": np.zeros((capacity,), bool),
            "desc": np.zeros((capacity, MAX_OBS_DESC, desc_dim), desc_dtype),
            "n_desc": np.zeros((capacity,), np.int32),
            "pid": np.full((capacity,), -1, np.int32),
        }
        if n:
            out["positions"][:n] = self._positions[rows]
            out["colours"][:n] = self._colours[rows]
            out["alive"][:n] = True
            out["pid"][:n] = np.fromiter(self._row.keys(), np.int64, n)
            if self._obs_desc is not None and self._obs_desc.shape[-1] == desc_dim:
                out["desc"][:n] = self._obs_desc[rows].astype(desc_dtype)
                out["n_desc"][:n] = np.minimum(self._obs_count[rows], MAX_OBS_DESC)
        return out


def k_of(c) -> int:
    """The hash key of integer cell coordinates (3 x 21 bits, two's
    complement per coordinate)."""
    return int(((c[0] & 0x1FFFFF) << 42) | ((c[1] & 0x1FFFFF) << 21)
               | (c[2] & 0x1FFFFF))


def _pairs_within_radius(pts: np.ndarray, radius: float
                         ) -> List[Tuple[int, int]]:
    """All index pairs (i < j) with ||pts[i] - pts[j]|| < radius, sorted.

    Spatial hash: points bucketed into cells of side ``radius``; candidates
    are pairs in the same or adjacent cells, each cell pair visited once
    through the half-neighbourhood (13 offsets and the cell itself)."""
    cells = np.floor(pts / radius).astype(np.int64)
    key = ((cells[:, 0] & 0x1FFFFF) << 42) | ((cells[:, 1] & 0x1FFFFF) << 21) \
        | (cells[:, 2] & 0x1FFFFF)
    order = np.argsort(key, kind="stable")
    pairs: List[Tuple[int, int]] = []

    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1) if (dx, dy, dz) >= (0, 0, 0)]

    buckets: Dict[int, List[int]] = {}
    for idx in order:
        buckets.setdefault(int(key[idx]), []).append(int(idx))

    r2 = radius * radius
    for idxs in buckets.values():
        base = np.asarray(idxs)
        for off in offsets:
            if off == (0, 0, 0):
                if len(base) < 2:
                    continue
                d = pts[base][:, None, :] - pts[base][None, :, :]
                dist2 = np.einsum("ijk,ijk->ij", d, d)
                ii, jj = np.nonzero(np.triu(dist2 < r2, k=1))
                pairs.extend(zip(base[ii].tolist(), base[jj].tolist()))
            else:
                c0 = cells[idxs[0]]
                other = buckets.get(k_of((int(c0[0]) + off[0],
                                          int(c0[1]) + off[1],
                                          int(c0[2]) + off[2])))
                if not other:
                    continue
                b = np.asarray(other)
                d = pts[base][:, None, :] - pts[b][None, :, :]
                dist2 = np.einsum("ijk,ijk->ij", d, d)
                ii, jj = np.nonzero(dist2 < r2)
                pairs.extend(
                    (min(int(x), int(y)), max(int(x), int(y)))
                    for x, y in zip(base[ii].tolist(), b[jj].tolist()))
    return sorted(set(pairs))
