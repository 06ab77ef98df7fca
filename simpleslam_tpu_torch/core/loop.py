"""Loop closure: place recognition -> Sim(3) verification -> pose-graph
correction (the counterpart of ``simpleslam_tpu/core/loop.py``).

  * Place recognition: each keyframe gets a pooled-descriptor place vector
    (a G x G grid of L2-normalised mean descriptors); candidates are the
    top-k cosine similarities among keyframes older than ``loop_gap_kfs``.
    Global relocalisation ranks keyframes by the same vectors.
  * Geometric verification: the two keyframes' matches lifted to 3D-3D
    landmark pairs, each side in its own camera frame, fitted by the batched
    Sim(3) RANSAC (``ops/sim3.sim3_ransac_3d3d``) on the device of the
    keyframes' features.
  * Correction: one Sim(3) pose-graph LM solve over all keyframes
    (``ops/pgo.pgo_solve``, nodes padded to a power of two), then the map is
    rewritten: keyframe poses, every live and archived landmark (anchored at
    its first observing keyframe) and every per-frame pose (anchored at the
    keyframe at or before it).

The reference's gates against perceptual aliasing stay: the inlier floor
that scales with the keypoint budget (``loop_min_inlier_frac``), the
confirmation queue (``loop_confirm``: a closure waits for a later
verification that implies the same drift correction, within
``loop_confirm_window`` keyframes) with its strong-evidence bypass
(``loop_confirm_strong``), the drift-fraction gate
(``loop_drift_frac_max``) and the scale gate (``loop_max_scale``). The
reference's module docstring has the measurements behind each.
"""
from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.ops import pgo, sim3
from simpleslam_tpu_torch.ops.matching import unpack_bits

logger = logging.getLogger("loop")


# --------------------------------------------------------------------------- #
# Host-side Sim(3) algebra on (R, t, s) tuples of numpy float64 (X -> sRX+t):
# the confirmation gate composes a handful of 3x3s per verified candidate.
# --------------------------------------------------------------------------- #

def _s_comp(A, B):
    """A o B: apply B, then A."""
    Ra, ta, sa = A
    Rb, tb, sb = B
    return (Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb)


def _s_inv(A):
    Ra, ta, sa = A
    Rt = Ra.T
    return (Rt, -(Rt @ ta) / sa, 1.0 / sa)


def _s_from_se3(T) -> tuple:
    T = np.asarray(T, np.float64)
    return (T[:3, :3].copy(), T[:3, 3].copy(), 1.0)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host float64 array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _n_valid(feats) -> int:
    return int(feats.valid.sum())


# --------------------------------------------------------------------------- #
# Place recognition
# --------------------------------------------------------------------------- #

def place_vector(feats, img_hw: Tuple[int, int], grid: int) -> np.ndarray:
    """(G*G*D,) pooled place vector: per-cell mean descriptor over a G x G
    grid, cell- and globally L2-normalised. Binary (uint8) descriptors pool
    as their bits (G*G*8D)."""
    G = grid
    H, W = int(img_hw[0]), int(img_hw[1])
    kpts, desc = feats.kpts, feats.desc
    desc = unpack_bits(desc, msb_first=True) if desc.dtype == torch.uint8 \
        else desc.float()
    cx = torch.clamp((kpts[:, 0] / W * G).long(), 0, G - 1)
    cy = torch.clamp((kpts[:, 1] / H * G).long(), 0, G - 1)
    cell = cy * G + cx
    oh = ((cell[:, None] == torch.arange(G * G, device=kpts.device)[None, :])
          & feats.valid[:, None]).float()
    cv = (oh.T @ desc) / torch.clamp(oh.sum(0), min=1.0)[:, None]
    cv = cv / (torch.linalg.norm(cv, dim=1, keepdim=True) + 1e-8)
    v = cv.reshape(-1)
    return (v / (torch.linalg.norm(v) + 1e-8)).cpu().numpy()


@dataclass
class LoopClosure:
    """One accepted loop closure."""
    cur_kf: int                 # newest keyframe (sequence id)
    cand_kf: int                # matched past keyframe
    similarity: float           # place-vector cosine similarity
    n_inliers: int              # Sim3-RANSAC inliers
    scale: float                # measured relative scale s (drift)
    cost_before: float          # PGO robust cost before/after
    cost_after: float
    max_pose_delta: float       # largest keyframe centre move applied (m)


class LoopCloser:
    """Detect-and-close component of the pipeline; one per SLAM run."""

    # agreement tolerances between two verifications' implied drift
    # corrections (transported through odometry)
    _CONFIRM_ROT_DEG = 20.0
    _CONFIRM_SCALE = 1.5
    _CONFIRM_TRANS_FRAC = 0.3          # x median candidate scene depth

    def __init__(self, cfg, K: np.ndarray, matcher, timer=None):
        self.cfg = cfg
        self.K = np.asarray(K, np.float64)
        self.matcher = matcher
        # the SLAMSystem's utils/profiling.StageTimer: seconds and calls of
        # the ``loop_verify``, ``loop_close`` and ``pgo`` stages; each ends
        # by reading its result back, so its time covers its device work
        self.timer = timer
        self._vecs: List[np.ndarray] = []       # aligned with the kfs list
        self._cooldown_until = -1               # no detection up to this KF
        self._scanned_until = 0                 # scan() progress
        self.closures: List[LoopClosure] = []
        # accepted loop edges (i, j, R, t, s, weight); relative constraints
        # survive world rewrites, so every later solve keeps them all
        self._edges: List[tuple] = []
        # verified closures awaiting an odometry-consistent confirmation
        self._pending: List[dict] = []
        self._kp_index_cache = None

    def _stage(self, name: str):
        return self.timer.stage(name) if self.timer is not None \
            else contextlib.nullcontext()

    # ------------------------------------------------------------- detection
    def _ingest(self, kfs, img_hw) -> None:
        while len(self._vecs) < len(kfs):
            kf = kfs[len(self._vecs)]
            self._vecs.append(
                place_vector(kf.feats, img_hw, self.cfg.loop_grid))

    def detect(self, kfs, img_hw, cur: Optional[int] = None
               ) -> List[Tuple[int, float]]:
        """Candidate (kf_idx, similarity) list for keyframe ``cur``
        (default: the newest)."""
        self._ingest(kfs, img_hw)
        if cur is None:
            cur = len(kfs) - 1
        gap = int(self.cfg.loop_gap_kfs)
        if cur < gap + 1 or cur <= self._cooldown_until:
            return []
        vec = self._vecs[cur]
        if not np.any(vec):            # featureless placeholder keyframe
            return []
        sims = np.stack(self._vecs[:cur - gap]) @ vec
        order = np.argsort(-sims)[: int(self.cfg.loop_topk)]
        return [(int(i), float(sims[i])) for i in order
                if sims[i] >= self.cfg.loop_min_sim]

    # ---------------------------------------------------------- verification
    def _kp2pid(self, world_map, kf_idx: int) -> Dict[int, int]:
        """kp index -> landmark id for one keyframe, from the live
        observation lists and the archived (kf, kp) pairs; one pass builds
        the whole index, cached by ``world_map.version``."""
        cache = self._kp_index_cache
        if cache is None or cache[0] != world_map.version:
            idx: Dict[int, Dict[int, int]] = {}
            for pid in world_map.points:
                for (k, kp, _d) in world_map.points[pid].observations:
                    idx.setdefault(int(k), {})[int(kp)] = pid
            for pid, (_pos, obs, _ckf) in world_map.archived.items():
                for (k, kp) in obs:
                    idx.setdefault(int(k), {})[int(kp)] = pid
            cache = (world_map.version, idx)
            self._kp_index_cache = cache
        return cache[1].get(kf_idx, {})

    @staticmethod
    def _position_of(world_map, pid: int) -> np.ndarray:
        if pid in world_map.points:
            return np.asarray(world_map.points[pid].position, np.float64)
        return np.asarray(world_map.archived[pid][0], np.float64)

    def verify(self, kfs, world_map, cur: int, cand: int, key
               ) -> Optional[Tuple[sim3.Sim3, int, float]]:
        """Geometric verification: (S_cur_from_cand, n_inliers, median
        candidate depth) or None. The Sim3 acts on camera-frame points
        (S . X_cand_cam ~ X_cur_cam): the pose-graph edge M_ij with i = cur,
        j = cand."""
        cfg = self.cfg
        kfc, kfq = kfs[cand], kfs[cur]
        n_kp_valid = _n_valid(kfq.feats)
        min_inl = max(int(cfg.loop_min_inliers),
                      int(round(float(cfg.loop_min_inlier_frac)
                                * n_kp_valid)))
        m = frontend.feature_matcher(cfg, kfc.feats, kfq.feats, self.matcher)
        map_c = self._kp2pid(world_map, cand)
        map_q = self._kp2pid(world_map, cur)
        mv = m.valid.cpu().numpy()
        Xw_c, Xw_q = [], []
        for a, b, v in zip(m.idx0.cpu().numpy(), m.idx1.cpu().numpy(), mv):
            if not v:
                continue
            pc = map_c.get(int(a))
            pq = map_q.get(int(b))
            # pc == pq: the map already links the two views of this
            # landmark, a constraint with no information
            if pc is None or pq is None or pc == pq:
                continue
            Xw_c.append(self._position_of(world_map, pc))
            Xw_q.append(self._position_of(world_map, pq))
        n = len(Xw_c)
        if n < max(3, min_inl):
            logger.info("[LOOP] cand %d: only %d 3D-3D pairs "
                        "(%d matches, %d/%d kps mapped)", cand, n,
                        int(mv.sum()), len(map_q), len(map_c))
            return None

        Tc = np.asarray(kfc.pose, np.float64)
        Tq = np.asarray(kfq.pose, np.float64)
        Xc = (Tc[:3, :3] @ np.asarray(Xw_c).T).T + Tc[:3, 3]
        Xq = (Tq[:3, :3] @ np.asarray(Xw_q).T).T + Tq[:3, 3]
        # per-side thresholds in each cloud's own (monocular) scale
        depth = float(np.median(Xc[:, 2]))
        depth_q = float(np.median(Xq[:, 2]))
        thresh_c = float(cfg.loop_ransac_thresh) * max(abs(depth), 1e-3)
        thresh_q = float(cfg.loop_ransac_thresh) * max(abs(depth_q), 1e-3)

        cap = 1 << (max(n, 64) - 1).bit_length()         # pow2 pad
        Xc_p = np.zeros((cap, 3), np.float32)
        Xq_p = np.zeros((cap, 3), np.float32)
        val = np.zeros((cap,), bool)
        Xc_p[:n], Xq_p[:n], val[:n] = Xc, Xq, True
        dev = kfq.feats.kpts.device
        S, _inl, n_inl, ok = sim3.sim3_ransac_3d3d(
            key, torch.as_tensor(Xc_p, device=dev),
            torch.as_tensor(Xq_p, device=dev),
            torch.as_tensor(val, device=dev), thresh_q, thresh_c,
            n_hyp=int(cfg.ransac_hypotheses))
        n_inl, ok, s = torch.stack([n_inl.double(), ok.double(),
                                    S.s.double()]).tolist()
        n_inl = int(n_inl)
        if not ok or n_inl < min_inl:
            logger.info("[LOOP] cand %d rejected (%d/%d inliers, gate %d)",
                        cand, n_inl, n, min_inl)
            return None
        # a real revisit's relative scale is bounded by accumulated drift
        smax = float(cfg.loop_max_scale)
        if not (1.0 / smax <= s <= smax):
            logger.info("[LOOP] cand %d rejected (implausible scale %.4f, "
                        "%d inliers)", cand, s, n_inl)
            return None
        return S, n_inl, depth

    # ------------------------------------------------------------ correction
    def close(self, kfs, world_map, cur: int, cand: int,
              S_meas: sim3.Sim3) -> Tuple[float, float, float]:
        """Pose-graph solve + full map rewrite. Returns (cost_before,
        cost_after, max_kf_center_delta_m)."""
        cfg = self.cfg
        K = len(kfs)
        Kp = 1 << (max(K, 8) - 1).bit_length()       # pow2 node pad
        dev = S_meas.R.device

        Told = np.stack([np.asarray(kf.pose, np.float64) for kf in kfs])
        R0 = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
        t0 = np.zeros((Kp, 3), np.float32)
        s0 = np.ones((Kp,), np.float32)
        R0[:K] = Told[:, :3, :3]
        t0[:K] = Told[:, :3, 3]

        def t(a):
            return torch.as_tensor(a, device=dev)

        nodes = sim3.Sim3(R=t(R0), t=t(t0), s=t(s0))

        # retained loop edges are refreshed from the current estimates:
        # zero-residual stiffeners that keep earlier closures' relative
        # poses (the reference's measurement behind this is in its close())
        def _rel(i: int, j: int) -> tuple:
            Si = sim3.from_se3(torch.as_tensor(Told[i], dtype=torch.float32))
            Sj = sim3.from_se3(torch.as_tensor(Told[j], dtype=torch.float32))
            M = sim3.compose(Si, sim3.inverse(Sj))
            return (M.R.numpy(), M.t.numpy(), float(M.s))

        S_host = [_host(x).astype(np.float32) for x in S_meas]
        loops = [(li, lj) + _rel(li, lj) + (lw,)
                 for (li, lj, _R, _t, _s, lw) in self._edges] \
            + [(cur, cand, S_host[0], S_host[1], float(S_host[2]),
                float(cfg.loop_weight))]
        L = 1 << (max(len(loops), 8) - 1).bit_length()
        Ep = Kp + L
        ei = np.zeros((Ep,), np.int64)
        ej = np.zeros((Ep,), np.int64)
        ev = np.zeros((Ep,), bool)
        ew = np.ones((Ep,), np.float32)
        ei[:K - 1] = np.arange(1, K)
        ej[:K - 1] = np.arange(0, K - 1)
        ev[:K - 1] = True

        live = sim3.Sim3(*(x[:K] for x in nodes))
        _si, _sj, meas_seq = pgo.sequential_edges(live)
        mR = np.tile(np.eye(3, dtype=np.float32), (Ep, 1, 1))
        mt = np.zeros((Ep, 3), np.float32)
        ms = np.ones((Ep,), np.float32)
        mR[:K - 1] = meas_seq.R.cpu().numpy()
        mt[:K - 1] = meas_seq.t.cpu().numpy()
        ms[:K - 1] = meas_seq.s.cpu().numpy()
        for n, (li, lj, lR, lt, ls, lw) in enumerate(loops):
            r = K - 1 + n
            ei[r], ej[r], ev[r], ew[r] = li, lj, True, lw
            mR[r], mt[r], ms[r] = lR, lt, ls
        free = np.zeros((Kp,), bool)
        free[1:K] = True                              # node 0 pins the gauge

        problem = pgo.PGOProblem(
            nodes=nodes, edge_i=t(ei), edge_j=t(ej),
            meas=sim3.Sim3(R=t(mR), t=t(mt), s=t(ms)), e_valid=t(ev),
            e_weight=t(ew), node_free=t(free))
        with self._stage("pgo"):
            nodes_new, c0, c1, _n_good = pgo.pgo_solve(
                problem, max_iters=int(cfg.loop_pgo_iters))
            Rn = nodes_new.R.cpu().numpy().astype(np.float64)[:K]
            tn = nodes_new.t.cpu().numpy().astype(np.float64)[:K]
            sn = nodes_new.s.cpu().numpy().astype(np.float64)[:K]

        # keyframe poses: T_new = [R | t/s] (sim3.to_se3)
        Tnew = np.tile(np.eye(4), (K, 1, 1))
        Tnew[:, :3, :3] = Rn
        Tnew[:, :3, 3] = tn / sn[:, None]
        centers_old = -np.einsum("kji,kj->ki", Told[:, :3, :3],
                                 Told[:, :3, 3])
        centers_new = -np.einsum("kji,kj->ki", Rn, tn) / sn[:, None]
        max_delta = float(np.max(np.linalg.norm(
            centers_new - centers_old, axis=1))) if K else 0.0
        for i, kf in enumerate(kfs):
            kf.pose = Tnew[i].copy()

        # live landmarks, anchored at their first observing keyframe:
        # X_new = S_new_a^-1(S_old_a(X_old)), s_old = 1
        ids = world_map.point_ids()
        if ids:
            pos = world_map.get_point_array()
            anchors = np.empty((len(ids),), np.int64)
            for r, pid in enumerate(ids):
                mp = world_map.points[pid]
                obs = mp.observations
                a = obs[0][0] if obs else mp.keyframe_idx
                anchors[r] = min(max(int(a), 0), K - 1)
            Xc = np.einsum("nij,nj->ni", Told[anchors, :3, :3], pos) \
                + Told[anchors, :3, 3]
            Xn = np.einsum("nji,nj->ni", Rn[anchors],
                           Xc - tn[anchors]) / sn[anchors][:, None]
            rows = np.fromiter(world_map._row.values(), np.int64, len(ids))
            world_map._positions[rows] = Xn
            world_map.version += 1

        # archived landmarks ride the same anchored rewrite
        for pid, (pos, obs, ckf) in world_map.archived.items():
            a = obs[0][0] if obs else ckf
            a = min(max(int(a), 0), K - 1)
            Xc1 = Told[a, :3, :3] @ pos + Told[a, :3, 3]
            Xn1 = Rn[a].T @ (Xc1 - tn[a]) / sn[a]
            world_map.archived[pid] = (Xn1, obs, ckf)

        # the per-frame trajectory, each frame anchored at the latest
        # keyframe at or before it (translation rescaled by its scale)
        kf_pose_rows = np.asarray(world_map.keyframe_indices, np.int64)
        if kf_pose_rows.size:
            n_anchor = min(kf_pose_rows.size, K)
            kf_rows = kf_pose_rows[:n_anchor]
            for p_idx in range(len(world_map.poses)):
                a = int(np.searchsorted(kf_rows, p_idx, side="right")) - 1
                a = min(max(a, 0), n_anchor - 1)
                T_rel = world_map.poses[p_idx] @ np.linalg.inv(
                    Told[a] if a < K else Told[-1])
                T_rel[:3, 3] /= sn[a]
                world_map.poses[p_idx] = T_rel @ Tnew[a]

        self._edges = loops                     # kept for later solves
        return float(c0), float(c1), max_delta

    # ----------------------------------------------------------- confirmation
    def _consistent(self, p: dict, q: dict) -> bool:
        """Do two verified closures imply the same drift correction?
        E_k = M_k o Mhat_k^-1 with Mhat_k = T_cur_k o T_cand_k^-1; E_p
        transported into cur_q's frame through the odometry
        G = T_cur_q o T_cur_p^-1 must match E_q in rotation, scale and
        translation."""
        def _err(r):
            Mhat = _s_comp(_s_from_se3(r["Tq"]), _s_inv(_s_from_se3(r["Tc"])))
            return _s_comp(r["S"], _s_inv(Mhat))

        G = _s_comp(_s_from_se3(q["Tq"]), _s_inv(_s_from_se3(p["Tq"])))
        Ep = _s_comp(G, _s_comp(_err(p), _s_inv(G)))
        C = _s_comp(_s_inv(_err(q)), Ep)
        rot = float(np.degrees(np.arccos(
            np.clip((np.trace(C[0]) - 1.0) / 2.0, -1.0, 1.0))))
        sc = float(max(C[2], 1.0 / max(C[2], 1e-12)))
        tn = float(np.linalg.norm(C[1]))
        t_tol = self._CONFIRM_TRANS_FRAC * max(abs(q["depth"]), 1.0)
        ok = (rot <= self._CONFIRM_ROT_DEG and sc <= self._CONFIRM_SCALE
              and tn <= t_tol)
        logger.info("[LOOP] confirm KF %d<->%d vs pending KF %d<->%d: "
                    "rot %.1f deg, scale x%.2f, trans %.2f/%.2f m -> %s",
                    q["cur"], q["cand"], p["cur"], p["cand"],
                    rot, sc, tn, t_tol, "CONSISTENT" if ok else "reject")
        return ok

    def _implied_drift(self, kfs, rec: dict) -> tuple:
        """(|E_t|, estimated arc length cand -> cur): the correction the
        closure claims and the path that must have produced it."""
        Mhat = _s_comp(_s_from_se3(rec["Tq"]), _s_inv(_s_from_se3(rec["Tc"])))
        E = _s_comp(rec["S"], _s_inv(Mhat))
        c = []
        for k in range(rec["cand"], rec["cur"] + 1):
            T = np.asarray(kfs[k].pose, np.float64)
            c.append(-(T[:3, :3].T @ T[:3, 3]))
        c = np.asarray(c)
        c = c[np.isfinite(c).all(axis=1)]
        if len(c) < 2:
            return float(np.linalg.norm(E[1])), 0.0
        steps = np.linalg.norm(np.diff(c, axis=0), axis=1)
        # dead-reckoned stretches log finite garbage: clip each step to 10x
        # the median so the gate stays meaningful across an outage
        med = float(np.median(steps))
        if med > 0:
            steps = np.minimum(steps, 10.0 * med)
        return float(np.linalg.norm(E[1])), float(steps.sum())

    def _gate_and_apply(self, kfs, world_map, cur: int, cand: int,
                        sim_score: float, ver) -> Optional[LoopClosure]:
        """The gates for one geometric verification; applies the closure
        (PGO + rewrite) once ``loop_confirm`` odometry-consistent
        verifications on distinct keyframes have accumulated."""
        S_meas, n_inl, depth = ver
        S_host = tuple(_host(x) for x in S_meas)
        rec = {"cur": cur, "cand": cand, "n_inl": n_inl, "depth": depth,
               "sim": sim_score, "S_meas": S_meas,
               "S": (S_host[0], S_host[1], float(S_host[2])),
               "Tq": np.asarray(kfs[cur].pose, np.float64).copy(),
               "Tc": np.asarray(kfs[cand].pose, np.float64).copy()}
        drift, arc = self._implied_drift(kfs, rec)
        frac_max = float(self.cfg.loop_drift_frac_max)
        if arc > 1e-6:
            logger.info("[LOOP] drift check KF %d<->%d: correction |E_t| "
                        "%.2f m over %.2f m estimated path (%.0f%%)",
                        cur, cand, drift, arc, 100.0 * drift / arc)
        if frac_max > 0 and arc > 1e-6 and drift > frac_max * arc:
            logger.info("[LOOP] cand %d REJECTED by drift plausibility "
                        "(%.0f%% > %.0f%% max)", cand, 100.0 * drift / arc,
                        100.0 * frac_max)
            return None
        n_kp_valid = max(_n_valid(kfs[cur].feats), 1)
        strong = n_inl / n_kp_valid >= float(self.cfg.loop_confirm_strong)
        if int(self.cfg.loop_confirm) >= 2 and not strong:
            win = int(self.cfg.loop_confirm_window)
            self._pending = [p for p in self._pending
                             if cur - p["cur"] <= win]
            if not any(cur > p["cur"] and self._consistent(p, rec)
                       for p in self._pending):
                self._pending.append(rec)
                if len(self._pending) > 4:
                    self._pending.pop(0)
                logger.info("[LOOP] pending: KF %d <-> KF %d (sim %.3f, %d "
                            "inliers) awaits odometry-consistent "
                            "confirmation", cur, cand, sim_score, n_inl)
                return None
        with self._stage("loop_close"):
            c0, c1, max_delta = self.close(kfs, world_map, cur, cand, S_meas)
        lc = LoopClosure(
            cur_kf=cur, cand_kf=cand, similarity=sim_score,
            n_inliers=n_inl, scale=float(S_host[2]),
            cost_before=c0, cost_after=c1, max_pose_delta=max_delta)
        self.closures.append(lc)
        self._cooldown_until = cur + int(self.cfg.loop_gap_kfs)
        self._pending = []      # the rewrite invalidates stored poses
        logger.info(
            "[LOOP] closed: KF %d <-> KF %d (sim %.3f, %d inliers, "
            "scale %.3f, cost %.2f -> %.2f, max pose delta %.3f m)",
            cur, cand, sim_score, n_inl, lc.scale, c0, c1, max_delta)
        return lc

    # ------------------------------------------------------------ entrypoint
    def on_new_keyframe(self, kfs, world_map, img_hw, key,
                        cur: Optional[int] = None,
                        cands=None) -> Optional[LoopClosure]:
        """Detect -> verify -> gate -> close for keyframe ``cur`` (default:
        the newest). ``cands`` skips detection when the caller ran it.
        Returns the accepted (applied) closure or None."""
        if cur is None:
            cur = len(kfs) - 1
        if cands is None:
            cands = self.detect(kfs, img_hw, cur=cur)
        tried = set()
        for cand, sim_score in cands:
            tried.add(cand)
            with self._stage("loop_verify"):
                ver = self.verify(kfs, world_map, cur, cand, key)
            if ver is None:
                continue
            lc = self._gate_and_apply(kfs, world_map, cur, cand, sim_score,
                                      ver)
            if lc is not None:
                return lc
        # targeted re-verification of pending closures: a genuine revisit
        # has advanced along the old path by as many keyframes
        win = int(self.cfg.loop_confirm_window)
        self._pending = [p for p in self._pending if cur - p["cur"] <= win]
        if self._pending:
            gap = int(self.cfg.loop_gap_kfs)
            for p in list(self._pending):
                if cur <= p["cur"]:
                    continue
                exp = p["cand"] + (cur - p["cur"])
                for cand in (exp, p["cand"]):
                    if cand in tried or cand < 0 or cand >= cur - gap:
                        continue
                    tried.add(cand)
                    with self._stage("loop_verify"):
                        ver = self.verify(kfs, world_map, cur, cand, key)
                    if ver is None:
                        continue
                    sim_score = float(self._vecs[cur] @ self._vecs[cand]) \
                        if cur < len(self._vecs) and cand < len(self._vecs) \
                        else 0.0
                    lc = self._gate_and_apply(kfs, world_map, cur, cand,
                                              sim_score, ver)
                    if lc is not None:
                        return lc
        return None

    def scan(self, kfs, world_map, img_hw, key) -> Optional[LoopClosure]:
        """Fused-mode entry point: detect/verify/close each keyframe that
        arrived since the last scan, in order; returns the first accepted
        closure of the sweep (the rewrite invalidates the others)."""
        start = self._scanned_until
        self._scanned_until = len(kfs)
        n_cand = 0
        for cur in range(start, len(kfs)):
            cands = self.detect(kfs, img_hw, cur=cur)
            n_cand += len(cands)
            lc = self.on_new_keyframe(kfs, world_map, img_hw, key, cur=cur,
                                      cands=cands)
            if lc is not None:
                return lc
        if len(kfs) > start:
            logger.info("[LOOP] scan KFs %d..%d: %d candidates, no closure",
                        start, len(kfs) - 1, n_cand)
        return None
