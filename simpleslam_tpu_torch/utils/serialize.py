"""Saved pipeline state (the counterpart of
``simpleslam_tpu/utils/serialize.py``): the map (landmarks, colours,
observations), the trajectory, the keyframes (poses, padded features,
thumbnails) and the config as one compressed npz.

The file has the reference's keys, dtypes and layout, so a state written
by either package loads in the other: ``positions``, ``colours``, ``pids``,
``created_kf``, ``poses``, ``keyframe_indices``, ``obs`` ((pid, keyframe,
keypoint) rows), ``obs_desc`` (the observations' descriptors as float32
rows, zero padded to the widest), ``frame_ids``, ``n_kfs``, per keyframe
``kf{i}_meta`` (JSON: idx, frame_idx, path), ``_pose``, ``_kpts``,
``_desc``, ``_scores``, ``_valid``, ``_thumb`` (the LZ4 container's bytes)
and ``config_json``. Model weights are not part of it
(``models/checkpoint.py`` reads and writes those).
"""
from __future__ import annotations

import json
from dataclasses import asdict
from typing import List, Optional, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.core.keyframe import Keyframe
from simpleslam_tpu_torch.core.map import Map
from simpleslam_tpu_torch.core.types import Features


def save_state(path: str, world_map: Map, kfs: List[Keyframe],
               cfg=None, frame_ids: Optional[List[int]] = None) -> None:
    """Write the state to ``path`` (``np.savez_compressed``)."""
    pids = world_map.point_ids()
    obs_flat = []      # (pid, kf_idx, kp_idx) rows
    obs_desc = []
    for pid in pids:
        for f, kp, d in world_map.points[pid].observations:
            obs_flat.append((pid, f, kp))
            obs_desc.append(np.asarray(d, np.float32).reshape(-1))
    max_d = max((len(d) for d in obs_desc), default=0)
    desc_arr = np.zeros((len(obs_desc), max_d), np.float32)
    for i, d in enumerate(obs_desc):
        desc_arr[i, :len(d)] = d

    data = {
        "positions": world_map.get_point_array(),
        "colours": world_map.get_color_array(),
        "pids": np.asarray(pids, np.int64),
        "created_kf": np.asarray(
            [world_map.points[p].keyframe_idx for p in pids], np.int32),
        "poses": (np.stack(world_map.poses) if world_map.poses
                  else np.zeros((0, 4, 4))),
        "keyframe_indices": np.asarray(world_map.keyframe_indices, np.int64),
        "obs": np.asarray(obs_flat, np.int64).reshape(-1, 3),
        "obs_desc": desc_arr,
        "frame_ids": np.asarray(frame_ids or [], np.int64),
        "n_kfs": np.asarray([len(kfs)]),
    }
    for i, kf in enumerate(kfs):
        f = kf.feats.numpy()
        data[f"kf{i}_meta"] = np.frombuffer(
            json.dumps({"idx": kf.idx, "frame_idx": kf.frame_idx,
                        "path": kf.path}).encode(), np.uint8)
        data[f"kf{i}_pose"] = np.asarray(kf.pose)
        for name in ("kpts", "desc", "scores", "valid"):
            data[f"kf{i}_{name}"] = f[name]
        data[f"kf{i}_thumb"] = np.frombuffer(kf.thumb, np.uint8)
    if cfg is not None:
        data["config_json"] = np.frombuffer(
            json.dumps(asdict(cfg)).encode(), np.uint8)
    np.savez_compressed(path, **data)


def load_state(path: str, device=None
               ) -> Tuple[Map, List[Keyframe], Optional[dict], List[int]]:
    """(map, keyframes, the config as a dict or None, frame ids) from a
    state file. The landmarks get new sequential ids; each keeps its
    creating keyframe and its observations (remapped). The keyframes'
    features are tensors on ``device`` (default the CPU)."""
    z = np.load(path, allow_pickle=False)
    m = Map()
    for pose in z["poses"]:
        m.poses.append(np.asarray(pose))
    m.keyframe_indices = [int(v) for v in z["keyframe_indices"]]

    pids = z["pids"]
    remap = {}
    if len(pids):
        new_ids = m.add_points(z["positions"], z["colours"])
        for old, new, ckf in zip(pids, new_ids, z["created_kf"]):
            remap[int(old)] = int(new)
            m._created_kf[m._row[int(new)]] = int(ckf)
    for (pid, f, kp), d in zip(z["obs"], z["obs_desc"]):
        m.points[remap[int(pid)]].add_observation(int(f), int(kp), d)

    kfs: List[Keyframe] = []
    for i in range(int(z["n_kfs"][0])):
        meta = json.loads(bytes(z[f"kf{i}_meta"]).decode())
        feats = Features(*(torch.as_tensor(z[f"kf{i}_{name}"], device=device)
                           for name in ("kpts", "desc", "scores", "valid")))
        kfs.append(Keyframe(meta["idx"], meta["frame_idx"], meta["path"],
                            feats, np.asarray(z[f"kf{i}_pose"]),
                            bytes(z[f"kf{i}_thumb"])))
    cfg = None
    if "config_json" in z:
        cfg = json.loads(bytes(z["config_json"]).decode())
    return m, kfs, cfg, [int(v) for v in z["frame_ids"]]
