"""Dataset loaders: KITTI / Malaga / TUM-RGBD / custom video (the
counterpart of ``simpleslam_tpu/data/dataloader.py``), without cv2, PIL or
pandas.

* ``load_sequence``     -- KITTI seq-05 ``image_0/*.png``, Malaga
  extract-07 ``*_left.jpg``, TUM fr3 ``rgb/*.png``, ``parking``; ``custom``
  (an mp4) needs a video decoder and raises, as the reference does without
  cv2;
* ``load_frame_pair``, ``load_stereo_paths``;
* ``load_calibration``  -- KITTI's ``calib.txt`` when the sequence has one,
  else the hard-coded seq-05 / Malaga / TUM-fr3 cameras, a pickle for
  ``custom``;
* ``load_groundtruth``  -- KITTI pose rows, TUM quaternion table aligned to
  the frames by nearest timestamp, Malaga GPS interpolated per frame with
  the ``[-y, z, x]`` axis remap;
* :class:`Sequence` (frames + calibration + GT, the hard-coded cameras
  rescaled to the frames' size) and :class:`Prefetcher` (decode, and
  optionally upload, ahead of the consumer on a thread).

Frames are read by ``utils/png.py`` (8-bit PNG). Other files (Malaga's
JPEG frames) are read by cv2, imported when such a frame is read, as
``cv2.imread(path, IMREAD_UNCHANGED)`` reads them in the reference; without
cv2 :func:`imread_bgr` raises ``ImportError`` naming the file.
"""
from __future__ import annotations

import glob
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence as Seq, Union

import numpy as np

from simpleslam_tpu_torch.utils.png import SIGNATURE, decode_png

Frame = Union[str, np.ndarray]


def imread_bgr(path: str) -> np.ndarray:
    """Read an image as BGR uint8 (BGRA where the PNG has alpha, as cv2's
    ``IMREAD_UNCHANGED``); grey frames become BGR by channel copy. PNG is
    decoded here, anything else (JPEG) by cv2 at this call."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(SIGNATURE):
        img = decode_png(data)
    else:
        try:
            import cv2
        except ImportError as e:
            raise ImportError(f"{path}: only PNG frames are decoded without "
                              "cv2; reading this one needs cv2") from e
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


# --------------------------------------------------------------------------- #
# Sequences
# --------------------------------------------------------------------------- #

def _glob_sorted(*parts: str) -> List[str]:
    return sorted(glob.glob(os.path.join(*parts)))


def load_sequence(args) -> List[Frame]:
    """List of image paths, in the reference's dataset layouts."""
    prefix = os.path.join(args.base_dir, args.dataset)
    name = args.dataset

    if name == "kitti":
        seq: List[Frame] = _glob_sorted(prefix, "05", "image_0", "*.png")
    elif name == "parking":
        seq = _glob_sorted(prefix, "images", "*.png")
    elif name == "malaga":
        seq = _glob_sorted(
            prefix, "malaga-urban-dataset-extract-07_rectified_800x600_Images",
            "*_left.jpg")
    elif name == "tum-rgbd":
        seq = _glob_sorted(
            prefix, "rgbd_dataset_freiburg3_long_office_household", "rgb",
            "*.png")
    elif name == "custom":
        raise RuntimeError("custom video decoding requires cv2")
    else:
        raise ValueError(f"Unknown dataset: {name}")

    if len(seq) < 2:
        raise RuntimeError("Dataset must contain at least two frames.")
    return seq


def load_frame_pair(args, seq: Seq[Frame], i: int):
    """BGR frames i and i+1 (paths decoded; in-memory passed through)."""
    a, b = seq[i], seq[i + 1]
    if isinstance(a, np.ndarray):
        return a, b
    return imread_bgr(a), imread_bgr(b)


def load_stereo_paths(args) -> List[str]:
    """Right-camera image paths where the dataset has them."""
    prefix = os.path.join(args.base_dir, args.dataset)
    if args.dataset == "kitti":
        return _glob_sorted(prefix, "05", "image_1", "*.png")
    if args.dataset == "malaga":
        return _glob_sorted(
            prefix, "malaga-urban-dataset-extract-07_rectified_800x600_Images",
            "*_right.jpg")
    return []


# --------------------------------------------------------------------------- #
# Calibration
# --------------------------------------------------------------------------- #

# KITTI odometry grayscale calibration (sequence 05 cameras P0/P1)
_KITTI_P0 = np.array(
    [[707.0912, 0.0, 601.8873, 0.0],
     [0.0, 707.0912, 183.1104, 0.0],
     [0.0, 0.0, 1.0, 0.0]], dtype=np.float64)
_KITTI_P1 = np.array(
    [[707.0912, 0.0, 601.8873, -379.8145],
     [0.0, 707.0912, 183.1104, 0.0],
     [0.0, 0.0, 1.0, 0.0]], dtype=np.float64)

# Malaga extract-07 rectified 800x600 left camera
_MALAGA_K = np.array(
    [[795.11588, 0.0, 517.12973],
     [0.0, 795.11588, 395.59665],
     [0.0, 0.0, 1.0]], dtype=np.float64)

# TUM freiburg3 (pre-rectified, zero distortion)
_TUM_FR3_K = np.array(
    [[535.4, 0.0, 320.1],
     [0.0, 539.2, 247.6],
     [0.0, 0.0, 1.0]], dtype=np.float64)


def load_calibration(args) -> Dict[str, Optional[np.ndarray]]:
    """{'K_l','P_l','K_r','P_r'[,'D_l','D_r']} per dataset. A KITTI
    sequence's ``calib.txt`` ("P0: <12 floats>" rows) describes its frames
    as they are and is marked ``native``."""
    name = args.dataset
    if name == "kitti":
        calib_txt = os.path.join(args.base_dir, name, "05", "calib.txt")
        if os.path.isfile(calib_txt):
            P = {}
            with open(calib_txt) as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    vals = np.fromiter(rest.split(), dtype=np.float64)
                    if key.strip() in ("P0", "P1") and vals.size == 12:
                        P[key.strip()] = vals.reshape(3, 4)
            if "P0" in P:
                P1 = P.get("P1", P["P0"])
                return {"K_l": P["P0"][:, :3].copy(), "P_l": P["P0"].copy(),
                        "K_r": P1[:, :3].copy(), "P_r": P1.copy(),
                        "native": True}
        return {"K_l": _KITTI_P0[:, :3].copy(), "P_l": _KITTI_P0.copy(),
                "K_r": _KITTI_P1[:, :3].copy(), "P_r": _KITTI_P1.copy()}
    if name == "malaga":
        P = np.hstack([_MALAGA_K, np.zeros((3, 1))])
        return {"K_l": _MALAGA_K.copy(), "P_l": P,
                "K_r": _MALAGA_K.copy(), "P_r": P.copy()}
    if name == "tum-rgbd":
        P = np.hstack([_TUM_FR3_K, np.zeros((3, 1))])
        return {"K_l": _TUM_FR3_K.copy(), "P_l": P,
                "D_l": np.zeros(5, dtype=np.float64),
                "K_r": None, "P_r": None, "D_r": None}
    if name == "custom":
        calib_path = os.path.join(args.base_dir, name, "calibration.pkl")
        with open(calib_path, "rb") as f:
            K, *_rest = pickle.load(f)
        return {"K_l": np.asarray(K, dtype=np.float64),
                "P_l": np.hstack([K, np.zeros((3, 1))]),
                "K_r": None, "P_r": None}
    raise ValueError(f"No calibration loader for {name}")


# --------------------------------------------------------------------------- #
# Ground truth
# --------------------------------------------------------------------------- #

def _tum_quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    """xyzw quaternion batch -> (N,3,3) rotations."""
    q = np.stack([qx, qy, qz, qw], axis=-1).astype(np.float64)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _read_tum_table(path: str) -> List[List[str]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append(line.split())
    return rows


def _parse_tum_rgb_list(txt_path: str, seq_dir: str):
    rows = _read_tum_table(txt_path)
    stamps = [float(r[0]) for r in rows]
    paths = [os.path.join(seq_dir, r[1]) for r in rows]
    return paths, stamps


def _nearest_align(query_ts: np.ndarray, ref_ts: np.ndarray) -> np.ndarray:
    """Index of the nearest ref timestamp for each query timestamp; queries
    at or before the first ref stamp take index 0."""
    idx = np.searchsorted(ref_ts, query_ts)
    idx = np.clip(idx, 1, len(ref_ts) - 1)
    left = idx - 1
    pick_left = (np.abs(ref_ts[left] - query_ts)
                 <= np.abs(ref_ts[idx] - query_ts))
    out = np.where(pick_left, left, idx)
    return np.where(query_ts <= ref_ts[0], 0, out)


def load_groundtruth(args) -> Optional[np.ndarray]:
    """(N,3,4) ground-truth poses or None."""
    prefix = os.path.join(args.base_dir, args.dataset)
    name = args.dataset

    if name == "kitti":
        poses = np.loadtxt(os.path.join(prefix, "poses", "05.txt"))
        return poses.reshape(-1, 3, 4)

    if name == "malaga":
        seq = load_sequence(args)
        gps = os.path.join(
            prefix, "malaga-urban-dataset-extract-07_all-sensors_GPS.txt")
        return _malaga_groundtruth(gps, seq)

    if name == "tum-rgbd":
        seq_dir = os.path.join(prefix,
                               "rgbd_dataset_freiburg3_long_office_household")
        _, rgb_ts = _parse_tum_rgb_list(os.path.join(seq_dir, "rgb.txt"),
                                        seq_dir)
        rows = _read_tum_table(os.path.join(seq_dir, "groundtruth.txt"))
        arr = np.array([[float(v) for v in r[:8]] for r in rows])
        gt_ts, txyz, quat = arr[:, 0], arr[:, 1:4], arr[:, 4:8]
        R = _tum_quat_to_rot(quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3])
        P = np.concatenate([R, txyz[:, :, None]], axis=-1)       # (M,3,4)
        idx = _nearest_align(np.asarray(rgb_ts), gt_ts)
        return P[idx]

    print(f"No ground truth available for dataset: {name}")
    return None


def _malaga_timestamp(path: str) -> float:
    """Timestamp embedded in a Malaga filename '..._<ts>_left.jpg'."""
    return float(os.path.basename(path).split("_")[2])


def _read_gps_log(path: str) -> np.ndarray:
    """(M, 4) Time, LocalX, LocalY, LocalZ of a Malaga GPS log
    (whitespace-separated columns, '%' comments), sorted by time."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split("%", 1)[0].split()
            if vals:
                rows.append([float(vals[i]) for i in (0, 8, 9, 10)])
    arr = np.asarray(rows, np.float64).reshape(-1, 4)
    return arr[np.argsort(arr[:, 0], kind="stable")]


def _malaga_groundtruth(gps_path: str, seq: List[str]) -> np.ndarray:
    """GPS log -> per-image interpolated positions with the camera axis
    remap ``[-LocalY, LocalZ, LocalX]``. Trims ``seq`` in place to the
    images inside the log's time interval, as the reference does."""
    log = _read_gps_log(gps_path)
    t, xyz = log[:, 0], log[:, 1:4]

    ts = np.array([_malaga_timestamp(p) for p in seq])
    keep = (ts >= t[0]) & (ts <= t[-1])
    seq[:] = [p for p, k in zip(seq, keep) if k]
    ts = ts[keep]

    ix = np.clip(np.searchsorted(t, ts), 1, len(t) - 1)
    t0, t1 = t[ix - 1], t[ix]
    denom = np.where(t1 == t0, 1.0, t1 - t0)
    a = np.where(t1 == t0, 0.0, (ts - t0) / denom)[:, None]
    p = xyz[ix - 1] + a * (xyz[ix] - xyz[ix - 1])
    pos = np.stack([-p[:, 1], p[:, 2], p[:, 0]], axis=-1)

    P = np.tile(np.eye(4, dtype=np.float64)[:3], (len(pos), 1, 1))
    P[:, :3, 3] = pos
    return P


# --------------------------------------------------------------------------- #
# Sequence wrapper used by the pipeline
# --------------------------------------------------------------------------- #

@dataclass
class Sequence:
    """A resolved dataset: frames + calibration + GT, with index access."""
    frames: List[Frame]
    calib: Dict[str, Optional[np.ndarray]]
    gt: Optional[np.ndarray] = None
    name: str = "unknown"
    timestamps: Optional[np.ndarray] = field(default=None)

    @classmethod
    def load(cls, args) -> "Sequence":
        frames = load_sequence(args)
        calib = load_calibration(args)
        gt = load_groundtruth(args)
        seq = cls(frames=frames, calib=calib, gt=gt, name=args.dataset)
        seq._rescale_calib_to_frames(args.dataset)
        return seq

    # the hard-coded calibrations describe frames of these sizes; frames
    # of another size get the intrinsics rescaled per axis (fx, cx by the
    # width ratio; fy, cy by the height ratio; the P rows likewise)
    _NATIVE_HW = {"kitti": (370, 1226), "malaga": (600, 800),
                  "tum-rgbd": (480, 640)}

    def _rescale_calib_to_frames(self, dataset: str) -> None:
        if self.calib.get("native"):   # calib.txt describes the frames as-is
            return
        native = self._NATIVE_HW.get(dataset)
        if native is None or not self.frames:
            return
        img = self.frame(0)
        H, W = img.shape[:2]
        sy, sx = H / native[0], W / native[1]
        if abs(sx - 1.0) < 1e-6 and abs(sy - 1.0) < 1e-6:
            return
        S = np.diag([sx, sy, 1.0])
        for key in ("K_l", "K_r", "P_l", "P_r"):
            if self.calib.get(key) is not None:
                self.calib[key] = S @ self.calib[key]

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int) -> np.ndarray:
        f = self.frames[i]
        if isinstance(f, np.ndarray):
            return f
        return imread_bgr(f)

    @property
    def K(self) -> np.ndarray:
        return self.calib["K_l"]

    @property
    def D(self) -> Optional[np.ndarray]:
        return self.calib.get("D_l")


class Prefetcher:
    """Decode (and, with ``transform``, e.g. upload) up to ``depth`` frames
    ahead of the consumer on a worker thread, while a native readahead
    thread (``native.FilePrefetcher``) pulls the upcoming frame files
    through the page cache.

    Usage: ``for idx, frame in Prefetcher(seq, transform=to_device): ...``
    """

    def __init__(self, seq: "Sequence", depth: int = 2, start: int = 0,
                 transform=None):
        import queue
        import threading

        self.seq = seq
        self.depth = max(1, int(depth))
        self.start = int(start)
        self.transform = transform
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = False
        paths = [f for f in seq.frames[self.start:] if isinstance(f, str)]
        self._native = None
        if paths:
            from simpleslam_tpu_torch.native import FilePrefetcher
            self._native = FilePrefetcher(paths)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for i in range(self.start, len(self.seq)):
                if self._stop:
                    break
                img = self.seq.frame(i)
                if self.transform is not None:
                    img = self.transform(img)
                self._q.put((i, img))
        except BaseException as e:       # handed to the consumer
            self._q.put((None, e))
            return
        self._q.put((None, None))

    def __iter__(self):
        while True:
            i, img = self._q.get()
            if i is None:
                if img is not None:
                    raise img
                break
            yield i, img

    def close(self) -> None:
        self._stop = True
        if self._native is not None:
            self._native.stop()
        # drain so the worker can exit
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
