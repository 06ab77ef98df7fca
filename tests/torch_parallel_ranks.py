"""The multi-rank side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_sfm.py``: the port's process-group entry points run in
several ``gloo`` processes on the CPU, each an ordinary rank of one group.

Imports torch, numpy and the port only (no JAX): the ranks are spawned by
``torch.multiprocessing`` and pay only for what they run. ``spawn_ranks``
starts them once, they rendezvous on a ``FileStore``, run every check
named in ``jobs`` inside that one group, and rank 0 writes the results
(numpy arrays) to a pickle the test module reads; every rank also writes
a digest of what it returned, so a test can hold every rank to rank 0.

The fixtures (models, images, BA windows, the training batch) are built
here from seeds, so the test module builds the same ones for the
references.
"""
from __future__ import annotations

import hashlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

H, W, MAX_KP = 48, 64, 32          # tests/test_parallel.py's sizes
DESC, DIM, LAYERS = 32, 64, 2
B_PAIRS = 8
TIMEOUT_S = 300            # a rank that hangs fails its module's tests
TRAIN_B, TRAIN_HW, TRAIN_G, TRAIN_LR = 4, (48, 48), 16, 1e-2
TRAIN_DIM = 128


# --------------------------------------------------------------------------- #
# fixtures, shared with the test modules
# --------------------------------------------------------------------------- #

def models():
    """Seeded ALIKED and LightGlue at the reference tests' small width."""
    from simpleslam_tpu_torch.models import aliked, lightglue
    g = torch.Generator().manual_seed(0)
    return (aliked.init_aliked(g, DESC).eval(),
            lightglue.init_lightglue(g, DESC, DIM, 4, LAYERS).eval())


def images():
    """Two (B, H, W, 1) batches in [0, 1]: noise and the noise shifted by
    (3, 2) pixels."""
    rng = np.random.default_rng(0)
    im0 = rng.uniform(0, 1, (B_PAIRS, H, W, 1)).astype(np.float32)
    im1 = np.roll(im0, (2, 3), axis=(1, 2))
    return torch.as_tensor(im0), torch.as_tensor(im1)


def ba_fixture(P_=6, L_=256, E_=2048, noise=0.5, seed=0):
    """``tests/test_parallel.py::_ba_fixture`` in numpy: (fields of a
    BAProblem in its order, K)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-5, 5, L_), rng.uniform(-3, 3, L_),
                    rng.uniform(4, 30, L_)], 1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (P_, 1, 1))
    poses[:, 0, 3] = np.arange(P_) * 0.3
    cam_idx = rng.integers(0, P_, E_).astype(np.int32)
    pt_idx = rng.integers(0, L_, E_).astype(np.int32)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]],
                 np.float32)
    pc = np.einsum("eij,ej->ei", poses[cam_idx][:, :3, :3], pts[pt_idx]) \
        + poses[cam_idx][:, :3, 3]
    uv = ((pc[:, :2] / pc[:, 2:3]) * 500.0 + np.array([320.0, 240.0],
                                                      np.float32))
    uv = (uv + rng.normal(0, noise, (E_, 2))).astype(np.float32)
    poses_n = poses.copy()
    poses_n[:, :3, 3] += rng.normal(0, 0.05, (P_, 3)).astype(np.float32)
    pts_n = (pts + rng.normal(0, 0.05, (L_, 3))).astype(np.float32)
    cam_free = np.ones(P_, bool)
    cam_free[0] = False
    return (poses_n, pts_n, cam_idx, pt_idx, uv, np.ones(E_, bool),
            cam_free, np.ones(L_, bool)), K


def torch_problem(fields):
    from simpleslam_tpu_torch.ops.ba import BAProblem
    f = [torch.as_tensor(x) for x in fields]
    f[2], f[3] = f[2].long(), f[3].long()
    return BAProblem(*f)


def train_state(lr: float = TRAIN_LR):
    """(tx, state) of the float32 training models at a small width; no
    warmup, so the first update moves the parameters."""
    from simpleslam_tpu_torch.models import train
    return train.make_train_state(
        torch.Generator().manual_seed(3), lr=lr, warmup=0, total_steps=10,
        device="cpu", desc_dim=DESC, dim=TRAIN_DIM, n_layers=LAYERS,
        dtype=torch.float32)


def train_batch():
    """A homography batch whose two dp halves hold different valid-point
    counts (each sample of the first half keeps at most 5 of its 16
    points)."""
    from simpleslam_tpu_torch.models import train
    batch = train.synthetic_pair_batch(torch.Generator().manual_seed(4),
                                       TRAIN_B, *TRAIN_HW, TRAIN_G)
    batch["pt_valid"] = batch["pt_valid"].clone()
    batch["pt_valid"][: TRAIN_B // 2, 5:] = False
    return batch


# --------------------------------------------------------------------------- #
# the ranks
# --------------------------------------------------------------------------- #

def _np(record):
    return {k: v for k, v in record.numpy().items()}


def _digest(obj) -> str:
    h = hashlib.sha1()

    def feed(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                feed(v)
        else:
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())

    feed(obj)
    return h.hexdigest()


def job_mesh(res):
    from simpleslam_tpu_torch.parallel.mesh import make_mesh
    out = {}
    for args in ((), (4, 1), (2, 1)):
        m = make_mesh(*args)
        out[args] = dict(zip(m.mesh_dim_names, m.shape))
    try:
        make_mesh(8)
        out["error"] = None
    except ValueError as e:
        out["error"] = str(e)
    res["mesh"] = out


def job_batch(res):
    from simpleslam_tpu_torch.ops.features import orb_detect_and_describe
    from simpleslam_tpu_torch.parallel import batch
    from simpleslam_tpu_torch.parallel.mesh import make_mesh
    a, lg = models()
    im0, im1 = images()
    for name, mesh in (("dp4", make_mesh(4, tp=1)), ("dp2tp2", make_mesh())):
        f0, f1, m = batch.sharded_extract_and_match(
            a, lg, im0, im1, mesh, max_kp=MAX_KP, image_hw=(H, W),
            min_conf=0.0)
        res[f"sem_{name}"] = {"f0": _np(f0), "f1": _np(f1), "m": _np(m)}
    mesh = make_mesh(4, tp=1)
    fe = batch.sharded_extract(a, im0, mesh, max_kp=MAX_KP)
    fe1 = batch.sharded_extract(a, im1, mesh, max_kp=MAX_KP)
    res["extract"] = _np(fe)
    res["match"] = _np(batch.sharded_match(lg, fe, fe1, mesh,
                                           image_hw=(H, W), min_conf=0.0))
    grays = (im0[..., 0] * 255.0).round()
    res["orb"] = _np(batch.sharded_extract_classical(
        lambda g: orb_detect_and_describe(g, max_kp=64, fast_thresh=20.0),
        grays, mesh))
    try:
        batch.sharded_extract(a, im0[:6], mesh, max_kp=MAX_KP)
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)


def job_ba(res):
    from simpleslam_tpu_torch.ops.ba import ba_solve_sharded
    from simpleslam_tpu_torch.parallel.mesh import make_mesh
    for name, mesh, kw, iters in (
            ("dp4", make_mesh(4, tp=1), dict(E_=2044), 12),
            ("dp2tp2", make_mesh(), dict(P_=4, L_=128, E_=1024, seed=2), 8)):
        fields, K = ba_fixture(**kw)
        out = ba_solve_sharded(torch_problem(fields), torch.as_tensor(K),
                               mesh, huber=2.0, max_iters=iters)
        res[f"ba_{name}"] = [t.numpy() for t in out]


def job_train(res):
    from simpleslam_tpu_torch.models import train
    from simpleslam_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh()                      # 2 x 2
    tx, state = train_state()
    batch = train_batch()
    sstate = train.shard_train_state(state, mesh)
    n_sharded = sum(getattr(p, "tp_sharded", False)
                    for p in train.param_list(sstate.models))
    metrics, grad = train.sharded_loss_and_grad(sstate.models, batch,
                                                TRAIN_HW, mesh)
    full_grad = train.gather_flat(sstate.models, grad, mesh)
    step = train.make_sharded_train_step(tx, TRAIN_HW, mesh)
    sstate, step_metrics = step(sstate, batch)
    res["train"] = {
        "grad": full_grad.numpy(), "n_sharded": n_sharded,
        "local_numel": sstate.flat.numel(),
        "params": train.gather_flat(sstate.models, sstate.flat,
                                    mesh).numpy(),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "step_metrics": {k: float(v) for k, v in step_metrics.items()},
        "step": sstate.step}


def job_sfm(res):
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.parallel.mesh import make_mesh
    from simpleslam_tpu_torch.tools.sfm import StructureFromMotion
    frames, K = sfm_frames()
    out = {}
    for front, extra in (("orb", []), ("learned", ["--use_lightglue"])):
        cfg = parse_config(["--dataset", "kitti", "--headless",
                            "--max_features", "256"] + extra)
        for name, mesh in (("mesh", make_mesh(tp=1)), ("none", None)):
            sfm = StructureFromMotion(cfg, K, mesh=mesh, device="cpu")
            sfm.add_frames(frames)
            kf, feats = sfm._keyframe_prepass()
            out[front, name] = {"kf": kf, "feats": [_np(f) for f in feats]}
    res["sfm"] = out


def sfm_frames(n: int = 6, hw=(96, 160)):
    """``tests/test_parallel.py``'s SfM corridor rendered by the port:
    (frames as uint8 arrays, K)."""
    from simpleslam_tpu_torch.tools.synth import (DEFAULT_K, CorridorScene,
                                                  make_trajectory)
    Hh, Ww = hw
    s = Ww / 1232.0
    K = DEFAULT_K.copy()
    K[0] *= s
    K[1] *= s
    K[1, 2] = 0.487 * Hh
    scene = CorridorScene(seed=0, hw=hw, K=K, device="cpu")
    T = make_trajectory(n, speed=0.8, yaw_rate_deg=0.5)
    return [scene.render(T[i]).numpy() for i in range(n)], K


JOBS = {"mesh": job_mesh, "batch": job_batch, "ba": job_ba,
        "train": job_train, "sfm": job_sfm}


def rank_main(rank: int, world: int, store_path: str, out_dir: str,
              jobs) -> None:
    import datetime
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        res = {}
        for j in jobs:
            JOBS[j](res)
        with open(os.path.join(out_dir, f"digest{rank}.txt"), "w") as f:
            f.write(_digest({k: v for k, v in res.items()
                             if k not in ("mesh",)}))
        if rank == 0:
            with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
                pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, tmp_dir: str, jobs) -> dict:
    """Run ``jobs`` in ``world`` gloo ranks -> (rank 0's results, the
    digests of every rank's results)."""
    import time

    import torch.multiprocessing as mp
    os.makedirs(tmp_dir, exist_ok=True)
    ctx = mp.start_processes(rank_main, args=(
        world, os.path.join(tmp_dir, "store"), tmp_dir, list(jobs)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=1):          # raises if a rank failed
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {world} ranks ran past {TIMEOUT_S} s")
    with open(os.path.join(tmp_dir, "rank0.pkl"), "rb") as f:
        res = pickle.load(f)
    digests = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"digest{r}.txt")) as f:
            digests.append(f.read())
    return res, digests
