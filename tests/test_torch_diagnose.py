"""``tools/diagnose.py`` against the JAX package's probes, on the CPU:

* ``ba``: the warm solve of the probe's window (``default_rng(0)``, P 10,
  L 2048, E 16384) against the reference's ``ba_solve`` on the same numpy
  problem: costs within 1e-4 relative, the same good iterations; the
  CLI's lines at a small window;
* ``tri`` with the classical front-end (ORB, cross-checked matching) on a
  180x410 corridor that both packages' frame helpers are patched to, the
  port fed the reference's RANSAC draws: raw matches exactly, the RANSAC
  and gate counts within TRI_TOL of the reference's (the F refit's
  float32 sensitivity, ROADMAP C "measured behaviour"). The learned pair
  costs ~60 s a package on one CPU thread; the card runs it (chip_smoke
  phase 13);
* ``e2e`` on 11 frames of that corridor (ORB, 512 keypoints): the CLI's
  per-frame table and ATE equal the port's own fused loop
  (``run_slam.run_fused_loop``) over the same frames.

``desc`` is in ``tests/test_torch_diagnose_desc.py``. One process, one
torch thread: ~65 s.
"""
import argparse
import contextlib
import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simpleslam_tpu.tools import diagnose as jdiag
from simpleslam_tpu_torch.tools import diagnose
from simpleslam_tpu_torch.tools.synth import SCENE_FAMILIES, make_trajectory

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

# relative, on the RANSAC survivors and each gate's count
TRI_TOL = 0.05
HW = (180, 410)


def _stdout(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*a)
    return rc, buf.getvalue()


class JaxKey:
    """The port's key interface backed by ``jax.random`` (the reference's
    draws)."""

    def __init__(self, key):
        self.key = key

    def fold_in(self, data):
        return JaxKey(jax.random.fold_in(self.key, int(data)))

    def split(self, num=2):
        return tuple(JaxKey(k) for k in jax.random.split(self.key, num))

    def randint(self, shape, high, device):
        r = jax.random.randint(self.key, tuple(shape), 0,
                               jnp.maximum(jnp.int32(int(high)), 1))
        return torch.as_tensor(np.array(r), dtype=torch.int64,
                               device=device)


@pytest.fixture(scope="module")
def corridor():
    """The probes' corridor at 180x410 (the port's render) as 27 frames,
    of which the first 11 and the ``tri`` pairs' are rendered (the rest
    black): (frames, K, T_wc)."""
    K = diagnose._scaled_K(*HW)
    T = make_trajectory(27, speed=0.5, yaw_rate_deg=0.3)
    sc = SCENE_FAMILIES["corridor"](seed=0, hw=HW, K=K, device="cpu")
    frames = np.zeros((27,) + HW, np.uint8)
    for i in set(range(11)) | {i for p in diagnose.TRI_PAIRS for i in p}:
        frames[i] = sc.render(T[i]).numpy()
    return frames, K, T


# --------------------------------------------------------------------------- #
# ba
# --------------------------------------------------------------------------- #

def _reference_ba_warm():
    """The reference probe's problem and warm solve (``cmd_ba``'s code)."""
    from simpleslam_tpu.ops.ba import BAProblem, ba_solve
    rngb = np.random.default_rng(0)
    P_, L_, E_ = 10, 2048, 16384
    pts = jnp.asarray(np.stack([rngb.uniform(-5, 5, L_),
                                rngb.uniform(-3, 3, L_),
                                rngb.uniform(4, 30, L_)], 1), jnp.float32)
    poses = jnp.asarray(np.tile(np.eye(4), (P_, 1, 1)), jnp.float32)
    poses = poses.at[:, 0, 3].set(jnp.arange(P_) * 0.3)
    cam_idx = jnp.asarray(rngb.integers(0, P_, E_), jnp.int32)
    pt_idx = jnp.asarray(rngb.integers(0, L_, E_), jnp.int32)
    Kb = jnp.asarray([[707.0, 0, 601.0], [0, 707.0, 183.0], [0, 0, 1.0]],
                     jnp.float32)
    pc = jnp.einsum("eij,ej->ei", poses[cam_idx][:, :3, :3], pts[pt_idx]) \
        + poses[cam_idx][:, :3, 3]
    uv = (pc[:, :2] / pc[:, 2:3]) * 707.0 + jnp.asarray([601.0, 183.0])
    uv = uv + jnp.asarray(rngb.normal(0, 0.5, (E_, 2)), jnp.float32)
    prob = BAProblem(poses=poses, points=pts, cam_idx=cam_idx, pt_idx=pt_idx,
                     uv=uv, e_valid=jnp.ones(E_, bool),
                     cam_free=jnp.ones(P_, bool).at[0].set(False),
                     pt_free=jnp.ones(L_, bool))
    out = ba_solve(prob, Kb, huber=2.0, max_iters=12)
    return float(out[2]), float(out[3]), int(out[4]), np.asarray(uv)


def test_ba_warm_solve_matches_reference():
    c0, c1, good, j_uv = _reference_ba_warm()
    prob, _K = diagnose.ba_problem("cpu")
    np.testing.assert_allclose(prob.uv.numpy(), j_uv, rtol=0, atol=1e-3)
    r = diagnose.probe_ba("cpu", rounds=0, iters=())
    assert r["good_iters"] == good
    assert abs(r["cost_initial"] - c0) <= 1e-4 * abs(c0)
    assert abs(r["cost_final"] - c1) <= 1e-4 * abs(c1)
    assert r["cost_final"] < r["cost_initial"]


def test_ba_cli_lines(monkeypatch):
    monkeypatch.setattr(diagnose, "BA_SIZE", (4, 128, 1024))
    rc, out = _stdout(diagnose.main, ["ba", "--device", "cpu"])
    lines = out.strip().splitlines()
    assert rc == 0 and len(lines) == 1 + 3 + 3
    assert re.fullmatch(r"warm: cost [\d.]+ -> [\d.]+, good iters \d+",
                        lines[0])
    for rep in range(3):
        assert re.fullmatch(rf"round {rep}: 5 solves in [\d.]+s -> "
                            r"[\d.]+ solves/s", lines[1 + rep])
    for line, it in zip(lines[4:], (1, 4, 12)):
        assert re.fullmatch(rf"max_iters={it:2d}: [\d.]+s/solve", line)


# --------------------------------------------------------------------------- #
# tri
# --------------------------------------------------------------------------- #

def _parse_tri(line):
    m = re.fullmatch(r"pair \((\d+),(\d+)\): raw=(\d+) ransac=(\d+) "
                     r"tri_keep=(\d+) why=(\{.*\})", line.strip())
    assert m, line
    why = {k: int(v) for k, v in re.findall(r"'(\w+)': (\d+)", m.group(6))}
    return dict(pair=[int(m.group(1)), int(m.group(2))],
                raw=int(m.group(3)), ransac=int(m.group(4)),
                tri_keep=int(m.group(5)), why=why)


def test_tri_matches_reference(corridor, monkeypatch):
    monkeypatch.setattr(jdiag, "_full_scale_frames",
                        lambda **kw: corridor)
    monkeypatch.setattr(diagnose, "full_scale_frames",
                        lambda **kw: corridor)
    args = argparse.Namespace(seed=0, scene="corridor", learned=False,
                              min_conf=0.7)
    rc, out = _stdout(jdiag.cmd_tri, args)
    ref = [_parse_tri(ln) for ln in out.strip().splitlines()]
    port = diagnose.probe_tri(learned=False, device="cpu",
                              key=JaxKey(jax.random.PRNGKey(0)))
    assert rc == 0 and len(ref) == len(port) == 3
    for r, p in zip(ref, port):
        assert p["pair"] == r["pair"] and p["raw"] == r["raw"] > 300
        assert sorted(p["why"]) == sorted(r["why"])
        for k in ("ransac", "tri_keep"):
            assert abs(p[k] - r[k]) <= TRI_TOL * r[k], (k, p, r)
        for k, v in r["why"].items():
            assert abs(p["why"][k] - v) <= TRI_TOL * v, (k, p, r)
    # the CLI, on the port's own draws: the same pairs and raw matches
    rc, out = _stdout(diagnose.main, ["tri", "--classical", "--device",
                                      "cpu"])
    own = [_parse_tri(ln) for ln in out.strip().splitlines()]
    assert rc == 0
    assert [(o["pair"], o["raw"]) for o in own] == \
        [(p["pair"], p["raw"]) for p in port]


# --------------------------------------------------------------------------- #
# e2e
# --------------------------------------------------------------------------- #

def test_e2e_equals_the_ports_fused_loop(corridor, monkeypatch, tmp_path):
    from simpleslam_tpu_torch.config import parse_config
    from simpleslam_tpu_torch.run_slam import SLAMSystem, run_fused_loop
    from simpleslam_tpu_torch.tools.trajectory_eval import ate_rmse
    frames, K, T = corridor
    frames, T = frames[:11], T[:11]
    monkeypatch.setattr(diagnose, "full_scale_frames",
                        lambda **kw: (frames, K, T))
    monkeypatch.setattr(diagnose.tempfile, "gettempdir",
                        lambda: str(tmp_path))
    extra = "--max_features 512 --map_capacity 2048"
    rc, out = _stdout(diagnose.main, [
        "e2e", "--classical", "--frames", "11", "--extra", extra,
        "--device", "cpu"])
    lines = out.strip().splitlines()
    assert rc == 0, out
    head = lines.index("frame tracked kf n_inl n_new n_cand ba")
    table = [[int(x) for x in ln.split()] for ln in lines[head + 1:-1]]
    m = re.match(r"ATE-RMSE \(Sim3\): ([\d.]+) m over (\d+) frames .*, "
                 r"(\d+) lost", lines[-1])
    assert m, lines[-1]
    assert (tmp_path / "slam_torch_diag_e2e_traj.npz").exists()

    # the port's own fused loop over the same frames
    cfg = parse_config(diagnose.e2e_argv(False, extra=extra))
    system = SLAMSystem(cfg, K, None, img_hw=HW, device="cpu")
    prev = system.process_frame(0, frames[0], None)
    start = 1
    while not system.initialised:
        prev = system.process_frame(start, frames[start], prev)
        start += 1
    # the bootstrap's poses, then each fused frame's logged pose (the
    # sync at the end writes local BA's later refinements to the host
    # map; the probe scores the poses as the loop logged them)
    est = [np.array(p) for p in system.world_map.poses]
    state, _step = run_fused_loop(cfg, system, frames[start:], prev, start)
    n = len(frames) - start
    flags = state.log_flags[:n].numpy().astype(int)
    want = [[f] + list(fl[:6]) for f, fl in
            zip(range(start, len(frames)), flags)]
    assert table == want and len(table) == n > 5
    est += list(state.log_pose[:n].numpy())
    ate = ate_rmse(np.stack(est), T[:, :3, :4], align="sim3")[0]
    assert int(m.group(2)) == len(est) == len(frames)
    assert abs(float(m.group(1)) - ate) <= 5e-5      # printed to 1e-4
    assert int(m.group(3)) == n - int(flags[:, 0].sum())
