"""The port's ORB front-end, brute-force matcher, binary 2D-3D association
and binary place vector against the JAX package's, on the CPU, and the
ORB follow run of the slice.

Inputs: a seeded smooth texture (``chip_smoke.texture``) and frames of the
reference's synthetic corridor at 180x410, as BGR uint8. The reference's
ORB runs jitted, as the pipeline runs it.

Tolerances (measured on these inputs, stated in CHANGES.md): the grey
image, the BRIEF tables and the level-0 FAST mask are equal; Harris
within 1e-4 of its largest magnitude (read ~1e-7); the pyramid resize's
weights within 2e-7 of ``compute_weight_mat``'s and the resized image
within 1e-4 of ``jax.image.resize`` on [0, 1] data (XLA's jitted weight
normalisation on the CPU is off by up to 1e-5 relative in some columns,
0.0037 grey levels on 0-255 data; the port's weights are the exact
float32 arithmetic); keypoints: at least 99% of the reference's valid
ones have a port keypoint within 1e-3 px, and at least 99% of those carry
an identical descriptor, none more than 8 bits apart (read: all of them,
and all identical). The matcher and the association are equal.

The follow run: ``tests/test_torch_slam.py``'s harness with the ORB front-end.
The port's system is fed the reference's ORB features, brute-force
matches and F-RANSAC filter, with the reference's RANSAC draws; its
bootstrap, tracking (a lost frame and the 2D-2D fallback included),
keyframes, triangulation and local BA must give the reference's map
size, frame ids and keyframes at every frame and its poses within
``FOLLOW_POSE_TOL``. Two cases: a corridor rendered in memory at 240x640,
1 m/frame, 16 frames, 512 features (through a lost frame and two local
BAs), and ``test_e2e.py``'s fixture up to frame 3.

On ``test_e2e.py``'s fixture the runs fork at frame 4. After the
bootstrap the two packages' poses differ by 1.0e-5 and their landmarks
by up to 6.8e-4 (the two-view fit's float32 rounding, magnified along
the depth of far points). At frame 4, PnP-RANSAC's inlier gate (2.5 px)
keeps 191 of the same 275 candidates in the reference and 190 in the
port, and the poses part by 0.099. The reference forks from itself the
same way: with its own bootstrap landmarks moved by a uniform draw of
up to 6.8e-4, it keeps 191 against 190 at frame 4 and the poses part by
0.022; moved by up to 1e-6, it holds to 4.6e-6 through frame 4 and
1.1e-3 through frame 11, and parts at frame 12 (96 against 95
inliers), by 0.137 at frame 14. Neither track is close to the ground
truth there: each frame's centre, Sim(3)-aligned over the frames so
far, lies 0.17-0.20 m from it at frame 4 and 0.4-0.9 m at frame 5. The script at the end of this file
prints either run frame by frame, with each frame's PnP inlier counts:

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_orb.py \
        --hw 180 410 --speed 0.5 --frames 18 --scene_seed 3 \
        --kf_min_inliers 40 --pnp_min_inliers 15 [--witness 6.8e-4]
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import simpleslam_tpu.ops.features as jfeat
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat
from simpleslam_tpu.config import SLAMConfig as JConfig
from simpleslam_tpu.core.loop import place_vector as j_place_vector
from simpleslam_tpu.core.types import Features as JFeatures
from simpleslam_tpu.ops import matching as jmatch
from simpleslam_tpu.ops.pnp import reproject_and_match_2d3d as j_assoc
from simpleslam_tpu.run_slam import SLAMSystem as JSystem
from simpleslam_tpu.tools.synth import (DEFAULT_HW, DEFAULT_K, CorridorScene,
                                        make_trajectory)
from simpleslam_tpu_torch import run_slam
from simpleslam_tpu_torch.config import SLAMConfig
from simpleslam_tpu_torch.core import frontend
from simpleslam_tpu_torch.core.loop import place_vector
from simpleslam_tpu_torch.core.types import Features
from simpleslam_tpu_torch.ops import features, matching
from simpleslam_tpu_torch.ops.pnp import reproject_and_match_2d3d
from simpleslam_tpu_torch.utils.resize import (resize_linear_like_jax,
                                               triangle_weights)
from test_torch_slam import (FOLLOW_POSE_TOL, JaxKey, _ReferenceFilter,
                             _ReferenceFrontEnd, _ReferenceMatcher)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (180, 410)
MAX_KP = 512
KP_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _texture(seed):
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.texture(seed, HW, pad=0)


@pytest.fixture(scope="module")
def corridor_frames():
    K = DEFAULT_K.copy()
    K[0] *= HW[1] / DEFAULT_HW[1]
    K[1] *= HW[0] / DEFAULT_HW[0]
    scene = CorridorScene(seed=3, hw=HW, K=K)
    T = make_trajectory(6, speed=0.5, yaw_rate_deg=0.3)
    return K, T, [scene.render(T[i]) for i in (0, 5)]


@pytest.fixture(scope="module")
def images(corridor_frames):
    """BGR uint8 frames: a texture and a corridor frame."""
    return {"texture": np.repeat(_texture(5)[..., None], 3, -1),
            "corridor": np.repeat(corridor_frames[2][0][..., None], 3, -1)}


def _grey(img):
    got = features.rgb_to_gray(torch.as_tensor(img))
    want = np.asarray(jfeat.rgb_to_gray(jnp.asarray(img)))
    return got, want


@pytest.fixture(scope="module")
def orb_pairs(images):
    """{name: (reference Features as numpy, port Features)}."""
    out = {}
    for name, img in images.items():
        g_port, g_ref = _grey(img)
        ref = jfeat.orb_detect_and_describe(jnp.asarray(g_ref), max_kp=MAX_KP)
        out[name] = (jax.tree.map(np.asarray, ref),
                     features.orb_detect_and_describe(g_port, max_kp=MAX_KP))
    return out


def test_grey_and_brief_tables_equal(images):
    for img in images.values():
        got, want = _grey(img)
        assert np.array_equal(got.numpy(), want)
        # the weights sum to 1.0000000298 in float32: not the grey level
        assert not np.array_equal(want, img[..., 1].astype(np.float32))
    assert np.array_equal(features._brief_weight_tables(), jfeat._BRIEF_W)
    assert np.array_equal(features._brief_pattern(), jfeat._PATTERN)


@pytest.mark.parametrize("name", ["texture", "corridor"])
def test_fast_mask_and_harris(images, name):
    g_port, g_ref = _grey(images[name])
    want_h = np.asarray(jfeat.harris_response(jnp.asarray(g_ref)))
    got_h = features.harris_response(g_port).numpy()
    assert np.abs(got_h - want_h).max() <= 1e-4 * np.abs(want_h).max()
    want = np.isfinite(np.asarray(jfeat.fast_score_map(jnp.asarray(g_ref))))
    got = torch.isfinite(features.fast_score_map(g_port)).numpy()
    assert want.sum() > 100
    assert np.array_equal(got, want)


def test_resize_linear_like_jax():
    rng = np.random.default_rng(0)
    x = rng.random(HW).astype(np.float32)
    H, W = HW
    for _level in range(3):
        Hn, Wn = int(round(H / 1.2)), int(round(W / 1.2))
        for n, m in ((H, Hn), (W, Wn)):
            want_w = np.asarray(compute_weight_mat(
                n, m, m / n, 0.0, _fill_triangle_kernel, True))
            assert np.abs(triangle_weights(n, m).T - want_w).max() <= 2e-7
        want = np.asarray(jax.image.resize(jnp.asarray(x), (Hn, Wn),
                                           "linear"))
        got = resize_linear_like_jax(torch.as_tensor(np.array(x)),
                                     (Hn, Wn)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-4
        x, H, W = want, Hn, Wn


@pytest.mark.parametrize("name", ["texture", "corridor"])
def test_orb_matches_reference(orb_pairs, name):
    ref, port = orb_pairs[name]
    assert port.kpts.shape == (MAX_KP, 2) and port.desc.dtype == torch.uint8
    assert port.desc.shape == (MAX_KP, 32)
    assert ref.valid.sum() > 200
    assert int(port.valid.sum()) == int(ref.valid.sum())
    kp_ref = ref.kpts[ref.valid]
    kp_port = port.kpts.numpy()[port.valid.numpy()]
    d = np.linalg.norm(kp_ref[:, None] - kp_port[None], axis=-1)
    near = d.min(1) <= KP_TOL
    assert near.mean() >= 0.99, near.mean()
    d_ref = ref.desc[ref.valid][near]
    d_port = port.desc.numpy()[port.valid.numpy()][d.argmin(1)[near]]
    bits = np.unpackbits(d_ref ^ d_port, axis=1).sum(1)
    assert (bits == 0).mean() >= 0.99 and bits.max() <= 8, bits.max()
    assert (port.scores.numpy()[~port.valid.numpy()] == 0).all()


def _jax_features(f):
    return JFeatures(*(jnp.asarray(getattr(f, k))
                       for k in ("kpts", "desc", "scores", "valid")))


def _port_features(f):
    return Features(*(torch.as_tensor(np.array(getattr(f, k)))
                      for k in ("kpts", "desc", "scores", "valid")))


@pytest.fixture(scope="module")
def two_frames(corridor_frames):
    """Reference ORB features of two corridor frames 5 apart."""
    out = []
    for img in corridor_frames[2]:
        f = jfeat.orb_detect_and_describe(jnp.asarray(img, jnp.float32),
                                          max_kp=MAX_KP)
        out.append(jax.tree.map(np.asarray, f))
    return out


@pytest.mark.parametrize("cross_check, sort", [(True, True), (True, False),
                                               (False, True)])
def test_bf_match_equals_reference(two_frames, cross_check, sort):
    f0, f1 = two_frames
    want = jmatch.bf_match(_jax_features(f0),
                           _jax_features(f1),
                           cross_check=cross_check, sort=sort)
    got = matching.bf_match(_port_features(f0), _port_features(f1),
                            cross_check=cross_check, sort=sort)
    assert int(np.asarray(want.valid).sum()) > 50
    for k in ("idx0", "idx1", "valid", "score"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    d_want, i_want = jmatch.knn_distances(_jax_features(f0),
                                          _jax_features(f1))
    d_got, i_got = matching.knn_distances(_port_features(f0),
                                          _port_features(f1))
    assert np.array_equal(d_got.numpy(), np.asarray(d_want))
    assert np.array_equal(i_got.numpy(), np.asarray(i_want))


def test_binary_association_equals_reference(two_frames, corridor_frames):
    """Landmarks back-projected from frame 0's keypoints at seeded depths,
    each with a ring of frame-0 descriptors (some slots empty, some bits
    flipped), associated against frame 5's keypoints."""
    K, T_wc = corridor_frames[0], corridor_frames[1]
    f0, f1 = two_frames
    rng = np.random.default_rng(0)
    C, R = 1024, 6
    kp0 = f0.kpts[f0.valid]
    n = min(C, len(kp0))
    z = rng.uniform(4.0, 30.0, n)
    rays = np.c_[kp0[:n], np.ones(n)] @ np.linalg.inv(K).T
    pos = np.zeros((C, 3), np.float32)
    pos[:n] = (T_wc[0, :3, :3] @ (rays * z[:, None]).T).T + T_wc[0, :3, 3]
    alive = np.zeros(C, bool)
    alive[:n] = rng.random(n) < 0.9
    ring = np.zeros((C, R, 32), np.uint8)
    ring[:n] = f0.desc[f0.valid][:n, None]
    flip = rng.random((C, R, 32)) < 0.05
    ring[flip] ^= rng.integers(1, 256, int(flip.sum())).astype(np.uint8)
    n_desc = rng.integers(0, R + 2, C).astype(np.int32)
    Tcw = np.linalg.inv(T_wc[5]).astype(np.float32)
    args = (pos, alive, ring, n_desc, f1.kpts, f1.desc, f1.valid,
            K.astype(np.float32), Tcw)
    kw = dict(img_w=HW[1], img_h=HW[0], radius_px=12.0, max_hamm=64.0)
    want = j_assoc(*map(jnp.asarray, args), **kw)
    got = reproject_and_match_2d3d(*(torch.as_tensor(np.asarray(a))
                                     for a in args), chunk=256, **kw)
    valid = np.asarray(want.valid)
    assert valid.sum() > 100
    assert np.array_equal(got.valid.numpy(), valid)
    assert np.array_equal(got.kp_idx.numpy()[valid],
                          np.asarray(want.kp_idx)[valid])
    assert np.array_equal(got.dist.numpy()[valid],
                          np.asarray(want.dist)[valid])


def test_binary_place_vector_equals_reference():
    """MSB-first bits, as ``np.unpackbits``: the host vector and the fused
    step's device twin both equal the reference's within 1e-6."""
    from simpleslam_tpu_torch.core import fused
    rng = np.random.default_rng(1)
    n = 400
    kpts = rng.uniform(0, [HW[1], HW[0]], (n, 2)).astype(np.float32)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    valid = rng.random(n) < 0.8
    want = j_place_vector(JFeatures(jnp.asarray(kpts), jnp.asarray(desc),
                                    jnp.zeros(n), jnp.asarray(valid)), HW, 4)
    feats = Features(torch.as_tensor(kpts), torch.as_tensor(desc),
                     torch.zeros(n), torch.as_tensor(valid))
    got = place_vector(feats, HW, 4)
    assert got.shape == want.shape == (4 * 4 * 256,)
    assert np.abs(got - want).max() <= 1e-6
    step = fused.FusedStep.__new__(fused.FusedStep)
    step.fc = type("FC", (), dict(place_grid=4, img_w=HW[1], img_h=HW[0]))()
    step.device = torch.device("cpu")
    assert np.abs(step._place_vec(feats).numpy() - want).max() <= 1e-6


def _corridor_bgr(hw, speed, n_frames, seed=0):
    """(K, BGR frames, T_wc) of the reference's corridor, the intrinsics scaled
    to ``hw`` as ``tools/synth.py``'s ``fov`` camera (so
    ``_corridor_bgr((180, 410), 0.5, 18, seed=3)`` is ``test_e2e.py``'s
    fixture)."""
    K = DEFAULT_K.copy()
    K[0] *= hw[1] / DEFAULT_HW[1]
    K[1] *= hw[0] / DEFAULT_HW[0]
    scene = CorridorScene(seed=seed, hw=hw, K=K)
    T_wc = make_trajectory(n_frames, speed=speed, yaw_rate_deg=0.3)
    return (K, [np.repeat(scene.render(T)[..., None], 3, -1) for T in T_wc],
            T_wc)


def _follow_run(K, hw, frames, **cfg):
    """The follow run, frame by frame: yields (frame, reference system,
    port system, largest pose entry gap, largest landmark position gap)."""
    ref = JSystem(JConfig(**cfg), K, None, img_hw=hw)
    follow = run_slam.SLAMSystem(SLAMConfig(**cfg), K, None, img_hw=hw,
                                 device="cpu",
                                 key=JaxKey(jax.random.PRNGKey(0)))
    follow.detector = _ReferenceFrontEnd(ref)
    follow.matcher = _ReferenceMatcher(ref)
    ref_filter = _ReferenceFilter()
    prev_ref = prev_follow = None
    for i, img in enumerate(frames):
        prev_ref = ref.process_frame(i, img, prev_ref)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(frontend, "filter_matches_ransac", ref_filter)
            prev_follow = follow.process_frame(i, img, prev_follow)
        assert prev_follow.desc.dtype == torch.uint8
        yield (i, ref, follow) + _gaps(ref, follow)


def _gaps(ref, other):
    """(largest pose entry gap, largest landmark position gap) of two
    systems' maps."""
    gap = max((float(np.abs(a - b).max()) for a, b in
               zip(ref.world_map.poses, other.world_map.poses)), default=0.0)
    pts_r, pts_o = ref.world_map.points, other.world_map.points
    lm_gap = max((float(np.abs(np.asarray(pts_r[p].position)
                               - np.asarray(pts_o[p].position)).max())
                  for p in pts_r if p in pts_o), default=0.0)
    return gap, lm_gap


# (hw, speed, frames, scene seed, config) of each follow case: a
# corridor at 240x640, 1 m/frame, through a lost frame and two local BAs;
# and ``test_e2e.py``'s fixture up to frame 3, before it forks (module
# docstring)
FOLLOW_CASES = {
    "corridor_240x640": ((240, 640), 1.0, 16, 0, dict(max_features=512)),
    "e2e_fixture_to_frame_3": ((180, 410), 0.5, 4, 3, dict(
        max_features=512, kf_min_inliers=40, pnp_min_inliers=15)),
}


@pytest.mark.parametrize("case", sorted(FOLLOW_CASES))
def test_orb_back_half_follows_reference(case):
    hw, speed, n_frames, scene_seed, cfg = FOLLOW_CASES[case]
    K, frames, _T = _corridor_bgr(hw, speed, n_frames, scene_seed)
    for i, ref, follow, gap, _lm in _follow_run(K, hw, frames, **cfg):
        assert follow.frame_ids == ref.frame_ids, i
        assert len(follow.world_map) == len(ref.world_map), i
        assert [k.frame_idx for k in follow.kfs] == \
            [k.frame_idx for k in ref.kfs], i
        assert gap < FOLLOW_POSE_TOL, (i, gap)
    assert follow.frame_ids == list(range(n_frames))
    assert follow.tracking_lost_count == ref.tracking_lost_count
    if n_frames > 4:
        assert len(ref.kfs) >= 4 and follow.local_ba_solves >= 2


def _witness_run(K, hw, frames, eps, **cfg):
    """The reference against itself, the second copy's landmarks moved by
    a uniform draw in [-eps, eps] per coordinate right after it
    bootstraps: yields what :func:`_follow_run` yields."""
    a = JSystem(JConfig(**cfg), K, None, img_hw=hw)
    b = JSystem(JConfig(**cfg), K, None, img_hw=hw)
    rng = np.random.default_rng(0)
    prev_a = prev_b = None
    moved = False
    for i, img in enumerate(frames):
        prev_a = a.process_frame(i, img, prev_a)
        prev_b = b.process_frame(i, img, prev_b)
        if b.initialised and not moved:
            rows = [b.world_map._row[p] for p in b.world_map.points]
            b.world_map._positions[rows] += rng.uniform(-eps, eps,
                                                        (len(rows), 3))
            moved = True
        yield (i, a, b) + _gaps(a, b)


if __name__ == "__main__":
    # The follow run on another corridor, frame by frame, with the PnP
    # inlier counts of each frame's tracking and each track's ground-truth
    # error (reference / port):
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_orb.py \
    #       --hw 180 410 --speed 0.5 --frames 18 --scene_seed 3 \
    #       --kf_min_inliers 40 --pnp_min_inliers 15   # test_e2e's fixture
    # With --witness EPS, the reference against itself with its bootstrap
    # landmarks moved by up to EPS instead of against the port.
    import argparse
    import simpleslam_tpu.ops.pnp as jpnp
    from simpleslam_tpu_torch.core.trajectory_utils import umeyama_sim3
    from simpleslam_tpu_torch.ops import pnp as ppnp
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, nargs=2, default=[240, 640])
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--scene_seed", type=int, default=0)
    ap.add_argument("--max_features", type=int, default=512)
    ap.add_argument("--kf_min_inliers", type=float, default=150.0)
    ap.add_argument("--pnp_min_inliers", type=int, default=30)
    ap.add_argument("--witness", type=float, default=None)
    a = ap.parse_args()
    hw = tuple(a.hw)
    K, frames, T_wc = _corridor_bgr(hw, a.speed, a.frames, a.scene_seed)
    cfg = dict(max_features=a.max_features, kf_min_inliers=a.kf_min_inliers,
               pnp_min_inliers=a.pnp_min_inliers)
    n_inl = []

    def recording(solve):
        def wrapped(*args, **kw):
            out = solve(*args, **kw)
            n_inl.append(int(out[2]))
            return out
        return wrapped

    jpnp.solve_pnp_ransac = recording(jpnp.solve_pnp_ransac)
    ppnp.solve_pnp_ransac = recording(ppnp.solve_pnp_ransac)
    runs = (_follow_run(K, hw, frames, **cfg) if a.witness is None
            else _witness_run(K, hw, frames, a.witness, **cfg))
    def gt_error(system):
        """The newest frame's centre, Sim(3)-aligned to the ground truth
        over the frames posed so far, against its ground truth."""
        P = system.world_map.poses
        if len(P) < 3:
            return float("nan")
        C = np.stack([-np.asarray(T)[:3, :3].T @ np.asarray(T)[:3, 3]
                      for T in P])
        G = np.stack([T_wc[f][:3, 3] for f in system.frame_ids[:len(P)]])
        s_, R, t = umeyama_sim3(C, G)
        return float(np.linalg.norm(s_ * C[-1] @ R.T + t - G[-1]))

    for i, ref, other, gap, lm_gap in runs:
        print(f"frame {i}: pose gap {gap:.3e}, landmark gap {lm_gap:.3e}, "
              f"PnP inliers {n_inl}, ground-truth error "
              f"{gt_error(ref):.3f} / {gt_error(other):.3f}, "
              f"map {len(ref.world_map)} / {len(other.world_map)}, "
              f"frame ids equal {ref.frame_ids == other.frame_ids}, "
              f"keyframes {[k.frame_idx for k in ref.kfs]} / "
              f"{[k.frame_idx for k in other.kfs]}", flush=True)
        n_inl.clear()
