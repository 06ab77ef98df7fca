"""Configuration: the port's own copy of the part of
``simpleslam_tpu/config.py`` that the ported slice reads.

Each field and flag keeps the reference's name and default, so a launch
command that sets only these flags configures either package (the README's
and ``bench.py``'s argv included). ``--headless`` turns off the live windows
and ``--no_viz3d`` the 3-D viewer; ``--viz_ba`` logs (and, in a live run,
shows) the before/after local-BA reprojection overlays. Global BA (``gba_*``), loop closure (``loop_*``),
the fused loop's rescue (``--fused_rescue_after``), saved and resumed
state (``--save_state``, ``--resume``), localisation-only mode
(``--localize_only``) and the keyframe thumbnails' ``--kf_thumb_hw`` are
ported. ``--merge_radius`` parses as in the reference, where no driver
reads it either (``ops/triangulation.py::MultiViewTriangulator`` takes its
own radius). So do ``--mesh_devices`` and ``--trace_dir``: the
reference's ``run_slam`` reads neither (it imports ``jax_trace`` and never
calls it); ``parallel/mesh.py::make_mesh`` and
``utils/profiling.py::torch_trace`` take them from a caller. The TPU
package's padding and precision knobs and ``--fps``, which nothing in the
reference reads, are absent: the parser rejects them rather than ignore
them. ``--matcher`` is
parsed and has no effect: ``bf`` and ``flann`` are both the brute-force
matcher, as in the reference. ``--device`` (the port's own) chooses
where ``run_slam.main`` runs; it is no config field. ``yaml`` is imported
only when a YAML file is read.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SLAMConfig:
    # dataset
    dataset: str = "kitti"                 # kitti | malaga | tum-rgbd | custom
    base_dir: str = "../Dataset"

    # front-end (reference defaults: main_revamped.py:200-208)
    detector: str = "orb"                  # orb | sift | akaze | aliked
    matcher: str = "bf"                    # bf | flann: no effect, both
                                           # are the brute-force matcher
    use_lightglue: bool = False
    min_conf: float = 0.7
    max_features: int = 4000

    # RANSAC
    ransac_thresh: float = 2.5

    # keyframe policy (reference: keyframe_utils.py:42-96)
    kf_max_disp: float = 45.0
    kf_min_inliers: float = 150.0
    kf_min_ratio: float = 0.35
    kf_min_rot_deg: float = 8.0
    kf_cooldown: int = 5
    kf_thumb_hw: List[int] = field(default_factory=lambda: [640, 360])

    # visualization
    no_viz3d: bool = False
    headless: bool = False

    # triangulation depth gates
    min_depth: float = 0.40
    max_depth: float = 100.0
    mvt_rep_err: float = 2.0

    # PnP / map maintenance
    pnp_min_inliers: int = 30
    proj_radius: float = 10.0
    assoc_wide_factor: float = 2.5         # on PnP failure, retry association
                                           # with proj_radius * this; <= 1
                                           # disables
    merge_radius: float = 0.10             # landmark fusion radius (the
                                           # multi-view triangulator's)

    # local BA
    local_ba_window: int = 10
    local_ba_min_new_points: int = 60
    local_ba_max_points: int = 5000
    local_ba_max_iters: int = 12
    ba_huber: float = 2.0                  # ba_utils.py:236

    # global BA: off by default as in the reference; --gba_enable runs it
    # at the gba_every keyframe milestone and after accepted loop closures
    gba_every: int = 100
    gba_max_points: Optional[int] = None
    gba_max_iters: int = 30
    gba_fix_first: int = 1
    gba_enable: bool = False
    # pure localisation against a map loaded with --resume: the map is
    # frozen (no keyframes, triangulation, BA or descriptor-ring updates)
    # and the first pose comes from kidnapped-robot global relocalisation
    localize_only: bool = False

    # hard-coded reference constants surfaced as config
    bootstrap_min_posdepth: float = 0.90   # main_revamped.py:358-362
    bootstrap_min_parallax_deg: float = 0.5
    bootstrap_score_ratio_h: float = 0.45
    bootstrap_refresh_min_matches: int = 80   # main_revamped.py:350
    bootstrap_refresh_max_age: int = 30
    triangulation_parallax_min_deg: float = 2.0  # main_revamped.py:567
    match_max_hamm: int = 64               # main_revamped.py:464
    match_max_l2: float = 0.8              # pnp_utils.py:232

    # extensions of the JAX package (no reference equivalent)
    map_capacity: int = 32768              # padded landmark-snapshot size
    ransac_hypotheses: int = 256           # batched hypotheses per model
    seed: int = 0
    tri_kf2: bool = False                  # triangulate new KFs vs the last
                                           # TWO KFs (2x baseline)
    reloc: bool = True                     # KF 2D-3D relocalization on PnP
                                           # failure
    loop_grid: int = 4                     # G x G place-vector pooling grid
    global_reloc: bool = True              # after sustained loss, PnP against
                                           # place-vector candidates over ALL
                                           # keyframes
    global_reloc_after: int = 3            # consecutive lost frames first
    global_reloc_topk: int = 3             # place candidates to PnP-verify
    global_reloc_min_sim: float = 0.30     # place-vector cosine gate

    # the fused device loop (core/fused.py, run_slam.run_fused_loop)
    fused: bool = False                    # run_slam.run: the fused loop
                                           # after the host bootstrap
    fused_sync_every: int = 0              # 0 => sync the host map at the end
    fused_ba_points: int = 0               # fused-loop BA window point slice
                                           # (0 => 4096)
    map_evict_age: int = 50                # fused map: evict landmarks unseen
                                           # this many frames near capacity
    # loop closure + Sim(3) pose-graph optimisation (core/loop.py)
    loop_closure: bool = False             # enable loop detection + Sim3 PGO
    loop_min_sim: float = 0.70             # pooled-descriptor cosine gate
    loop_gap_kfs: int = 15                 # skip the most recent N keyframes
    loop_min_inliers: int = 25             # Sim3-RANSAC inlier acceptance gate
    loop_ransac_thresh: float = 0.10       # RANSAC threshold as a fraction of
                                           # the median scene depth
    loop_max_scale: float = 16.0           # reject if s or 1/s exceeds this
    loop_weight: float = 4.0               # loop-edge weight in the pose graph
    loop_topk: int = 2                     # candidates to geometric-verify
    loop_pgo_iters: int = 25               # LM iterations for the pose graph
    loop_min_inlier_frac: float = 0.03     # inlier floor as a fraction of the
                                           # current KF's valid keypoints
    loop_confirm: int = 2                  # odometry-consistent verifications
                                           # before a closure is applied
    loop_confirm_window: int = 12          # a pending verification expires
                                           # after this many keyframes
    loop_confirm_strong: float = 0.35      # inlier coverage that applies a
                                           # closure at once
    fused_rescue_after: int = 24           # fused loop-closure mode: host
                                           # global reloc after this many lost
                                           # frames (0 disables)
    loop_drift_frac_max: float = 0.6       # reject a closure whose correction
                                           # exceeds this fraction of the
                                           # cand->cur arc length (0 disables)
    prefetch: int = 1                      # threaded frame prefetch depth
    stage_all: bool = False                # fused mode: decode and upload
                                           # every frame before the loop
    save_state: str = ""                   # serialize pipeline state here at
                                           # the end (and on SIGINT)
    resume: str = ""                       # resume pipeline state from this
                                           # file
    viz_ba: bool = False                   # before/after local-BA
                                           # reprojection overlays
    # parsed only: run_slam reads neither, as in the reference
    mesh_devices: int = 0                  # 0 => every rank of the group
    trace_dir: str = ""                    # torch.profiler trace output dir

    @classmethod
    def from_yaml(cls, path: str) -> "SLAMConfig":
        yaml = importlib.import_module("yaml")
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
        return cls(**raw)


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags for the fields above, same names and
    defaults."""
    p = argparse.ArgumentParser("simpleslam_tpu_torch")
    d = SLAMConfig()
    p.add_argument("--config", default=None, help="YAML config file")
    p.add_argument("--dataset", choices=["kitti", "malaga", "tum-rgbd",
                                         "custom"], default=d.dataset)
    p.add_argument("--base_dir", default=d.base_dir)
    for flag in ("no_viz3d", "headless", "loop_closure", "fused",
                 "stage_all", "gba_enable"):
        p.add_argument(f"--{flag}", action="store_true")
    p.add_argument("--viz_ba", action="store_true",
                   help="Show before/after-BA reprojection overlay windows")
    p.add_argument("--detector", choices=["orb", "sift", "akaze", "aliked"],
                   default=d.detector)
    p.add_argument("--matcher", choices=["bf", "flann"], default=d.matcher,
                   help="no effect: both are the brute-force matcher, as "
                        "in the reference")
    p.add_argument("--device", default=None,
                   help="where run_slam.main runs (default: the GPU; "
                        "'cpu' for the CPU)")
    p.add_argument("--use_lightglue", action="store_true")
    p.add_argument("--no_reloc", dest="reloc", action="store_false")
    p.add_argument("--no_global_reloc", dest="global_reloc",
                   action="store_false")
    p.add_argument("--tri_kf2", action="store_true")
    p.add_argument("--kf_thumb_hw", type=int, nargs=2,
                   default=list(d.kf_thumb_hw))
    p.add_argument("--localize_only", action="store_true",
                   help="Pure localization against the map loaded with "
                        "--resume: the map is frozen (no new keyframes, "
                        "triangulation, BA, loop closure or descriptor-ring "
                        "updates); the first pose comes from kidnapped-robot "
                        "global relocalization, then PnP tracking")
    p.add_argument("--save_state", default=d.save_state,
                   help="Serialize pipeline state to this file at end of run "
                        "(and on SIGINT)")
    p.add_argument("--resume", default=d.resume,
                   help="Resume pipeline state from a --save_state file")
    p.add_argument("--trace_dir", default=d.trace_dir,
                   help="Directory for a torch.profiler trace "
                        "(utils/profiling.py::torch_trace)")
    for f in dataclasses.fields(SLAMConfig):
        if f.type in ("int", "float", "Optional[int]"):
            p.add_argument(f"--{f.name}", type=float if f.type == "float"
                           else int, default=getattr(d, f.name))
    return p


def parse_config(argv: Optional[List[str]] = None) -> SLAMConfig:
    """CLI flags -> SLAMConfig. With ``--config`` the YAML file is read and
    checked for unknown keys, and then every flag value overrides it,
    defaults included: the reference's behaviour (ROADMAP queue C)."""
    args = build_parser().parse_args(argv)
    kw = {f.name: getattr(args, f.name) for f in dataclasses.fields(SLAMConfig)}
    if args.config:
        return dataclasses.replace(SLAMConfig.from_yaml(args.config), **kw)
    return SLAMConfig(**kw)
