"""Configuration: the port's own copy of the part of
``simpleslam_tpu/config.py`` that the ported slice reads.

Each field and flag keeps the reference's name and default, so a launch
command that sets only these flags configures either package (the README's
and ``bench.py``'s argv included). ``headless``, ``no_viz3d`` and
``loop_closure`` are parsed for that reason; viz and loop closure wait in
the roadmap (``run_slam.run`` raises without ``--headless`` or with
``--loop_closure``). Flags of the other paths not yet ported (global BA,
resume and save of the state, localisation-only mode, the fused
loop-closure rescue ``--fused_rescue_after``, the keyframe thumbnails'
``--kf_thumb_hw``, and ``--fps``, which nothing in the reference reads
either) are absent: the parser rejects them rather than ignore them. ``--matcher`` is parsed and has no
effect: ``bf`` and ``flann`` are both the brute-force matcher, as in the
reference. ``--device`` (the port's own) chooses
where ``run_slam.main`` runs; it is no config field. ``yaml`` is imported
only when a YAML file is read.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class SLAMConfig:
    # dataset
    dataset: str = "kitti"                 # kitti | malaga | tum-rgbd | custom
    base_dir: str = "../Dataset"

    # front-end (reference defaults: main_revamped.py:200-208)
    detector: str = "orb"                  # orb | aliked (sift, akaze raise)
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

    # local BA
    local_ba_window: int = 10
    local_ba_min_new_points: int = 60
    local_ba_max_points: int = 5000
    local_ba_max_iters: int = 12
    ba_huber: float = 2.0                  # ba_utils.py:236

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
    loop_closure: bool = False             # loop closure (not ported yet)
    prefetch: int = 1                      # threaded frame prefetch depth
    stage_all: bool = False                # fused mode: decode and upload
                                           # every frame before the loop

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
                 "stage_all"):
        p.add_argument(f"--{flag}", action="store_true")
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
    for f in dataclasses.fields(SLAMConfig):
        if f.type in ("int", "float"):
            p.add_argument(f"--{f.name}", type=int if f.type == "int"
                           else float, default=getattr(d, f.name))
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
