"""Feature front-end facade (the counterpart of
``simpleslam_tpu/core/frontend.py``): one API over the classical ORB
front-end (``ops/features.py`` + the brute-force matcher of
``ops/matching.py``), SIFT's float descriptors (``ops/features_sift.py``)
and AKAZE's binary ones (``ops/features_akaze.py``) with the same
matcher, and the learned one (ALIKED keypoints + LightGlue matching).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.ops import epipolar
from simpleslam_tpu_torch.ops.features import (orb_detect_and_describe,
                                               rgb_to_gray)
from simpleslam_tpu_torch.ops.matching import bf_match
from simpleslam_tpu_torch.utils.device import resolve_device
from simpleslam_tpu_torch.utils.rng import TorchKey


@dataclass
class Detector:
    fn: Callable                  # (H, W) float grey on ``device`` -> Features
    device: torch.device


@dataclass
class Matcher:
    fn: Callable                  # (Features, Features) -> Matches
    # the same matches unsorted, for the fused step (nothing downstream
    # depends on their order)
    fn_fast: Callable


def init_feature_pipeline(args, device=None,
                          weights: Optional[Tuple[Mapping, Mapping]] = None):
    """Build (detector, matcher) from the config. ``--use_lightglue`` (or
    ``detector='aliked'``) selects ALIKED + LightGlue; ``weights`` is an
    optional (aliked_state_dict, lightglue_state_dict) pair; otherwise the
    models restore the trained tree (``models/pipeline.py``). ``orb`` is
    ORB, ``sift`` SIFT and ``akaze`` AKAZE, each with cross-checked
    brute-force matching (Hamming or L2 by the descriptors' dtype), for
    ``--matcher bf`` and ``flann`` alike."""
    max_kp = int(getattr(args, "max_features", 4000))
    n_pad = ((max_kp + 127) // 128) * 128
    use_lg = bool(getattr(args, "use_lightglue", False)) or \
        getattr(args, "detector", "orb") == "aliked"
    if use_lg:
        from simpleslam_tpu_torch.models.pipeline import (
            build_learned_extractor, build_learned_matcher)
        a_sd, l_sd = weights if weights is not None else (None, None)
        det = build_learned_extractor(args, n_pad, device=device,
                                      state_dict=a_sd)
        return det, build_learned_matcher(args, det, state_dict=l_sd)

    name = getattr(args, "detector", "orb")
    if name == "sift":
        from simpleslam_tpu_torch.ops.features_sift import \
            sift_detect_and_describe

        def detect(img_gray: torch.Tensor) -> Features:
            return sift_detect_and_describe(img_gray, max_kp=n_pad)
    elif name == "akaze":
        from simpleslam_tpu_torch.ops.features_akaze import \
            akaze_detect_and_describe

        def detect(img_gray: torch.Tensor) -> Features:
            return akaze_detect_and_describe(img_gray, max_kp=n_pad)
    else:
        def detect(img_gray: torch.Tensor) -> Features:
            return orb_detect_and_describe(img_gray, max_kp=n_pad,
                                           fast_thresh=20.0)

    def match(f0: Features, f1: Features) -> Matches:
        return bf_match(f0, f1, cross_check=True)

    def match_fast(f0: Features, f1: Features) -> Matches:
        return bf_match(f0, f1, cross_check=True, sort=False)

    return (Detector(fn=detect, device=resolve_device(device)),
            Matcher(fn=match, fn_fast=match_fast))


def feature_extractor(args, img, detector) -> Features:
    """Padded features of a BGR or grey uint8 frame (host array or tensor),
    extracted on the detector's device."""
    img = torch.as_tensor(np.asarray(img) if not torch.is_tensor(img)
                          else img, device=detector.device)
    gray = rgb_to_gray(img) if img.dim() == 3 else img.float()
    return detector.fn(gray)


def feature_matcher(args, feats0: Features, feats1: Features,
                    matcher) -> Matches:
    """Match two padded feature sets (the matcher gates at min_conf)."""
    return matcher.fn(feats0, feats1)


def filter_matches_ransac(feats0: Features, feats1: Features,
                          matches: Matches, thresh: float, key=None,
                          n_hyp: int = 256) -> Matches:
    """F-RANSAC geometric filter; fewer than 8 valid matches pass through
    unfiltered (the reference's quirk)."""
    if key is None:
        key = TorchKey(0)
    if int(matches.valid.sum()) < 8:
        return matches
    p0 = feats0.kpts[matches.idx0]
    p1 = feats1.kpts[matches.idx1]
    _F, inl, ok = epipolar.find_fundamental(key, p0, p1, matches.valid,
                                            float(thresh), n_hyp=n_hyp)
    if not bool(ok):
        return matches
    return Matches(idx0=matches.idx0, idx1=matches.idx1, score=matches.score,
                   valid=matches.valid & inl)


def match_with_ransac(args, matcher, feats0: Features, feats1: Features,
                      key=None) -> Matches:
    """feature_matcher + filter_matches_ransac in one call."""
    m = feature_matcher(args, feats0, feats1, matcher)
    return filter_matches_ransac(feats0, feats1, m,
                                 getattr(args, "ransac_thresh", 2.5), key=key)


def detect_and_match(args, img0, img1, detector, matcher,
                     ransac: bool = True, key=None):
    """Detect on both frames and match them -> (feats0, feats1, matches)."""
    f0 = feature_extractor(args, img0, detector)
    f1 = feature_extractor(args, img1, detector)
    if ransac:
        m = match_with_ransac(args, matcher, f0, f1, key=key)
    else:
        m = feature_matcher(args, f0, f1, matcher)
    return f0, f1, m
