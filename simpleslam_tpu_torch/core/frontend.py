"""Feature front-end facade (the counterpart of
``simpleslam_tpu/core/frontend.py``): the learned branch, ALIKED keypoints +
LightGlue matching. The classical front-ends (ORB, SIFT, AKAZE) wait for a
later slice.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from simpleslam_tpu_torch.core.types import Features, Matches
from simpleslam_tpu_torch.ops import epipolar
from simpleslam_tpu_torch.utils.rng import TorchKey


def init_feature_pipeline(args, device=None,
                          weights: Optional[Tuple[Mapping, Mapping]] = None):
    """Build (detector, matcher) from the config. ``--use_lightglue`` (or
    ``detector='aliked'``) selects ALIKED + LightGlue; ``weights`` is an
    optional (aliked_state_dict, lightglue_state_dict) pair, seeded
    weights otherwise."""
    use_lg = bool(getattr(args, "use_lightglue", False)) or \
        getattr(args, "detector", "orb") == "aliked"
    if not use_lg:
        raise NotImplementedError(
            f"detector {getattr(args, 'detector', 'orb')!r}: the classical "
            "front-ends are not ported yet; use --use_lightglue")
    from simpleslam_tpu_torch.models.pipeline import (build_learned_extractor,
                                                      build_learned_matcher)
    max_kp = int(getattr(args, "max_features", 4000))
    n_pad = ((max_kp + 127) // 128) * 128
    a_sd, l_sd = weights if weights is not None else (None, None)
    det = build_learned_extractor(args, n_pad, device=device, state_dict=a_sd)
    return det, build_learned_matcher(args, det, state_dict=l_sd)


def rgb_to_gray(img_bgr: torch.Tensor) -> torch.Tensor:
    """BGR (H, W, 3) -> float32 grey (ITU-R 601, like cv2)."""
    img = img_bgr.float()
    return 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]


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
