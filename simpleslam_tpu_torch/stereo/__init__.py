"""Metric-scale stereo visual odometry (the counterpart of
``simpleslam_tpu/stereo``): block-matching disparity and PnP."""
from .tracker import StereoTracker  # noqa: F401
