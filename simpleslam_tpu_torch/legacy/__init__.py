"""The legacy pipeline variants over the port's ops (the counterpart of
``simpleslam_tpu/legacy``):

  * :mod:`run_ef`  -- per-frame E-vs-H 2D-2D tracking with the
    median-parallax rotation-only heuristic;
  * :mod:`run_klt` -- pyramidal KLT tracking with forward-backward gating
    and re-seeding from fresh keypoints.
"""
