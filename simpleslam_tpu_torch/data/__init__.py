"""Host-side dataset layer: sequences, calibration, ground truth (the
counterpart of ``simpleslam_tpu/data``)."""
from .dataloader import (  # noqa: F401
    load_sequence,
    load_frame_pair,
    load_stereo_paths,
    load_calibration,
    load_groundtruth,
    Prefetcher,
    Sequence,
)
