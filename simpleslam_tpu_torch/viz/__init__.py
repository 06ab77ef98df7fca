"""Host-side visualisation (the counterpart of ``simpleslam_tpu/viz``):
the 2-D trajectory plot and the feature-track overlay; matplotlib and cv2
are imported when they draw."""
from .tracks import draw_tracks  # noqa: F401
from .trajectory2d import Trajectory2D  # noqa: F401
