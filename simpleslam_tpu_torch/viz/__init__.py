"""Host-side visualisation (the counterpart of ``simpleslam_tpu/viz``):
only the 2-D trajectory plot is ported; matplotlib is imported when it
draws."""
from .trajectory2d import Trajectory2D  # noqa: F401
