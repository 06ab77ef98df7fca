"""Host-side visualisation (the counterpart of ``simpleslam_tpu/viz``):
the 2-D trajectory plot, the pause/step UI, the feature-track overlay and
the optional 3-D map view; matplotlib, cv2 and open3d are imported when
they are used."""
from .trajectory2d import Trajectory2D  # noqa: F401
from .ui import VizUI  # noqa: F401
from .tracks import draw_tracks  # noqa: F401
from .viz3d import Visualizer3D  # noqa: F401
