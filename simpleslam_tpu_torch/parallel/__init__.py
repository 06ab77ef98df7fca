"""Process-group parallelism: sharded batched extraction and matching, the
sharded BA solve and the (dp, tp) training step over a ``DeviceMesh``
(the counterpart of ``simpleslam_tpu/parallel/``)."""
from .mesh import make_mesh  # noqa: F401
from .batch import sharded_extract_and_match  # noqa: F401
