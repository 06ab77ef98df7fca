"""Device ms a call of ``match_batch`` (LightGlue's forward over the call's
pairs and the mutual-argmax assignment): the union of the device
operations launched inside the benchmark's ``match`` range."""
from portbench.metrics._common import range_ms

NAME, UNIT, SOURCE = "match_ms.pairs", "ms", "device_trace"
LAYER = "models/lightglue.py"
MOVES = "pairs_per_s"


def read(run):
    return range_ms(run, "match")
