"""Device ms a call of ``extract_batch`` (ALIKED's forward and DKD over the
call's frames): the union of the device operations launched inside the
benchmark's ``extract`` range, from the profiler's trace."""
from portbench.metrics._common import range_ms

NAME, UNIT, SOURCE = "extract_ms.pairs", "ms", "device_trace"
LAYER = "models/aliked.py"
MOVES = "pairs_per_s"


def read(run):
    return range_ms(run, "extract")
