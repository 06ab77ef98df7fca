"""The share of the traced calls' window (host clock, first call's start
to the last one's synchronise) in which no device operation ran."""
from portbench.metrics._common import idle_pct

NAME, UNIT, SOURCE = "idle_share.pairs", "%", "device_trace"
LAYER = "device"
MOVES = "pairs_per_s"


def read(run):
    return idle_pct(run)
