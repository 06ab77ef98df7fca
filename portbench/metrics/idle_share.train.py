"""The share of the traced steps' window (host clock) in which no device
operation ran."""
from portbench.metrics._common import idle_pct

NAME, UNIT, SOURCE = "idle_share.train", "%", "device_trace"
LAYER = "device"
MOVES = "train_pairs_per_s"


def read(run):
    return idle_pct(run)
