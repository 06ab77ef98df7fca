"""The whole call's model operations (ALIKED per frame, LightGlue per pair
at its valid keypoints, products only) over the traced window's seconds,
as a share of the card's bfloat16 dense peak: it bounds the kernels'
rooflines, whichever kernel is on the path."""
from portbench.metrics._common import mfu_pct

NAME, UNIT, SOURCE = "mfu.pairs", "%", "device_trace"
LAYER = "the whole call: extract_batch + match_batch"
MOVES = "pairs_per_s"


def read(run):
    return mfu_pct(run)
