"""The training step's model operations (forward products, the backward
counted as twice the forward) over the traced window's seconds, as a share
of the card's bfloat16 dense peak."""
from portbench.metrics._common import mfu_pct

NAME, UNIT, SOURCE = "mfu.train", "%", "device_trace"
LAYER = "the whole step: models/train.py make_train_step"
MOVES = "train_pairs_per_s"


def read(run):
    return mfu_pct(run)
