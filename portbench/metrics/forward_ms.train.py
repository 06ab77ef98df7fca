"""Device ms a step of the loss (two ALIKED forwards, LightGlue and the
terms): the stream's time inside the program's ``train.forward`` span."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "forward_ms.train", "ms", "program_span"
LAYER = "models/train.py: loss_fn"
MOVES = "train_pairs_per_s"


def read(run):
    return per_call_ms(run, "train.forward", "device")
