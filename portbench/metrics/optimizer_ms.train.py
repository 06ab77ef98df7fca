"""Device ms a step of AdamW over the flat parameters
(``AdamWChain.update_``): the stream's time inside the program's
``train.optimizer`` span."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "optimizer_ms.train", "ms", "program_span"
LAYER = "models/train.py: AdamWChain.update_"
MOVES = "train_pairs_per_s"


def read(run):
    return per_call_ms(run, "train.optimizer", "device")
