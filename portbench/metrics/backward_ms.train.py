"""Device ms a step of the gradient (``torch.autograd.grad`` and the
flat ``torch.cat``): the stream's time inside the program's
``train.backward`` span."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "backward_ms.train", "ms", "program_span"
LAYER = "models/train.py: autograd.grad + cat"
MOVES = "train_pairs_per_s"


def read(run):
    return per_call_ms(run, "train.backward", "device")
