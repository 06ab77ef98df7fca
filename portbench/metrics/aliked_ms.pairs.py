"""Device ms a call of ALIKED's batched forward (backbone and heads over
the call's frames): the stream's time inside the program's
``aliked.forward`` span."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "aliked_ms.pairs", "ms", "program_span"
LAYER = "models/aliked.py: ALIKED.forward"
MOVES = "pairs_per_s"


def read(run):
    return per_call_ms(run, "aliked.forward", "device")
