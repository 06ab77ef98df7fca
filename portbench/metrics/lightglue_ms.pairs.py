"""Device ms a call of LightGlue's batched forward (input projection, the
self and cross layers, the assignment matrix): the stream's time inside
the program's ``lightglue.forward`` span."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "lightglue_ms.pairs", "ms", "program_span"
LAYER = "models/lightglue.py: LightGlue.forward"
MOVES = "pairs_per_s"


def read(run):
    return per_call_ms(run, "lightglue.forward", "device")
