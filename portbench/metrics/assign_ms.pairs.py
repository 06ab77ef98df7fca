"""Device ms a call of the matches drawn from the assignment
(``match_batch``'s per-pair ``matches_from_assignment`` loop and
``Matches.stack``): the stream's time inside the program's
``lightglue.assign`` span."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "assign_ms.pairs", "ms", "program_span"
LAYER = "models/lightglue.py: match_batch assignment"
MOVES = "pairs_per_s"


def read(run):
    return per_call_ms(run, "lightglue.assign", "device")
