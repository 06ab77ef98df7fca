"""Host ms a call spent launching the per-pair assignment
(``match_batch``'s ``matches_from_assignment`` loop and
``Matches.stack``): the host clock across the program's
``lightglue.assign`` span."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "assign_host_ms.pairs", "ms", "program_span"
LAYER = "models/lightglue.py: match_batch assignment"
MOVES = "pairs_per_s"


def read(run):
    return per_call_ms(run, "lightglue.assign", "host")
