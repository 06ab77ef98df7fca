"""Host ms a call spent launching DKD (``extract_batch``'s per-image
``dkd_extract`` loop and ``Features.stack``): the host clock across the
program's ``aliked.dkd`` span. Above ``dkd_ms.pairs`` where the host
paces DKD."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "dkd_host_ms.pairs", "ms", "program_span"
LAYER = "models/aliked.py: extract_batch DKD"
MOVES = "pairs_per_s"


def read(run):
    return per_call_ms(run, "aliked.dkd", "host")
