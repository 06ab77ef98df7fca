"""Device ms a call of DKD over the call's frames (``extract_batch``'s
per-image ``dkd_extract`` loop and ``Features.stack``): the stream's time
inside the program's ``aliked.dkd`` span, busy and waiting for the host's
launches."""
from portbench.metrics._spans import per_call_ms

NAME, UNIT, SOURCE = "dkd_ms.pairs", "ms", "program_span"
LAYER = "models/aliked.py: extract_batch DKD"
MOVES = "pairs_per_s"


def read(run):
    return per_call_ms(run, "aliked.dkd", "device")
