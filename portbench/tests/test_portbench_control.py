"""The control, on the card: the reference in the program's place one
precision step below the configuration's (float8 where it states
bfloat16, TF32 where it states float32), at each cell's own size, on
three seeds, must come out not correct. Prints the control's readings,
which set the limits' upper ends.

    python3 -m pytest -s -p no:cacheprovider \
        portbench/tests/test_portbench_control.py
"""
import io
import json

import pytest

from portbench import harness, run

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lightglue-kitti-2048.pairs-b32",
                                  "lightglue-train-2048.b16"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cuda, cell, seed):
    buf = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5"], files=harness.Files(), impl="control", out=buf)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"control {cell} seed {seed}: "
          f"{ {k: c['value'] for k, c in line['checks'].items()} }")
    assert rc == 0 and not line["correct"]
