"""``run.py`` as a command. On the card each cell runs briefly
and comes out correct (``card``); without a card the command prints no
result and exits with 2."""
import json
import os
import subprocess
import sys

import pytest

from yardstick import spec

RUN = os.path.join(spec.HERE, "run.py")
CELLS = [w["name"] for w in spec.benchmark()["workloads"] + spec.held()]


def _run(workload, seed, seconds, trace=0):
    return subprocess.run(
        [sys.executable, RUN, "--workload", workload, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=spec.ROOT)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload, card):
    out = _run(workload, 2_147_483_659, 2)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


def test_without_a_card_no_result_and_exit_2():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(CELLS[0], 1, 1)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
