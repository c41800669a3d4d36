"""On a card only (``-m gpu``; each test skips without one): a short run
of each cell is correct, and the control, every proof altered with the
program's verification passing, is not."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def run(*argv, module="zkbench.run"):
    res = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=1500)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cuda, cell):
    line = run("--workload", cell, "--seed", "2147483901", "--seconds", "3", "--trace", "0")
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda, cell):
    line = run("--fault", "proof_unchecked", "--workload", cell, "--seed", "2147483902",
               "--seconds", "3", module="zkbench.control")
    assert line["correct"] is False and line["checks"]["proofs_rejected"]["value"] >= 1
