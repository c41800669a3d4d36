"""Whole runs of the harness rehearsed on the CPU at the configurations'
micro sizes (``--rehearse DIR``): the result line's shape, and ``correct``
false under each fault that a cell can have (zkbench/control.py).  Slow:
each run proves two MICRO rounds in pure Python (minutes)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345


def run(tmp_path, *argv, module="zkbench.run"):
    res = subprocess.run([sys.executable, "-m", module, *argv, "--seed", str(SEED),
                          "--seconds", "0.1", "--rehearse", str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=3000)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    return line, res.stderr


@pytest.mark.slow
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_line(tmp_path, trace):
    line, err = run(tmp_path, "--workload", "reference.round_b1", "--trace", str(trace))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"] is True, err[-3000:]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    names = set(line["metrics"])
    if trace:
        assert {"witness_ms", "assembly_ms", "verify_ms"} <= names
        assert not names & {"point_kernel_roofline", "field_kernel_roofline", "msm_glue_share",
                            "launches_per_round"}  # no device metric from the CPU
    else:
        assert {"round_s", "setup_s"} <= names
    assert err.rstrip().splitlines()[-1].startswith("check proofs_verified")


@pytest.mark.slow
@pytest.mark.parametrize("fault,failing", [
    ("proof_altered", "rounds_failed"),
    ("proof_unchecked", "proofs_rejected"),
    ("half_batch", "aggregate_wrong"),
    ("model_unchanged", "aggregate_wrong"),
])
def test_fault_turns_correct_false(tmp_path, fault, failing):
    line, err = run(tmp_path, "--fault", fault, "--workload", "reference.round_b1",
                    module="zkbench.control")
    assert line["correct"] is False, err[-3000:]
    assert line["checks"][failing]["value"] > line["checks"][failing]["limit"]


@pytest.mark.slow
def test_prod_rehearsal_and_its_control(tmp_path):
    line, err = run(tmp_path, "--workload", "prod128.round", "--trace", "0")
    assert line["correct"] is True, err[-3000:]
    line, err = run(tmp_path, "--fault", "proof_unchecked", "--workload", "prod128.round",
                    module="zkbench.control")
    assert line["correct"] is False and line["checks"]["proofs_rejected"]["value"] >= 1
