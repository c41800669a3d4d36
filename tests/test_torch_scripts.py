"""The port's measuring scripts on the CPU at toy size:
zkfl_tpu_torch/scripts/scaling.py's circuits and witnesses against
zkfl_tpu's (the steps of the repository's scripts/scaling.py), a whole
point of the sweep proved and verified, and round8's result line against
scripts/round8.py's keys and arithmetic."""

import ast
import math
from pathlib import Path

import pytest
import torch

from zkfl_tpu.fl.client import Client as ZkClient
from zkfl_tpu.fl.client import SharedLCG as ZkLCG
from zkfl_tpu.fl.config import FLConfig as ZkFLConfig
from zkfl_tpu.r1cs.circuits import build_structure as zk_build
from zkfl_tpu.r1cs.circuits import generate_witness as zk_generate_witness
from zkfl_tpu_torch.r1cs.circuits import build_structure
from zkfl_tpu_torch.scripts import round8, scaling

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _zk_point(n):
    """scripts/scaling.py run_point's circuits and witnesses, on zkfl_tpu."""
    cfg = ZkFLConfig(n=n, depth=int(math.log2(n)), model_dim=4, batch_size=n)
    bal, tr = zk_build(cfg.balance_params), zk_build(cfg.training_params)
    client = ZkClient(1, cfg, None)
    client.generate_private_dataset(ZkLCG(cfg.seed))
    client.compute_dataset_commitment()
    sib, idx = client._merkle_paths(cfg.n)
    inputs = {
        "client_id": 1, "root": client.root_d, "N_public": cfg.n,
        "c0": client.c0, "c1": client.c1,
        "features": client.features, "labels": client.labels,
        "siblings": sib, "pathIndices": idx,
    }
    bal_wit = zk_generate_witness(cfg.balance_params, inputs).witness
    return bal, tr, bal_wit, client.training_witness([0] * cfg.model_dim)


@pytest.mark.parametrize("n", [2, 4])
def test_scaling_point_matches_zkfl_tpu(n, tmp_path):
    cfg = scaling.point_config(n, str(tmp_path))
    bal, tr = build_structure(cfg.balance_params), build_structure(cfg.training_params)
    zk_bal, zk_tr, zk_bal_wit, zk_tr_wit = _zk_point(n)
    for ours, theirs in ((bal, zk_bal), (tr, zk_tr)):
        assert ours.name == theirs.name
        assert (len(ours.constraints), ours.n_wires) == (len(theirs.constraints), theirs.n_wires)
    bal_wit, tr_wit = scaling.point_witnesses(cfg)
    assert [int(v) for v in bal_wit] == [int(v) for v in zk_bal_wit]
    assert [int(v) for v in tr_wit] == [int(v) for v in zk_tr_wit]
    assert len(bal_wit) == bal.n_wires and len(tr_wit) == tr.n_wires


@pytest.mark.parametrize("n", [0, 3, 12])
def test_scaling_rejects_n_not_a_power_of_two(n, tmp_path):
    with pytest.raises(ValueError, match="power of two"):
        scaling.point_config(n, str(tmp_path))


def _check_point(p, n):
    assert p["n"] == n and p["constraints"] > 0 and p["baseline_s"] is None
    assert p["prove_s"] > 0 and p["prove_first_s"] > 0 and "vs_baseline" not in p


def test_scaling_run_point_on_host_engine(tmp_path):
    """N=2 on HostEngine (natural domains, the pure-Python ladder, about
    50 s here): both proofs of both pairs verify (run_point raises
    otherwise), and both setups went to the cache."""
    _check_point(scaling.run_point(2, str(tmp_path), None), 2)
    assert len(list(tmp_path.glob("*.torch.zkey.pkl"))) == 2


@pytest.mark.slow
def test_scaling_run_point_on_torch_engine_cpu(tmp_path):
    """N=2 on TorchEngine(cpu): the fused pipeline's plain versions and the
    setups' fixed-base batches on the CPU (about 24 min here)."""
    _check_point(scaling.run_point(2, str(tmp_path), torch.device("cpu")), 2)


def _result_keys(path: Path) -> list:
    """The keys of the dict literal assigned to ``result`` in the file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and \
                any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no result dict in {path}")


def test_round8_result_follows_scripts_round8():
    timings = {"setup": 0.5, "datasets": 0.01, "commitments": 0.013, "balance_proofs": 2.771,
               "training_proofs": 2.883, "secagg_proofs": 3.157, "aggregate": 0.002,
               "total": 9.336}
    res = round8.round_result(timings, 8)
    assert list(res) == _result_keys(REPO / "scripts" / "round8.py")
    # scripts/round8.py:46-59
    per_client = (timings["balance_proofs"] + timings["training_proofs"]
                  + timings["secagg_proofs"]) / 8
    assert res["num_clients"] == 8 and res["proofs"] == 24
    assert res["round_s"] == timings["total"]
    assert res["prove_per_client_s"] == pytest.approx(per_client)
    assert res["prove_per_client_vs_baseline"] == pytest.approx(14.1 / per_client)
    assert (res["baseline_3client_round_s"], res["baseline_prove_per_client_s"]) == (43.0, 14.1)
    assert res["phases_s"] == timings
