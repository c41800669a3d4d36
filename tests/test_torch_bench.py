"""The port's benchmark entry point (zkfl_tpu_torch/bench.py) and its cost
model (zkfl_tpu_torch/costs.py) on the CPU: the pinned costs, the run
without a card, the extras' key set against the repository's bench.py, the
headline witness against zkfl_tpu's, the repeated-base MSM check on the
plain versions, and a failing extra failing the run."""

import ast
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from zkfl_tpu.fl.client import Client as ZkClient
from zkfl_tpu.fl.client import SharedLCG as ZkLCG
from zkfl_tpu.fl.config import REFERENCE_CONFIG as ZK_REFERENCE
from zkfl_tpu.r1cs.circuits import generate_witness as zk_generate_witness
from zkfl_tpu_torch import bench, costs
from zkfl_tpu_torch.field.curve import G1_GEN, g2_generator
from zkfl_tpu_torch.fl.config import REFERENCE_CONFIG
from zkfl_tpu_torch.ops import point_kernels as pk
from zkfl_tpu_torch.ops.msm import msm_batch_g1, msm_batch_g2
from zkfl_tpu_torch.r1cs.circuits import generate_witness

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
# bench.py's extras that the port does not carry: the AOT ones (JAX only)
# and the three caught errors (an extra that raises fails the port's run).
NOT_PORTED = {"aot_loaded", "first_prove_breakdown", "round_error", "extras_error",
              "big_extras_error"}
BUDGET_ONLY = {"skipped_after", "full_round_is_warmup"}


def test_cost_model_pins():
    """The values chip_smoke.py's bounds were computed with before the
    cost model moved to costs.py."""
    assert costs.op_cost("fr.mont_mul") == (136, 96)
    assert costs.POINT_COST == {"g1.padd": (1632, 288), "g1.pdbl": (1032, 192),
                                "g2.padd": (4144, 576), "g2.pdbl": (2688, 384)}
    assert costs.poseidon_madds(3) == 65400
    assert costs.poseidon_madds(17) == 456416
    assert costs.int32_peak(1980) == 16_727_040_000_000.0
    assert costs.bound("g1.padd", 1 << 17, 1980) == pytest.approx((0.012788246097337006, "operations"))
    assert chip_smoke.bound is costs.bound


def test_no_card_exits_with_an_error():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "zkfl_tpu_torch.bench"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert time.time() - t0 < 60
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["value"] == -1.0 and "CUDA" in line["error"]
    assert "setups ready" not in res.stderr


def _extras_keys(path: Path) -> set:
    """The string keys of every subscript of an ``extras`` (a name or an
    attribute) in the file."""
    keys = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Subscript) and isinstance(node.slice, ast.Constant):
            v = node.value
            if (isinstance(v, ast.Name) and v.id == "extras") or \
                    (isinstance(v, ast.Attribute) and v.attr == "extras"):
                keys.add(node.slice.value)
    return keys


def test_extras_key_set_follows_bench_py():
    jax_keys = _extras_keys(REPO / "bench.py")
    port_keys = _extras_keys(REPO / "zkfl_tpu_torch" / "bench.py")
    assert NOT_PORTED <= jax_keys and BUDGET_ONLY <= jax_keys
    assert port_keys == (jax_keys - NOT_PORTED) | {"gpu"}
    assert set(bench.EXTRA_KEYS) == port_keys - BUDGET_ONLY
    assert len(bench.EXTRA_KEYS) == len(set(bench.EXTRA_KEYS))


def test_headline_witness_matches_zkfl_tpu():
    ours = generate_witness(REFERENCE_CONFIG.balance_params,
                            bench.balance_inputs(bench.canonical_client(REFERENCE_CONFIG))).witness
    # bench.py:128-140
    cfg = ZK_REFERENCE
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
    theirs = zk_generate_witness(cfg.balance_params, inputs).witness
    assert len(ours) == len(theirs) == 8566
    assert [int(v) for v in ours] == [int(v) for v in theirs]


def test_random_fr_is_canonical_and_seeded():
    from zkfl_tpu_torch.field.bn254 import FR
    from zkfl_tpu_torch.field.limbs import limbs_to_ints

    x = bench.random_fr(np.random.default_rng(3), 5000)
    assert x.shape == (8, 5000) and x.dtype == np.int32
    vals = limbs_to_ints(x)
    assert max(vals) < FR and max(vals).bit_length() == 254
    assert np.array_equal(x, bench.random_fr(np.random.default_rng(3), 5000))


def _off_by_generator(out, group):
    """out with a generator added to its first row."""
    out = out.clone()
    if group == "g1":
        gen = pk.g1_to_device([G1_GEN], CPU)[..., 0]
        out[..., 0] = pk.padd_plain(out[..., 0:1], gen[..., None])[..., 0]
    else:
        gen = pk.g2_to_device([g2_generator()], CPU)[..., 0]
        out[..., 0] = pk.padd_g2_plain(out[..., 0:1], gen[..., None])[..., 0]
    return out


@pytest.mark.parametrize("group,n,m", [("g1", 64, 2), ("g2", 8, 1)])
def test_repeated_base_check(group, n, m):
    """The rate MSMs' check accepts msm_batch_g1 / msm_batch_g2 (their plain
    versions here) and rejects a result off by one generator."""
    rng = np.random.default_rng(5)
    sc = torch.from_numpy(np.stack([bench.random_fr(rng, n) for _ in range(m)]))
    if group == "g1":
        bases = bench.g1_bases()
        pts = pk.g1_to_device([bases[i % len(bases)] for i in range(n)], CPU)
        out = msm_batch_g1(pts[:, :, None, :].expand(3, 8, m, n), sc)
    else:
        bases = bench.g2_bases()
        pts = pk.g2_to_device([bases[i % len(bases)] for i in range(n)], CPU)
        out = msm_batch_g2(pts[:, :, :, None, :], sc)
    bench.check_repeated_msm(group, out, bases, sc, group)
    with pytest.raises(AssertionError, match="row 0"):
        bench.check_repeated_msm(group, _off_by_generator(out, group), bases, sc, group)


def _run_main(monkeypatch, capsys, extras_round):
    """main(["--device", "cpu"]) with a stub prover and headline, and
    ``extras_round`` in place of the round; (rc, the JSON line)."""
    import zkfl_tpu_torch.fl.prover as fl_prover

    def headline(b, prover):
        b.result["value"] = 1.0

    monkeypatch.setattr(fl_prover, "RoundProver",
                        lambda cfg, engine: types.SimpleNamespace(cfg=cfg, engine=engine))
    monkeypatch.setattr(bench, "headline", headline)
    monkeypatch.setattr(bench, "extras_round", extras_round)
    monkeypatch.setattr(bench, "extras_kernels", lambda b, dev: None)
    monkeypatch.setattr(bench, "extras_kernels_big", lambda b, dev: None)
    monkeypatch.delenv("ZKFL_BENCH_QUICK", raising=False)
    rc = bench.main(["--device", "cpu"])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_an_extra_that_raises_fails_the_run(monkeypatch, capsys):
    def boom(b, prover):
        raise RuntimeError("boom")

    rc, line = _run_main(monkeypatch, capsys, boom)
    assert rc != 0
    assert line["value"] == 1.0 and line["error"] == "RuntimeError: boom"
    assert line["extras"]["gpu"] is None


def test_a_whole_run_exits_zero(monkeypatch, capsys):
    rc, line = _run_main(monkeypatch, capsys, lambda b, prover: None)
    assert rc == 0 and "error" not in line and line["value"] == 1.0


def test_the_budget_skips_and_names_the_skip():
    b = bench.Bench(budget=0.0)
    bench.extras_round(b, None)
    bench.extras_kernels(b, CPU)
    bench.extras_kernels_big(b, CPU)
    assert b.extras == {"skipped_after": "headline"}
