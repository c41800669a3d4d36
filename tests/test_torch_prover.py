"""The port's fused prover end to end on the CPU: TorchEngine proofs equal
the JaxEngine and HostEngine proofs bit for bit (deterministic blinding,
set by tests/conftest.py), verify with zkfl_tpu's native verifier, and the
port runs without importing JAX or zkfl_tpu."""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from zkfl_tpu.field.bn254 import FR
from zkfl_tpu.groth16.engine import HostEngine, JaxEngine
from zkfl_tpu.groth16.prover import groth16_prove as zk_groth16_prove
from zkfl_tpu.groth16.setup import groth16_setup
from zkfl_tpu.groth16.verifier import groth16_verify
from zkfl_tpu.r1cs.builder import ConstraintSystem
from zkfl_tpu_torch.groth16.device_prover import PipelineProfile
from zkfl_tpu_torch.groth16.engine import TorchEngine
from zkfl_tpu_torch.groth16.prover import groth16_prove, groth16_prove_many
from zkfl_tpu_torch.groth16.setup import setup_cached

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)


def _toy_circuit(x: int, y: int):
    """Knowledge of x, y with out = x^2 * y + x + 7 (public out), as in
    tests/test_jax_prover.py."""
    cs = ConstraintSystem(name="toy")
    out_val = (x * x % FR * y + x + 7) % FR
    out = cs.public_input("out", out_val)
    xin = cs.private_input("x", x)
    yin = cs.private_input("y", y)
    x2 = cs.mul(xin, xin)
    x2y = cs.mul(x2, yin)
    cs.enforce_equal(x2y + xin + 7, out)
    return cs


def _key(p):
    return (p.pi_a, p.pi_b, p.pi_c, p.public_signals)


def key_ints(obj):
    """A proving or verifying key as nested tuples of ints (G2 coordinates
    by their Fq2 coefficients), comparable across the two packages."""
    if dataclasses.is_dataclass(obj):
        return tuple((f.name, key_ints(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(key_ints(v) for v in obj)
    return tuple(obj.coeffs) if hasattr(obj, "coeffs") else obj


@pytest.fixture(scope="module")
def toy():
    cs = _toy_circuit(3, 5)
    pk, vk = groth16_setup(cs, seed="toy-seed", device=False)
    return cs, pk, vk


@pytest.fixture(scope="module")
def torch_proof(toy):
    cs, pk, _ = toy
    return groth16_prove(pk, cs, engine=TorchEngine(CPU))


def test_torch_proof_matches_host_and_verifies(toy, torch_proof):
    cs, pk, vk = toy
    assert _key(torch_proof) == _key(zk_groth16_prove(pk, cs, engine=HostEngine()))
    assert groth16_verify(vk, torch_proof)


def test_torch_proof_matches_jax(toy, torch_proof):
    cs, pk, _ = toy
    assert _key(torch_proof) == _key(zk_groth16_prove(pk, cs, engine=JaxEngine()))


def test_prove_many_batch_of_two(toy, torch_proof):
    cs, pk, vk = toy
    witnesses = [cs.witness, _toy_circuit(4, 9).witness]
    proofs = groth16_prove_many(pk, cs, witnesses, TorchEngine(CPU))
    assert len(proofs) == 2
    assert all(groth16_verify(vk, p) for p in proofs)
    assert _key(proofs[0]) == _key(torch_proof)  # batch row 0 == the single proof
    bad = list(witnesses[1])
    bad[-1] = (bad[-1] + 1) % FR
    assert not groth16_verify(vk, groth16_prove_many(pk, cs, [bad], TorchEngine(CPU))[0])


def test_engine_primitives_match_host(toy):
    cs, pk, _ = toy
    eng, host = TorchEngine(CPU), HostEngine()
    evals = eng.matrix_evals(cs.constraints, cs.witness, pk.domain)
    assert evals == host.matrix_evals(cs.constraints, cs.witness, pk.domain)
    assert eng.compute_h(*evals) == host.compute_h(*evals)
    assert eng.msm_g1(pk.a_query, cs.witness) == host.msm_g1(pk.a_query, cs.witness)


def test_profile_and_setup_cache_match_jax(tmp_path):
    from zkfl_tpu.fl.config import MICRO_CONFIG
    from zkfl_tpu.groth16.device_prover import PipelineProfile as JaxProfile
    from zkfl_tpu.groth16.setup import setup_cached as jax_setup_cached
    from zkfl_tpu.r1cs.circuits import build_structure

    structures = [build_structure(p) for p in (
        MICRO_CONFIG.balance_params, MICRO_CONFIG.training_params, MICRO_CONFIG.secagg_params)]
    ours, theirs = PipelineProfile.cover(structures), JaxProfile.cover(structures)
    assert (ours.m_pad, ours.domain, ours.nnz_pad) == (theirs.m_pad, theirs.domain, theirs.nnz_pad)
    # A file name of the port's own, the fingerprint of zkfl_tpu's cache:
    # under zkfl_tpu's name the port's file is what zkfl_tpu's setup_cached
    # loads (a miss would run a setup and write a third file).
    cs = _toy_circuit(3, 5)
    keys = setup_cached(cs, str(tmp_path), seed="cache-seed", domain=8, device=None)
    (ours,) = tmp_path.iterdir()
    assert ours.name.startswith("toy_") and ours.name.endswith(".torch.zkey.pkl")
    shutil.copy(ours, tmp_path / ours.name.replace(".torch.zkey.pkl", ".zkey.pkl"))
    assert key_ints(jax_setup_cached(cs, str(tmp_path), seed="cache-seed", domain=8)) == key_ints(keys)
    assert len(list(tmp_path.iterdir())) == 2
    # the keys equal zkfl_tpu's as integers, and load back from the cache
    assert key_ints(keys) == key_ints(groth16_setup(cs, seed="cache-seed", device=False, domain=8))
    assert key_ints(setup_cached(cs, str(tmp_path), seed="cache-seed", domain=8, device=None)) == key_ints(keys)
    assert keys[0].domain == 8


def test_port_runs_without_jax():
    script = textwrap.dedent("""
        import sys, torch
        import zkfl_tpu_torch.fl.prod, zkfl_tpu_torch.fl.simulation
        import zkfl_tpu_torch.groth16.device_setup, zkfl_tpu_torch.r1cs.compiled
        from zkfl_tpu_torch.field.bn254 import FR
        from zkfl_tpu_torch.groth16.engine import TorchEngine
        from zkfl_tpu_torch.groth16.prover import groth16_prove
        from zkfl_tpu_torch.groth16.setup import groth16_setup
        from zkfl_tpu_torch.groth16.verifier import groth16_verify
        from zkfl_tpu_torch.ops.poseidon import poseidon_hash_ints
        from zkfl_tpu_torch.poseidon.reference import poseidon
        from zkfl_tpu_torch.r1cs.builder import ConstraintSystem

        cs = ConstraintSystem(name="nojax")
        out = cs.public_input("out", 3 * 4 % FR)
        a = cs.private_input("a", 3)
        b = cs.private_input("b", 4)
        cs.enforce_equal(cs.mul(a, b), out)
        pk, vk = groth16_setup(cs, seed="nojax", device=None)
        proof = groth16_prove(pk, cs, engine=TorchEngine(torch.device("cpu")))
        assert groth16_verify(vk, proof)
        assert poseidon_hash_ints([[1, 2], [3, 4]], device="cpu") == [poseidon([1, 2]), poseidon([3, 4])]
        loaded = sorted(m for m in sys.modules if m == "zkfl_tpu" or m.startswith(("zkfl_tpu.", "jax")))
        assert not loaded, loaded
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


@pytest.mark.slow
def test_micro_round_on_the_port(tmp_path):
    """A full MICRO_CONFIG round through the port's RoundProver and
    run_round (batched clients, 9 proofs); its MSMs are heavy on the CPU."""
    from zkfl_tpu_torch.fl.config import MICRO_CONFIG
    from zkfl_tpu_torch.fl.prover import RoundProver
    from zkfl_tpu_torch.fl.simulation import run_round

    prover = RoundProver(MICRO_CONFIG, TorchEngine(CPU), cache_dir=str(tmp_path))
    server, _ = run_round(MICRO_CONFIG, prover=prover, verbose=False)
    summary = server.get_summary()
    assert summary["all_passed"], (summary, server.log)
    assert summary["secagg"] == {"passed": 3, "total": 3}
    assert server.aggregated_gradient is not None
