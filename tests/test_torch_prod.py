"""The port's production path on the CPU at toy size: compiled COO circuits
(zkfl_tpu_torch/r1cs/compiled.py) round-trip and cross-load with
zkfl_tpu's files, prove through the fused TorchEngine pipeline exactly as
their structure-mode form does, and fl/prod.py's input generators equal
zkfl_tpu.fl.prod's.  Also the round-level repairs: RoundProver on a
HostEngine and the fl package's exports."""

import numpy as np
import pytest
import torch

import zkfl_tpu.fl.prod as zk_prod
from zkfl_tpu.field.bn254 import FR, domain_size_for
from zkfl_tpu.groth16.device_prover import PipelineProfile as ZkProfile
from zkfl_tpu.r1cs.builder import ConstraintSystem as ZkCS
from zkfl_tpu.r1cs.compiled import CompiledCircuit as ZkCompiled
from zkfl_tpu_torch.commit.merkle import verify_merkle_path
from zkfl_tpu_torch.fl import prod
from zkfl_tpu_torch.groth16.device_prover import PipelineProfile
from zkfl_tpu_torch.groth16.engine import HostEngine, TorchEngine
from zkfl_tpu_torch.groth16.prover import groth16_prove
from zkfl_tpu_torch.groth16.setup import groth16_setup
from zkfl_tpu_torch.groth16.verifier import groth16_verify
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem
from zkfl_tpu_torch.r1cs.compiled import CompiledCircuit, compile_and_cache, compiled_cached

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

CPU = torch.device("cpu")
ARRAYS = ("which", "row", "col", "coeffs")


def _toy(cls, x, y, name="toy_compiled"):
    """out = x^2 * y + x + 7 (public out), built with either package."""
    cs = cls(name=name)
    out = cs.public_input("out", (x * x % FR * y + x + 7) % FR)
    xin = cs.private_input("x", x)
    yin = cs.private_input("y", y)
    cs.enforce_equal(cs.mul(cs.mul(xin, xin), yin) + xin + 7, out)
    return cs


def _same(a, b) -> bool:
    meta = ("name", "n_constraints", "n_wires", "n_pub")
    return all(getattr(a, k) == getattr(b, k) for k in meta) and all(
        getattr(a, k).dtype == getattr(b, k).dtype and np.array_equal(getattr(a, k), getattr(b, k))
        for k in ARRAYS)


def test_compiled_roundtrip(tmp_path):
    cs = _toy(ConstraintSystem, 3, 5)
    cc = CompiledCircuit.from_structure(cs)
    assert cc.n_wires == cs.n_wires and cc.n_pub == cs.n_pub
    assert cc.nnz == sum(len(abc[k]) for abc in cs.constraints for k in range(3))
    assert cc.coeffs.dtype == np.uint32 and cc.coeffs.shape == (16, cc.nnz)
    path = tmp_path / "toy.coo.npz"
    cc.save(path)
    assert _same(CompiledCircuit.load(path), cc)
    with pytest.raises(ValueError):
        CompiledCircuit.from_structure(ConstraintSystem(name="empty"))


class _Params:
    name = "toy_cached"


def test_compiled_cache(tmp_path):
    assert compiled_cached(_Params, str(tmp_path)) is None
    cc = compile_and_cache(_toy(ConstraintSystem, 2, 7, name="toy_cached"), str(tmp_path))
    assert _same(compiled_cached(_Params, str(tmp_path)), cc)


def test_compiled_files_cross_load_with_zkfl_tpu(tmp_path):
    ours = CompiledCircuit.from_structure(_toy(ConstraintSystem, 3, 5))
    theirs = ZkCompiled.from_structure(_toy(ZkCS, 3, 5))
    assert _same(ours, theirs)
    ours.save(tmp_path / "ours.coo.npz")
    theirs.save(tmp_path / "theirs.coo.npz")
    assert _same(ZkCompiled.load(tmp_path / "ours.coo.npz"), ours)
    assert _same(CompiledCircuit.load(tmp_path / "theirs.coo.npz"), theirs)


def _wide(cls):
    """More wires and terms than the toy in two constraints: the same domain."""
    cs = cls(name="wide")
    out = cs.public_input("sum", 45)
    xs = [cs.private_input(f"x{i}", i + 1) for i in range(9)]
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    cs.enforce_equal(total, out)
    cs.enforce_equal(cs.mul(xs[0], xs[1]), xs[1])
    return cs


def test_compiled_prove_matches_structure():
    """Proving a CompiledCircuit on TorchEngine(cpu), padded to a profile
    that covers a wider circuit (from_coo's padding), equals the
    structure-mode proof under fixed blinding, and verifies."""
    cs = _toy(ConstraintSystem, 3, 5)
    pk, vk = groth16_setup(cs, seed="compiled-seed", device=None)
    cc = CompiledCircuit.from_structure(cs)
    prof = PipelineProfile.cover([cc, _wide(ConstraintSystem)])
    assert prof.domain == pk.domain and prof.m_pad > cc.n_wires and prof.nnz_pad > cc.nnz
    structure_proof = groth16_prove(pk, cs, cs.witness, engine=HostEngine(), blinding=(7, 11))
    compiled_proof = groth16_prove(pk, cc, cs.witness, engine=TorchEngine(CPU, prof),
                                   blinding=(7, 11))
    assert compiled_proof == structure_proof
    assert groth16_verify(vk, compiled_proof)


def test_compiled_requires_fused_engine():
    cs = _toy(ConstraintSystem, 3, 5)
    pk, _ = groth16_setup(cs, seed="compiled-seed", device=None)
    cc = CompiledCircuit.from_structure(cs)
    with pytest.raises(ValueError, match="fused"):
        groth16_prove(pk, cc, cs.witness, engine=HostEngine())


def test_profile_cover_matches_zkfl_tpu():
    ours = PipelineProfile.cover([CompiledCircuit.from_structure(_toy(ConstraintSystem, 3, 5)),
                                  _wide(ConstraintSystem)])
    theirs = ZkProfile.cover([ZkCompiled.from_structure(_toy(ZkCS, 3, 5)), _wide(ZkCS)])
    assert (ours.m_pad, ours.domain, ours.nnz_pad) == (theirs.m_pad, theirs.domain, theirs.nnz_pad)


def test_prod_inputs_match_zkfl_tpu():
    """The prod generators equal zkfl_tpu.fl.prod's and yield consistent
    inputs: Merkle paths verify against root_D, the labels balance, the
    gradient sits inside the clipping bound and commits to root_G."""
    assert (prod.PROD_N, prod.PROD_DIM, prod.PROD_DEPTH, prod.PROD_BATCH, prod.PROD_SEED) == (
        zk_prod.PROD_N, zk_prod.PROD_DIM, zk_prod.PROD_DEPTH, zk_prod.PROD_BATCH, zk_prod.PROD_SEED)
    assert prod.BALANCE_PARAMS.name == zk_prod.BALANCE_PARAMS.name
    assert prod.V5_PARAMS.name == zk_prod.V5_PARAMS.name
    ds, zk_ds = prod.generate_dataset(), zk_prod.generate_dataset()
    assert ds["root_d"] == zk_ds["root_d"]
    assert (ds["features"], ds["labels"]) == (zk_ds["features"], zk_ds["labels"])
    bi, vi = prod.balance_inputs(ds), prod.v5_inputs(ds)
    assert bi == zk_prod.balance_inputs(zk_ds)
    assert vi == zk_prod.v5_inputs(zk_ds)
    for i in (0, 1, 127):
        leaf = prod.sample_hash(ds["features"][i], ds["labels"][i])
        sib, idx = ds["tree"].prove(i)
        assert verify_merkle_path(leaf, sib, idx, ds["root_d"])
    assert bi["c0"] + bi["c1"] == prod.PROD_N and bi["c1"] == sum(bi["labels"])
    assert vi["root_D"] == ds["root_d"]
    norm = sum(p * p + n * n for p, n in zip(vi["gradPos"], vi["gradNeg"]))
    assert norm <= vi["tauSquared"] < 1 << 60
    grad_field = [(p - n) % FR for p, n in zip(vi["gradPos"], vi["gradNeg"])]
    assert vi["root_G"] == prod.gradient_commitment(grad_field, 1, 1)


@pytest.mark.parametrize("bal, v5", [([7, 5, 9], [1, 2, 5]), ([7, 5, 9], [1, 2, 4, 0])])
def test_verify_binding_matches_zkfl_tpu(bal, v5):
    assert prod.verify_binding(bal, v5) == zk_prod.verify_binding(bal, v5) == (bal[1] == v5[2])


def test_fl_exports():
    from zkfl_tpu_torch.fl import (  # noqa: F401
        MICRO_CONFIG, REFERENCE_CONFIG, Client, FLConfig, ProofPackage, RoundProver, Server,
        SharedLCG, run_round, simulate_key_exchange)
    import zkfl_tpu.fl as zk_fl
    import zkfl_tpu_torch.fl as fl

    assert fl.__all__ == zk_fl.__all__


def test_round_prover_on_host_engine(tmp_path):
    """A HostEngine round prover: ladder setups at the natural domains, no
    client batching, and one balance proof of it verifies."""
    from zkfl_tpu_torch.fl import MICRO_CONFIG, RoundProver
    from zkfl_tpu_torch.fl.client import Client, SharedLCG

    prover = RoundProver(MICRO_CONFIG, HostEngine(), cache_dir=str(tmp_path))
    assert not prover.can_batch
    assert prover.balance_pk.domain == domain_size_for(len(prover.balance_cs.constraints) + 1)
    client = Client(1, MICRO_CONFIG, prover)
    client.generate_private_dataset(SharedLCG(MICRO_CONFIG.seed))
    client.compute_dataset_commitment()
    pkg = client.generate_balance_proof()
    assert prover.verify_balance(pkg.proof)
