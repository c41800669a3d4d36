"""The port's sharding (zkfl_tpu_torch/parallel, DeviceProver's client mesh)
on a mesh of 8 CPU devices, as tests/test_parallel.py runs zkfl_tpu's on 8
virtual CPU devices: the sharded MSM against zkfl_tpu's pippenger_g1, the
4-step tables against zkfl_tpu's, the sharded NTT against zkfl_tpu's
pure-Python qap.ntt, the tensor-parallel prover against the unsharded
pipeline and zkfl_tpu's HostEngine proof, and the client-batch mesh against
the unsharded batch.  Exact equality of integers throughout."""

import inspect
import random

import numpy as np
import pytest
import torch

from zkfl_tpu.field.bn254 import FR
from zkfl_tpu.groth16.engine import HostEngine as ZkHostEngine
from zkfl_tpu.groth16.prover import groth16_prove as zk_prove
from zkfl_tpu.groth16.prover import pippenger_g1
from zkfl_tpu.groth16.qap import ntt as qap_ntt
from zkfl_tpu.groth16.setup import groth16_setup as zk_setup
from zkfl_tpu.parallel import ntt as zk_pntt
from zkfl_tpu.parallel import prover as zk_pprover
from zkfl_tpu.r1cs.builder import ConstraintSystem as ZkCS
from zkfl_tpu_torch.field.curve import g1_generator, g1_mul
from zkfl_tpu_torch.field.limbs import from_u16_limbs
from zkfl_tpu_torch.fl.prover import RoundProver
from zkfl_tpu_torch.fl.simulation import run_round
from zkfl_tpu_torch.groth16 import device_prover
from zkfl_tpu_torch.groth16.device_prover import DeviceProver
from zkfl_tpu_torch.groth16.engine import TorchEngine
from zkfl_tpu_torch.groth16.prover import _assemble_proof, default_blinding, groth16_prove_many
from zkfl_tpu_torch.groth16.setup import groth16_setup
from zkfl_tpu_torch.groth16.verifier import groth16_verify
from zkfl_tpu_torch.ops.limb_kernels import FRK
from zkfl_tpu_torch.parallel import Mesh, msm_g1_sharded
from zkfl_tpu_torch.parallel.mesh import all_gather, all_to_all
from zkfl_tpu_torch.parallel.ntt import _twiddle_table, ntt_sharded
from zkfl_tpu_torch.parallel.prover import _coset_tables, _factor, msm_results_tp
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

CPU = torch.device("cpu")
rng = random.Random(13)


def _toy(cls, x=3, y=5):
    """tests/test_parallel.py's TP circuit, built with either package."""
    cs = cls(name="tp_toy")
    out = cs.public_input("out", (x * x * y + x + 7) % FR)
    xin = cs.private_input("x", x)
    yin = cs.private_input("y", y)
    cs.enforce_equal(cs.mul(cs.mul(xin, xin), yin) + xin + 7, out)
    return cs


def _ints(proof):
    return (proof.pi_a, tuple(tuple(c.coeffs) for c in proof.pi_b), proof.pi_c,
            proof.public_signals)


@pytest.fixture(scope="module")
def toy():
    """The toy at domain 64 (so the 4-step factors (8, 8) cover 8 shards),
    its ladder keys and its DeviceProver on the CPU."""
    cs = _toy(ConstraintSystem)
    pk, vk = groth16_setup(cs, seed="tp-seed", device=None, domain=64)
    return cs, pk, vk, DeviceProver(pk, cs, CPU)


@pytest.fixture(scope="module")
def unsharded(toy):
    """The unsharded fused pipeline's MSM results for the toy's witness."""
    cs, _, _, dp = toy
    return dp.msm_results(cs.values)


@pytest.mark.parametrize("n", [16, 5])
def test_sharded_msm_matches_pippenger(n):
    """16 points over 8 shards, and 5 (padded with points at infinity)."""
    g = g1_generator()
    pts = [g1_mul(g, rng.randrange(1, 10**9)) for _ in range(n)]
    scs = [rng.randrange(FR) for _ in range(n)]
    assert msm_g1_sharded(pts, scs, Mesh([CPU] * 8, "points")) == pippenger_g1(pts, scs)


def test_collectives_route_blocks():
    """all_to_all: shard i's block j lands in shard j at position i, on
    values that tell every block apart; all_gather stacks in shard order."""
    D = 4
    shards = [torch.arange(D * 2 * 3).reshape(D * 2, 3) + 100 * i for i in range(D)]
    out = all_to_all(shards, split_dim=0, concat_dim=1)
    for j in range(D):
        want = torch.cat([shards[i][2 * j:2 * j + 2] for i in range(D)], dim=1)
        assert torch.equal(out[j], want)
    assert torch.equal(all_gather(shards, CPU), torch.stack(shards))
    with pytest.raises(ValueError):
        all_to_all(shards, split_dim=1, concat_dim=0)


def _words(table):
    """zkfl_tpu's uint32 [16, ...] table of 16-bit limbs -> int32 [8, ...]."""
    return from_u16_limbs(table.reshape(16, -1)).reshape((8,) + table.shape[1:])


@pytest.mark.parametrize("n1,n2", [(8, 8), (8, 16), (16, 8)])
def test_four_step_tables_match_zkfl_tpu(n1, n2):
    """The same Montgomery integers (R = 2^256 in both packages)."""
    for inverse in (False, True):
        assert np.array_equal(_twiddle_table(n1, n2, inverse),
                              _words(zk_pntt._twiddle_table(n1, n2, inverse)))
    for ours, theirs in zip(_coset_tables(n1, n2), zk_pprover._coset_tables(n1, n2)):
        assert np.array_equal(ours, _words(theirs))


@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_ntt_matches_qap_ntt(inverse):
    n = 256
    vals = [rng.randrange(FR) for _ in range(n)]
    x = FRK.tensor(vals, CPU).reshape(8, 1, n)
    got = FRK.unpack(ntt_sharded(x, Mesh([CPU] * 8, "tp"), inverse=inverse)[:, 0, :])
    assert got == qap_ntt(vals, inverse=inverse)


def test_factor():
    assert _factor(64, 8) == (8, 8)
    assert _factor(1 << 19, 4) == (512, 1024)
    assert _factor(1 << 14, 4) == (128, 128)
    with pytest.raises(ValueError, match="domain >= devices"):
        _factor(32, 8)


def test_tp_prover_matches_unsharded_and_host_engine(toy, unsharded):
    """The TP pipeline over 8 shards == the unsharded fused pipeline; its
    proof == zkfl_tpu's HostEngine proof (deterministic blinding, set by
    tests/conftest.py) and verifies."""
    cs, pk, vk, dp = toy
    got = msm_results_tp(dp, [cs.values], Mesh([CPU] * 8, "points"))[0]
    assert got == unsharded
    proof = _assemble_proof(pk, cs.values, got, *default_blinding(cs.values))
    assert groth16_verify(vk, proof)
    zk_cs = _toy(ZkCS)
    zk_pk, _ = zk_setup(zk_cs, seed="tp-seed", device=False, domain=64)
    assert _ints(proof) == _ints(zk_prove(zk_pk, zk_cs, engine=ZkHostEngine()))


def test_client_mesh_matches_unsharded_batch(toy, unsharded):
    cs, _, _, dp = toy
    witnesses = [cs.values, _toy(ConstraintSystem, 4, 9).values]
    got = dp.msm_results_many(witnesses, mesh=Mesh([CPU] * 2, "clients"))
    assert got[0] == unsharded
    assert got == dp.msm_results_many(witnesses)


def test_client_mesh_needs_an_even_split(toy):
    cs, _, _, dp = toy
    with pytest.raises(ValueError, match="does not split"):
        dp.msm_results_many([cs.values] * 3, mesh=Mesh([CPU] * 2, "clients"))


def test_mesh_reaches_the_client_batch(monkeypatch):
    """groth16_prove_many, RoundProver.prove_*_many and run_round hand the
    mesh on to DeviceProver.msm_results_many (recorded, not run)."""
    seen = []

    class Recorder:
        def msm_results_many(self, witnesses, mesh=None, axis="clients"):
            seen.append((mesh, axis))
            return []

    monkeypatch.setattr(device_prover, "device_prover", lambda *args: Recorder())
    mesh = Mesh([CPU] * 2, "clients")
    assert groth16_prove_many(None, None, [], TorchEngine(CPU), mesh=mesh) == []
    rp = RoundProver.__new__(RoundProver)
    rp.engine = TorchEngine(CPU)
    for name in ("balance", "training", "secagg"):
        setattr(rp, f"{name}_pk", None)
        setattr(rp, f"{name}_cs", None)
        getattr(rp, f"prove_{name}_many")([], mesh=mesh)
    assert seen == [(mesh, "clients")] * 4
    assert inspect.signature(run_round).parameters["mesh"].default is None
