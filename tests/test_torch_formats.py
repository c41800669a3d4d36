"""The port's snarkjs artifact formats (zkfl_tpu_torch/groth16/binformat.py,
serialize.py) against zkfl_tpu's: the same bytes and the same JSON for the
same keys, keys crossing between the packages through .zkey files, the
committed snarkjs-layout fixture regenerated and proved (odd H basis), and
write_ptau on the CPU device, the pure-Python ladder and zkfl_tpu alike.
Exact equality of integers and bytes throughout."""

import dataclasses
import json

import pytest
import torch

from zkfl_tpu.groth16 import binformat as zk_bf
from zkfl_tpu.groth16 import serialize as zk_ser
from zkfl_tpu.groth16.engine import HostEngine as ZkHostEngine
from zkfl_tpu.groth16.prover import groth16_prove as zk_prove
from zkfl_tpu.groth16.setup import groth16_setup as zk_setup
from zkfl_tpu.r1cs.builder import ConstraintSystem as ZkCS
from zkfl_tpu_torch.field.bn254 import FR
from zkfl_tpu_torch.groth16 import binformat as bf
from zkfl_tpu_torch.groth16 import serialize as ser
from zkfl_tpu_torch.groth16.engine import HostEngine, TorchEngine
from zkfl_tpu_torch.groth16.prover import groth16_prove
from zkfl_tpu_torch.groth16.setup import groth16_setup
from zkfl_tpu_torch.groth16.verifier import groth16_verify
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

FIXTURE = __file__.rsplit("/", 1)[0] + "/data/snarkjs_layout_toy.zkey"
PTAU_SECRETS = dict(tau=7919, alpha=104729, beta=1299709)  # tests/test_binformat.py's


def _toy(cls):
    """tests/test_binformat.py's circuit, built with either package."""
    cs = cls(name="bin_toy")
    out = cs.public_input("out", (3 * 3 * 5 + 3 + 7) % FR)
    x = cs.private_input("x", 3)
    y = cs.private_input("y", 5)
    x2 = cs.mul(x, x)
    x2y = cs.mul(x2, y)
    cs.enforce_equal(x2y + x + 7, out)
    return cs


def ints(obj):
    """Keys, proofs and points as nested tuples of ints (G2 coordinates by
    their Fq2 coefficients), comparable across the two packages."""
    if dataclasses.is_dataclass(obj):
        return tuple((f.name, ints(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple((k, ints(v)) for k, v in sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(ints(v) for v in obj)
    return tuple(obj.coeffs) if hasattr(obj, "coeffs") else obj


@pytest.fixture(scope="module")
def keys():
    """The toy's monomial-basis keys from both packages (the ladders)."""
    ours = groth16_setup(_toy(ConstraintSystem), seed="bin-seed", device=None)
    theirs = zk_setup(_toy(ZkCS), seed="bin-seed", device=False)
    assert ints(ours) == ints(theirs)
    return ours, theirs


def test_write_zkey_bytes_match_zkfl_tpu(keys, tmp_path):
    (pk, vk), (zpk, zvk) = keys
    bf.write_zkey(str(tmp_path / "port.zkey"), pk, vk, _toy(ConstraintSystem))
    zk_bf.write_zkey(str(tmp_path / "zk.zkey"), zpk, zvk, _toy(ZkCS))
    assert (tmp_path / "port.zkey").read_bytes() == (tmp_path / "zk.zkey").read_bytes()


def test_zkey_from_zkfl_tpu_reads_into_the_port(keys, tmp_path):
    _, (zpk, zvk) = keys
    path = str(tmp_path / "zk.zkey")
    zk_bf.write_zkey(path, zpk, zvk, _toy(ZkCS))
    pk, vk, meta = bf.read_zkey(path)
    assert ints((pk, vk)) == ints((zpk, zvk))
    assert meta == zk_bf.read_zkey(path)[2]


def test_port_zkey_roundtrip_proves(keys, tmp_path):
    (pk, vk), _ = keys
    cs = _toy(ConstraintSystem)
    path = str(tmp_path / "toy.zkey")
    bf.write_zkey(path, pk, vk, cs)
    pk2, vk2, meta = bf.read_zkey(path)
    assert (pk2, vk2) == (pk, vk)
    assert meta["n_vars"] == cs.n_wires and meta["h_basis"] == "monomial"
    for matrix, constraint, signal, value in meta["coeffs"]:
        assert cs.constraints[constraint][matrix][signal] % FR == value
    assert groth16_verify(vk2, groth16_prove(pk2, cs, engine=HostEngine()))


def test_snarkjs_fixture_regenerated_byte_for_byte(tmp_path):
    cs = _toy(ConstraintSystem)
    pk, vk = groth16_setup(cs, seed="bin-odd-seed", device=None, h_basis="odd_evals")
    path = tmp_path / "regen.zkey"
    bf.write_zkey(str(path), pk, vk, cs)
    assert path.read_bytes() == open(FIXTURE, "rb").read()


@pytest.mark.parametrize("engine", ["host", "torch-cpu"])
def test_snarkjs_fixture_imports_proves_verifies(engine):
    """The committed fixture through groth16_prove's odd-basis branch (the
    engine's matrix evaluations, compute_podd on the host, the engine's
    MSMs), on HostEngine and on TorchEngine's plain versions."""
    pk, vk, meta = bf.read_zkey(FIXTURE)
    assert meta["h_basis"] == pk.h_basis == "odd_evals"
    assert len(pk.h_query) == pk.domain
    shim = bf.structure_from_zkey(pk, meta)
    assert isinstance(shim, ConstraintSystem) and shim.c_from_ab and shim.values[0] == 1
    eng = HostEngine() if engine == "host" else TorchEngine(torch.device("cpu"))
    proof = groth16_prove(pk, shim, _toy(ConstraintSystem).values, engine=eng)
    assert groth16_verify(vk, proof)
    zpk, zvk, zmeta = zk_bf.read_zkey(FIXTURE)
    theirs = zk_prove(zpk, zk_bf.structure_from_zkey(zpk, zmeta), _toy(ZkCS).values,
                      engine=ZkHostEngine())
    assert ints(proof) == ints(theirs)


def test_wtns_roundtrip_and_bytes(tmp_path):
    witness = _toy(ConstraintSystem).values + [FR - 1, 0]
    bf.write_wtns(str(tmp_path / "port.wtns"), witness)
    zk_bf.write_wtns(str(tmp_path / "zk.wtns"), witness)
    assert bf.read_wtns(str(tmp_path / "port.wtns")) == witness
    assert (tmp_path / "port.wtns").read_bytes() == (tmp_path / "zk.wtns").read_bytes()


def test_write_ptau_cpu_ladder_and_zkfl_tpu_agree(tmp_path):
    paths = {k: str(tmp_path / f"{k}.ptau") for k in ("cpu", "ladder", "zk")}
    bf.write_ptau(paths["cpu"], power=3, device=torch.device("cpu"), **PTAU_SECRETS)
    bf.write_ptau(paths["ladder"], power=3, device=None, **PTAU_SECRETS)
    zk_bf.write_ptau(paths["zk"], power=3, **PTAU_SECRETS)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["cpu"] == data["ladder"] == data["zk"]
    p = bf.read_ptau(paths["cpu"])
    assert (p["power"], len(p["tau_g1"]), len(p["tau_g2"])) == (3, 15, 8)
    assert ints(p) == ints(zk_bf.read_ptau(paths["zk"]))


def test_json_matches_zkfl_tpu(keys, tmp_path):
    (pk, vk), (zpk, zvk) = keys
    proof = groth16_prove(pk, _toy(ConstraintSystem), engine=HostEngine())
    theirs = zk_prove(zpk, _toy(ZkCS), engine=ZkHostEngine())
    assert ints(proof) == ints(theirs)
    assert ser.proof_to_json(proof) == zk_ser.proof_to_json(theirs)
    assert ser.vkey_to_json(vk) == zk_ser.vkey_to_json(zvk)
    assert ser.public_to_json(proof.public_signals) == zk_ser.public_to_json(theirs.public_signals)
    # through the files _runZKProof writes, and back
    ser.write_artifacts(str(tmp_path), "toy", proof, vk)
    read = {k: json.load(open(tmp_path / f"toy_{k}.json")) for k in ("proof", "public", "vkey")}
    publics = ser.public_from_json(read["public"])
    back = ser.proof_from_json(read["proof"], publics)
    assert ints(back) == ints(proof)
    assert ser.vkey_from_json(read["vkey"]) == vk
    assert groth16_verify(ser.vkey_from_json(read["vkey"]), back)
