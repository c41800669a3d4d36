"""zkfl_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports zkfl_tpu or jax, and the port's own copies of the
framework-free host code (fields, Poseidon, commitments, circuits, setup,
HostEngine) equal zkfl_tpu's exactly on the same inputs."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import zkfl_tpu.commit.merkle as zk_merkle
import zkfl_tpu.commit.vector_hash as zk_vh
from zkfl_tpu.field.bn254 import FR
from zkfl_tpu.fl.config import MICRO_CONFIG as ZK_MICRO
from zkfl_tpu.groth16.engine import HostEngine as ZkHostEngine
from zkfl_tpu.groth16.setup import groth16_setup as zk_setup
from zkfl_tpu.r1cs.builder import ConstraintSystem as ZkCS
from zkfl_tpu.r1cs.circuits import build_structure as zk_build
from zkfl_tpu_torch.commit import merkle, vector_hash
from zkfl_tpu_torch.fl.config import MICRO_CONFIG
from zkfl_tpu_torch.groth16.engine import HostEngine
from zkfl_tpu_torch.groth16.setup import groth16_setup
from zkfl_tpu_torch.poseidon.grain import partial_rounds, poseidon_params
from zkfl_tpu_torch.poseidon.reference import poseidon
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem
from zkfl_tpu_torch.r1cs.circuits import build_structure

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "zkfl_tpu_torch").rglob("*.py"))

# Published circomlibjs outputs and circomlib's first t=3 round constant
# (the pins of tests/test_poseidon.py).
POSEIDON_1 = 18586133768512220936620570745912940619677854269274689475585506675881198879027
POSEIDON_1_2 = 7853200120776062878684798364095072458815029376092732009249414926327459813530
C0_T3 = 0x0EE9A592BA9A9518D05986D656F40C2114C4993C11BB29938D21D47304CD8E6E


def _imports(path: Path):
    """Absolute module names imported anywhere in the file (function bodies
    included)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("rel", PORT_FILES + ["chip_smoke.py"])
def test_no_import_of_zkfl_tpu_or_jax(rel):
    bad = [m for m in _imports(REPO / rel)
           if m.split(".")[0] in ("zkfl_tpu", "jax", "jaxlib")]
    assert not bad, f"{rel} imports {bad}"


def test_port_files_found():
    assert "zkfl_tpu_torch/ops/poseidon.py" in PORT_FILES
    for rel in ("groth16/device_setup.py", "r1cs/compiled.py", "fl/prod.py",
                "groth16/serialize.py", "groth16/binformat.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/msm.py", "parallel/ntt.py", "parallel/prover.py",
                "costs.py", "bench.py", "scripts/round8.py", "scripts/scaling.py"):
        assert f"zkfl_tpu_torch/{rel}" in PORT_FILES
    assert len(PORT_FILES) > 40


def test_circomlibjs_pins():
    assert poseidon([1]) == POSEIDON_1
    assert poseidon([1, 2]) == POSEIDON_1_2
    assert poseidon_params(3)[0][0] == C0_T3
    assert [partial_rounds(t) for t in (2, 3, 17)] == [56, 57, 68]


@pytest.mark.parametrize("circuit", ["balance_params", "training_params", "secagg_params"])
def test_build_structure_matches_zkfl_tpu(circuit):
    ours = build_structure(getattr(MICRO_CONFIG, circuit))
    theirs = zk_build(getattr(ZK_MICRO, circuit))
    assert (ours.name, ours.n_wires, ours.n_pub) == (theirs.name, theirs.n_wires, theirs.n_pub)
    assert ours.constraints == theirs.constraints
    assert ours.witness == theirs.witness


def _toy(cls, x, y):
    """out = x^2 * y + x + 7 (public out), built with either package."""
    cs = cls(name="toy")
    out = cs.public_input("out", (x * x % FR * y + x + 7) % FR)
    xin = cs.private_input("x", x)
    yin = cs.private_input("y", y)
    cs.enforce_equal(cs.mul(cs.mul(xin, xin), yin) + xin + 7, out)
    return cs


def key_ints(obj):
    """A proving or verifying key as nested tuples of ints (G2 coordinates
    by their Fq2 coefficients), comparable across the two packages."""
    if dataclasses.is_dataclass(obj):
        return tuple((f.name, key_ints(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(key_ints(v) for v in obj)
    return tuple(obj.coeffs) if hasattr(obj, "coeffs") else obj


def test_groth16_setup_matches_zkfl_tpu():
    ours = groth16_setup(_toy(ConstraintSystem, 3, 5), seed="standalone", device=None)
    theirs = zk_setup(_toy(ZkCS, 3, 5), seed="standalone", device=False)
    assert key_ints(ours) == key_ints(theirs)


def test_host_engine_matches_zkfl_tpu():
    cs = _toy(ConstraintSystem, 4, 9)
    ours, theirs = HostEngine(), ZkHostEngine()
    evals = ours.matrix_evals(cs.constraints, cs.witness, 8)
    assert evals == theirs.matrix_evals(cs.constraints, cs.witness, 8)
    assert ours.compute_h(*evals) == theirs.compute_h(*evals)
    pk, _ = groth16_setup(cs, seed="engine", device=None)
    assert ours.msm_g1(pk.a_query, cs.witness) == theirs.msm_g1(pk.a_query, cs.witness)
    assert key_ints(ours.msm_g2(pk.b2_query, cs.witness)) == \
        key_ints(theirs.msm_g2(pk.b2_query, cs.witness))


def test_commitments_match_zkfl_tpu():
    rng = np.random.RandomState(7)
    rows = [[int(v) for v in rng.randint(0, 1000, 17)] for _ in range(8)]
    leaves = [vector_hash.sample_hash(r[:16], r[16]) for r in rows]
    assert leaves == [zk_vh.sample_hash(r[:16], r[16]) for r in rows]
    assert vector_hash.vector_hash_many(rows) == leaves
    tree, zk_tree = merkle.MerkleTree(leaves[:5], 3), zk_merkle.MerkleTree(leaves[:5], 3)
    assert tree.levels == zk_tree.levels
    sib, path = tree.prove(4)
    assert merkle.verify_merkle_path(leaves[4], sib, path, tree.root)
    assert not merkle.verify_merkle_path(leaves[3], sib, path, tree.root)
    assert vector_hash.gradient_commitment([5, FR - 3, 7], 2, 1) == \
        zk_vh.gradient_commitment([5, FR - 3, 7], 2, 1)


def test_format_codecs_match_zkfl_tpu():
    """binformat's point codecs and serialize's JSON are copies: the same
    bytes and strings for the same points, parsed back alike."""
    from zkfl_tpu.field.curve import g1_generator as zk_g1, g2_generator as zk_g2
    from zkfl_tpu.field.curve import g1_mul as zk_g1_mul, g2_mul as zk_g2_mul
    from zkfl_tpu.groth16 import binformat as zk_bf, serialize as zk_ser
    from zkfl_tpu_torch.field.curve import g1_generator, g1_mul, g2_generator, g2_mul
    from zkfl_tpu_torch.groth16 import binformat as bf, serialize as ser

    g1s = [None, g1_generator(), g1_mul(g1_generator(), 12345)]
    g2s = [None, g2_generator(), g2_mul(g2_generator(), 6789)]
    zk_g1s = [None, zk_g1(), zk_g1_mul(zk_g1(), 12345)]
    zk_g2s = [None, zk_g2(), zk_g2_mul(zk_g2(), 6789)]
    for p, q in zip(g1s, zk_g1s):
        assert bf.g1_bytes(p) == zk_bf.g1_bytes(q)
        assert bf.g1_parse(bf.g1_bytes(p)) == p
        assert ser._g1_json(p) == zk_ser._g1_json(q)
        assert ser._g1_parse(ser._g1_json(p)) == p
    for p, q in zip(g2s, zk_g2s):
        assert bf.g2_bytes(p) == zk_bf.g2_bytes(q)
        assert key_ints(bf.g2_parse(bf.g2_bytes(p))) == key_ints(p)
        assert ser._g2_json(p) == zk_ser._g2_json(q)
        assert key_ints(ser._g2_parse(ser._g2_json(p))) == key_ints(p)
    assert bf.read_binfile(bf.BinWriter("wtns", 2).tobytes(), "wtns") == {}
