"""The groth16 host layer's scalar multiplications in csrc/host
(``bn254_g1_mul``, ``bn254_g2_mul``, ``bn254_groth16_assemble``,
``bn254_g1_lincomb``) against the reference package's Python
double-and-add (``zkfl_tpu.groth16.prover.mul_g1``, ``mul_g2``,
``_assemble_proof``, ``zkfl_tpu.groth16.verifier.compute_vk_x``): the same
group elements for every scalar, the same proofs integer for integer, the
same vk_x, the counters, a fixed sequence of group operations whatever the
blinding scalar, and a host library that does not build raising with g++'s
message."""

import random
from types import SimpleNamespace

import pytest
import torch

from zkfl_tpu.field.curve import g1_from_jacobian as ref_g1_from_jacobian
from zkfl_tpu.field.tower import FQ2 as RefFQ2
from zkfl_tpu.groth16 import prover as ref_prover
from zkfl_tpu.groth16.verifier import compute_vk_x as ref_compute_vk_x
from zkfl_tpu_torch import native, trace
from zkfl_tpu_torch.field.bn254 import FR
from zkfl_tpu_torch.field.curve import (
    G2_JAC_INF,
    g1_from_jacobian,
    g1_generator,
    g1_mul,
    g2_generator,
    g2_mul,
)
from zkfl_tpu_torch.fl.client import Client, SharedLCG
from zkfl_tpu_torch.fl.config import MICRO_CONFIG
from zkfl_tpu_torch.groth16 import prover
from zkfl_tpu_torch.groth16.engine import HostEngine
from zkfl_tpu_torch.groth16.prover import groth16_prove, mul_g1, mul_g2
from zkfl_tpu_torch.groth16.setup import groth16_setup
from zkfl_tpu_torch.groth16.verifier import compute_vk_x, groth16_verify
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem
from zkfl_tpu_torch.r1cs.circuits import build_structure

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

SCALARS = {
    "zero": 0, "one": 1, "two": 2, "r_minus_1": FR - 1, "r": FR, "r_plus_1": FR + 1,
    "2r_plus_3": 2 * FR + 3, "top": (1 << 256) - 1,
    **{f"random{i}": random.Random(i).randrange(FR) for i in range(4)},
}


def _g1_point(seed: int):
    return g1_mul(g1_generator(), random.Random(seed).randrange(1, FR))


def _g2_point(seed: int):
    return g2_mul(g2_generator(), random.Random(seed).randrange(1, FR))


def ref_g2(q):
    """The port's G2 point with the reference package's FQ2 coordinates."""
    return None if q is None else tuple(RefFQ2(c.coeffs) for c in q)


def ints(p):
    """A point as a tuple of ints (G2 coordinates by their coefficients),
    comparable across the two packages; None for the identity."""
    return None if p is None else tuple(c.coeffs if hasattr(c, "coeffs") else c for c in p)


@pytest.mark.parametrize("point", ["random", "generator", "identity"])
@pytest.mark.parametrize("k", SCALARS.values(), ids=list(SCALARS))
def test_mul_g1_equals_the_plain_double_and_add(k, point):
    """mul_g1 against zkfl_tpu's double-and-add."""
    p = {"random": _g1_point(k % 1000), "generator": g1_generator(), "identity": None}[point]
    got, want = mul_g1(p, k), ref_prover.mul_g1(p, k)
    assert g1_from_jacobian(got) == ref_g1_from_jacobian(want)
    assert got[2] in (0, 1)
    if want[2] == 0:
        assert got == want == (1, 1, 0)


@pytest.mark.parametrize("point", ["random", "generator", "identity"])
@pytest.mark.parametrize("k", SCALARS.values(), ids=list(SCALARS))
def test_mul_g2_equals_the_plain_double_and_add(k, point):
    """mul_g2 against zkfl_tpu's double-and-add."""
    p = {"random": _g2_point(k % 1000), "generator": g2_generator(), "identity": None}[point]
    assert ints(mul_g2(p, k)) == ints(ref_prover.mul_g2(ref_g2(p), k))


def test_native_identity_forms():
    assert native.g1_mul_native(g1_generator(), FR) == (1, 1, 0)
    assert native.g2_mul_native(None, 7) == G2_JAC_INF
    assert native.g1_lincomb_native([None, g1_generator()], [0]) == (1, 1, 0)
    with pytest.raises(ValueError):
        native.g1_lincomb_native([g1_generator()], [1])


BROKEN_SOURCE = "int broken() { return undeclared_name; }\n"


@pytest.mark.parametrize("cause", ["no_gxx", "compile_error"])
def test_a_failed_host_build_raises(cause, tmp_path, monkeypatch):
    """No silent fallback: a host library that does not build raises,
    naming its source, with g++'s error where g++ ran."""
    (tmp_path / "broken.cpp").write_text(BROKEN_SOURCE)
    monkeypatch.setattr(native, "HOST_SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    if cause == "no_gxx":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError) as err:
        native.build("broken.cpp")
    msg = str(err.value)
    assert "broken.cpp" in msg
    if cause == "no_gxx":
        assert "g++ is not on PATH" in msg
    else:
        assert "error" in msg and "undeclared_name" in msg
    assert not list((tmp_path / "build").rglob("*.so"))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_blinding_multiplication_runs_a_fixed_operation_sequence(group):
    """The doublings, additions and table entries read are the same for
    scalars of every weight and length."""
    mul, point = {"g1": (native.g1_mul_native, _g1_point(1)),
                  "g2": (native.g2_mul_native, _g2_point(2))}[group]
    native.group_op_counts()
    counts = set()
    for k in (0, 1, 2, FR - 1, 1 << 253, (1 << 128) - 1, *list(SCALARS.values())[-4:]):
        mul(point, k)
        counts.add(native.group_op_counts())
    assert counts == {(256 + 78, 14 + 64, 64 * 16)}


def _toy():
    """tests/test_jax_prover.py's toy: out = x^2 y + x + 7, x = 3, y = 5."""
    cs = ConstraintSystem(name="toy")
    x, y = 3, 5
    out = cs.public_input("out", (x * x % FR * y + x + 7) % FR)
    xin, yin = cs.private_input("x", x), cs.private_input("y", y)
    cs.enforce_equal(cs.mul(cs.mul(xin, xin), yin) + xin + 7, out)
    pk, vk = groth16_setup(cs, seed="toy-seed", device=None)
    return cs, pk, vk, None


def _micro():
    """MICRO_CONFIG's balance circuit and one client's witness."""
    cs = build_structure(MICRO_CONFIG.balance_params)
    pk, vk = groth16_setup(cs, seed="micro-balance", device=None)
    client = Client(1, MICRO_CONFIG, prover=None)
    client.generate_private_dataset(SharedLCG(MICRO_CONFIG.seed))
    client.compute_dataset_commitment()
    return cs, pk, vk, client.balance_witness()


@pytest.mark.parametrize("circuit", [_toy, _micro], ids=["toy", "micro_balance"])
def test_assembled_proofs_are_integer_identical(circuit, monkeypatch):
    """Deterministic blinding (tests/conftest.py): one proof's MSM results
    assembled natively and by zkfl_tpu's ``_assemble_proof`` give the same
    proof, and the verifier accepts it."""
    cs, pk, vk, witness = circuit()
    seen = []
    assemble = prover._assemble_proof

    def keep(*args):
        seen.append(args)
        return assemble(*args)

    monkeypatch.setattr(prover, "_assemble_proof", keep)
    ours = groth16_prove(pk, cs, witness, engine=HostEngine())
    ((_, w, msms, r, s),) = seen
    ref_pk = SimpleNamespace(n_pub=pk.n_pub, alpha1=pk.alpha1, beta1=pk.beta1, delta1=pk.delta1,
                             beta2=ref_g2(pk.beta2), delta2=ref_g2(pk.delta2))
    theirs = ref_prover._assemble_proof(ref_pk, w, {**msms, "b2": ref_g2(msms["b2"])}, r, s)
    assert (ours.pi_a, ints(ours.pi_b), ours.pi_c, ours.public_signals) == \
        (theirs.pi_a, ints(theirs.pi_b), theirs.pi_c, theirs.public_signals)
    assert groth16_verify(vk, ours)


@pytest.mark.parametrize("publics", ["random", "zeros", "r_minus_1", "small"])
def test_compute_vk_x_equals_the_plain_sum(publics):
    """A toy verifying key with four public signals, IC_2 the identity,
    against zkfl_tpu's compute_vk_x."""
    ic = [_g1_point(10 + i) for i in range(5)]
    ic[2] = None
    vk = SimpleNamespace(ic=ic)
    rng = random.Random(7)
    signals = {
        "random": [rng.randrange(FR) for _ in range(4)],
        "zeros": [0] * 4,
        "r_minus_1": [FR - 1] * 4,
        "small": [1, 2, 15, 16],
    }[publics]
    assert compute_vk_x(vk, signals) == ref_compute_vk_x(vk, signals)


def test_compute_vk_x_of_the_identity_sum():
    vk = SimpleNamespace(ic=[None, _g1_point(3)])
    assert compute_vk_x(vk, [FR]) is None
    assert ref_compute_vk_x(vk, [FR]) is None


def test_scalar_mul_native_counts_every_multiplication():
    """Six multiplications a proof's assembly and one a public signal in
    vk_x, all in csrc/host."""
    cs, pk, vk, _ = _toy()
    trace.enable()
    try:
        proof = groth16_prove(pk, cs, engine=HostEngine())
        assert groth16_verify(vk, proof)
        _, counters = trace.take()
    finally:
        trace.disable()
    assert counters["groth16.scalar_mul"] == 6 + pk.n_pub
    assert "groth16.scalar_mul_native" not in counters
