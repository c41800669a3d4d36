"""The groth16 host layer's scalar multiplications in csrc/host
(``bn254_g1_mul``, ``bn254_g2_mul``, ``bn254_g1_lincomb``) against the plain
Python double-and-add they replace: the same group elements for every
scalar, the same proofs integer for integer, the same vk_x, the counters,
and a fixed sequence of group operations whatever the blinding scalar."""

import random

import pytest
import torch

from zkfl_tpu_torch import native, trace
from zkfl_tpu_torch.field.bn254 import FR
from zkfl_tpu_torch.field.curve import (
    G2_JAC_INF,
    g1_from_jacobian,
    g1_generator,
    g2_generator,
)
from zkfl_tpu_torch.fl.client import Client, SharedLCG
from zkfl_tpu_torch.fl.config import MICRO_CONFIG
from zkfl_tpu_torch.groth16 import prover
from zkfl_tpu_torch.groth16.engine import HostEngine
from zkfl_tpu_torch.groth16.prover import (
    groth16_prove,
    mul_g1,
    mul_g1_plain,
    mul_g2,
    mul_g2_plain,
)
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


@pytest.fixture(autouse=True)
def needs_the_pairing_library():
    if not native.pairing_available():
        pytest.skip("the native pairing library does not build (no g++)")


def _python_path(monkeypatch):
    monkeypatch.setattr(native, "get_pairing_lib", lambda: None)


def _g1_point(seed: int):
    return g1_from_jacobian(mul_g1_plain(g1_generator(), random.Random(seed).randrange(1, FR)))


def _g2_point(seed: int):
    return mul_g2_plain(g2_generator(), random.Random(seed).randrange(1, FR))


@pytest.mark.parametrize("point", ["random", "generator", "identity"])
@pytest.mark.parametrize("k", SCALARS.values(), ids=list(SCALARS))
def test_mul_g1_equals_the_plain_double_and_add(k, point):
    p = {"random": _g1_point(k % 1000), "generator": g1_generator(), "identity": None}[point]
    got, want = mul_g1(p, k), mul_g1_plain(p, k)
    assert g1_from_jacobian(got) == g1_from_jacobian(want)
    assert got[2] in (0, 1)
    if want[2] == 0:
        assert got == want == (1, 1, 0)


@pytest.mark.parametrize("point", ["random", "generator", "identity"])
@pytest.mark.parametrize("k", SCALARS.values(), ids=list(SCALARS))
def test_mul_g2_equals_the_plain_double_and_add(k, point):
    p = {"random": _g2_point(k % 1000), "generator": g2_generator(), "identity": None}[point]
    assert mul_g2(p, k) == mul_g2_plain(p, k)


def test_native_returns_none_without_the_library(monkeypatch):
    _python_path(monkeypatch)
    assert native.g1_mul_native(g1_generator(), 5) is None
    assert native.g2_mul_native(g2_generator(), 5) is None
    assert native.g1_lincomb_native([g1_generator()] * 2, [5]) is None
    assert native.groth16_assemble_native(None, {}, 1, 2) is None
    assert mul_g1(g1_generator(), 5) == mul_g1_plain(g1_generator(), 5)


def test_native_identity_forms():
    assert native.g1_mul_native(g1_generator(), FR) == (1, 1, 0)
    assert native.g2_mul_native(None, 7) == G2_JAC_INF
    assert native.g1_lincomb_native([None, g1_generator()], [0]) == (1, 1, 0)
    with pytest.raises(ValueError):
        native.g1_lincomb_native([g1_generator()], [1])


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
    assembled natively and by the plain loops give the same proof, and the
    verifier accepts it."""
    cs, pk, vk, witness = circuit()
    seen = []
    assemble = prover._assemble_proof

    def keep(*args):
        seen.append(args)
        return assemble(*args)

    monkeypatch.setattr(prover, "_assemble_proof", keep)
    ours = groth16_prove(pk, cs, witness, engine=HostEngine())
    (args,) = seen
    with monkeypatch.context() as m:
        _python_path(m)
        theirs = assemble(*args)
    assert (ours.pi_a, ours.pi_b, ours.pi_c, ours.public_signals) == \
        (theirs.pi_a, theirs.pi_b, theirs.pi_c, theirs.public_signals)
    assert groth16_verify(vk, ours)
    assert groth16_verify(vk, theirs)


@pytest.mark.parametrize("publics", ["random", "zeros", "r_minus_1", "small"])
def test_compute_vk_x_equals_the_plain_sum(publics, monkeypatch):
    """A toy verifying key with four public signals, IC_2 the identity."""
    ic = [_g1_point(10 + i) for i in range(5)]
    ic[2] = None
    vk = type("VK", (), {"ic": ic})()
    rng = random.Random(7)
    signals = {
        "random": [rng.randrange(FR) for _ in range(4)],
        "zeros": [0] * 4,
        "r_minus_1": [FR - 1] * 4,
        "small": [1, 2, 15, 16],
    }[publics]
    ours = compute_vk_x(vk, signals)
    _python_path(monkeypatch)
    assert ours == compute_vk_x(vk, signals)


def test_compute_vk_x_of_the_identity_sum(monkeypatch):
    vk = type("VK", (), {"ic": [None, _g1_point(3)]})()
    assert compute_vk_x(vk, [FR]) is None
    _python_path(monkeypatch)
    assert compute_vk_x(vk, [FR]) is None


def test_scalar_mul_native_counts_every_multiplication(monkeypatch):
    """Six multiplications a proof's assembly and one a public signal in
    vk_x, all native; none native on the Python path."""
    cs, pk, vk, _ = _toy()
    for python_path, native_muls in ((False, 6 + pk.n_pub), (True, 0)):
        with monkeypatch.context() as m:
            if python_path:
                _python_path(m)
            trace.enable()
            try:
                proof = groth16_prove(pk, cs, engine=HostEngine())
                assert groth16_verify(vk, proof)
                _, counters = trace.take()
            finally:
                trace.disable()
        assert counters["groth16.scalar_mul"] == 6 + pk.n_pub
        assert counters["groth16.scalar_mul_native"] == native_muls
