"""The native pairing check of the port (``csrc/host/zkfl_pairing.cpp``:
``bn254_pairing_check``, ``bn254_miller``, ``bn254_final_exp``) against the
reference package and the port's Python oracle: the same boolean as
``zkfl_tpu.field.pairing.pairing_check`` and
``zkfl_tpu_torch.field.pairing.pairing_check`` on seeded bilinear relations
of 1 to 6 pairs and with identity factors anywhere; the same Fq12 values as
the reference library's ``bn254_final_exp`` and ``bn254_miller``
(``zkfl_tpu.native``) and as the generic power
(``bn254_final_exp_plain``); bilinearity of final_exp(miller(P, Q)); a
Groth16 proof and its tampered twins; a point off its curve rejected; and
the library's branch-free Fq operations against the branching forms they
replaced."""

import ctypes
import random
import shutil
import subprocess

import pytest
import torch

from zkfl_tpu import native as ref_native
from zkfl_tpu.field import pairing as ref_pairing
from zkfl_tpu.field.tower import FQ2 as RefFQ2
from zkfl_tpu_torch import native, trace
from zkfl_tpu_torch.field.bn254 import FQ, FR
from zkfl_tpu_torch.field.curve import (
    g1_add,
    g1_generator,
    g1_is_on_curve,
    g2_add,
    g2_generator,
)
from zkfl_tpu_torch.field.pairing import pairing_check
from zkfl_tpu_torch.groth16.engine import HostEngine
from zkfl_tpu_torch.groth16.prover import Proof, groth16_prove
from zkfl_tpu_torch.groth16.setup import groth16_setup
from zkfl_tpu_torch.groth16.verifier import groth16_verify
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

FQ12_BYTES = 12 * 32


def g1(k: int):
    """k G1, affine (None = the identity)."""
    p = native.g1_mul_native(g1_generator(), k)
    return None if p[2] == 0 else p[:2]


def g2(k: int):
    """k G2, affine over FQ2 (None = the identity)."""
    p = native.g2_mul_native(g2_generator(), k)
    return None if p[2] == type(p[2]).zero() else p[:2]


def relation(n: int, seed: int, off: int):
    """n pairs (a_i G1, b_i G2) with sum a_i b_i = off mod r: the product
    of their pairings is 1 exactly when off is 0.  One pair holds only with
    an identity factor."""
    rng = random.Random(seed)
    a = [rng.randrange(1, FR) for _ in range(n)]
    b = [rng.randrange(1, FR) for _ in range(n)]
    a[-1] = (off - sum(x * y for x, y in zip(a[:-1], b[:-1]))) * pow(b[-1], -1, FR) % FR
    return [(g1(x), g2(y)) for x, y in zip(a, b)]


def miller(pairs) -> bytes:
    """The shared Miller loop's value over ``pairs`` (tower order, 12 x 32
    little-endian bytes)."""
    g1s = native._bytes(v for p, _ in pairs for v in (p or (0, 0)))
    g2s = b"".join(map(native._g2_coords, (q for _, q in pairs)))
    out = ctypes.create_string_buffer(FQ12_BYTES)
    assert native.get_pairing_lib().bn254_miller(len(pairs), g1s, g2s, out) == 0
    return out.raw


def final_exp(f: bytes, plain: bool = False) -> bytes:
    lib = native.get_pairing_lib()
    out = ctypes.create_string_buffer(FQ12_BYTES)
    (lib.bn254_final_exp_plain if plain else lib.bn254_final_exp)(f, out)
    return out.raw


ONE12 = native._bytes([1] + [0] * 11)


def ref_pairing_check(pairs) -> bool:
    """zkfl_tpu.field.pairing.pairing_check on the same points, G2
    coordinates as the reference package's FQ2."""
    return ref_pairing.pairing_check(
        [(p, None if q is None else tuple(RefFQ2(c.coeffs) for c in q)) for p, q in pairs])


def ref_lib():
    lib = ref_native.get_pairing_lib()
    if lib is None:
        pytest.skip("the reference package's pairing library does not build")
    return lib


def ref_final_exp(f: bytes) -> bytes:
    """The reference library's final exponentiation (the same 12 x 4 limb
    tower layout; easy part, then the generic power)."""
    out = ctypes.create_string_buffer(FQ12_BYTES)
    ref_lib().bn254_final_exp(f, out)
    return out.raw


def ref_miller(p, q) -> bytes:
    """The reference library's Miller loop of one pair (affine twist)."""
    out = ctypes.create_string_buffer(FQ12_BYTES)
    assert ref_lib().bn254_miller(native._bytes(p), native._g2_coords(q), out) == 0
    return out.raw


@pytest.mark.parametrize("holds", [True, False], ids=["holds", "off_by_one"])
@pytest.mark.parametrize("n", range(1, 7))
def test_check_equals_the_oracle(n, holds):
    pairs = relation(n, seed=100 + n, off=0 if holds else 1)
    assert native.pairing_check_native(pairs) is holds
    assert ref_pairing_check(pairs) is holds
    assert pairing_check(pairs) is holds


@pytest.mark.parametrize("holds", [True, False], ids=["holds", "off_by_one"])
@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("at", range(5))
def test_identity_factors_anywhere(at, group, holds):
    pairs = relation(4, seed=7, off=0 if holds else 1)
    identity = (None, g2(5)) if group == "g1" else (g1(5), None)
    pairs.insert(at, identity)
    assert native.pairing_check_native(pairs) is holds
    assert ref_pairing_check(pairs) is holds
    assert native.pairing_check_native([identity] * 3) is True


def test_final_exp_chain_equals_the_generic_power():
    """The BN addition chain is the hard exponent (p^4 - p^2 + 1)/r exactly,
    not a multiple of it: the same Fq12 element as the generic power here
    and in the reference library."""
    for seed in range(4):
        rng = random.Random(seed)
        f = native._bytes(rng.randrange(FQ) for _ in range(12))
        e = final_exp(f)
        assert e == final_exp(f, plain=True)
        assert e == ref_final_exp(f)
    assert final_exp(ONE12) == ONE12


def test_final_exp_of_miller_is_bilinear():
    rng = random.Random(3)
    a, b = rng.randrange(1, FR), rng.randrange(1, FR)
    e = final_exp(miller([(g1(a), g2(b))]))
    # the reduced pairing is one Fq12 value: the reference library's
    # affine single-pair loop reaches it too
    assert e == ref_final_exp(ref_miller(g1(a), g2(b)))
    assert e == final_exp(miller([(g1(a * b % FR), g2(1))]))
    assert e == final_exp(miller([(g1(1), g2(a * b % FR))]))
    assert e != ONE12
    # one shared loop over two pairs: e(aP, bQ) e(-abP, Q) = 1
    assert final_exp(miller([(g1(a), g2(b)), (g1(-a * b % FR), g2(1))])) == ONE12


def test_a_point_off_its_curve_is_rejected():
    """A product that holds, with one G1 or G2 point moved off its curve:
    an invalid proof, decided natively."""
    pairs = relation(2, seed=11, off=0)
    assert native.pairing_check_native(pairs) is True
    (x, y), q = pairs[0]
    bad = (x, (y + 1) % FQ)
    assert not g1_is_on_curve(bad)
    assert native.pairing_check_native([(bad, q), pairs[1]]) is False
    qx, qy = pairs[1][1]
    assert native.pairing_check_native([pairs[0], (pairs[1][0], (qx, qy + qy))]) is False


@pytest.fixture(scope="module")
def toy_proof():
    """tests/test_jax_prover.py's toy: out = x^2 y + x + 7, x = 3, y = 5."""
    cs = ConstraintSystem(name="toy")
    x, y = 3, 5
    out = cs.public_input("out", (x * x % FR * y + x + 7) % FR)
    xin, yin = cs.private_input("x", x), cs.private_input("y", y)
    cs.enforce_equal(cs.mul(cs.mul(xin, xin), yin) + xin + 7, out)
    pk, vk = groth16_setup(cs, seed="toy-seed", device=None)
    return vk, groth16_prove(pk, cs, engine=HostEngine())


@pytest.mark.parametrize("tamper", ["none", "pi_a", "pi_b", "pi_c", "public", "pi_a_off_curve"])
def test_groth16_verify_decides_natively(toy_proof, tamper):
    """The verifier's 4-pair product: the proof holds, each tampered twin
    fails (the off-curve one too); every check counts ``groth16.pairing``
    and, decided natively, ``groth16.pairing_native``."""
    vk, proof = toy_proof
    pi_a, pi_b, pi_c, publics = proof.pi_a, proof.pi_b, proof.pi_c, list(proof.public_signals)
    if tamper == "pi_a":
        pi_a = g1_add(pi_a, g1_generator())
    elif tamper == "pi_b":
        pi_b = g2_add(pi_b, g2_generator())
    elif tamper == "pi_c":
        pi_c = g1_add(pi_c, g1_generator())
    elif tamper == "public":
        publics[0] = (publics[0] + 1) % FR
    elif tamper == "pi_a_off_curve":
        pi_a = (pi_a[0], (pi_a[1] + 1) % FQ)
    trace.enable()
    try:
        ok = groth16_verify(vk, Proof(pi_a=pi_a, pi_b=pi_b, pi_c=pi_c, public_signals=publics))
        _, counters = trace.take()
    finally:
        trace.disable()
    assert ok is (tamper == "none")
    assert counters["groth16.pairing"] == 1
    assert counters["groth16.pairing_native"] == 1


ARITH_HARNESS = r"""
#include "zkfl_pairing.cpp"
#include <cstdio>
#include <random>

// The reference: Fq addition, subtraction, negation and the Montgomery
// product's final step as they were before they became branch-free, each
// ending in a conditional subtraction that branches on the values.
namespace ref {
static bool geq(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}
static void sub_nocarry(u64 r[4], const u64 a[4], const u64 b[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    r[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
}
static void add(Fq &r, const Fq &a, const Fq &b) {
  u128 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.l[i] + b.l[i] + carry;
    r.l[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || geq(r.l, P)) sub_nocarry(r.l, r.l, P);
}
static void sub(Fq &r, const Fq &a, const Fq &b) {
  u128 borrow = 0;
  u64 t[4];
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.l[i] - b.l[i] - borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) ? 1 : 0;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)t[i] + P[i] + carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
  }
  memcpy(r.l, t, sizeof t);
}
static void neg(Fq &r, const Fq &a) {
  bool zero = !(a.l[0] | a.l[1] | a.l[2] | a.l[3]);
  if (zero) { memset(r.l, 0, sizeof r.l); return; }
  sub_nocarry(r.l, P, a.l);
}
static void mul(Fq &out, const Fq &a, const Fq &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);
    u64 m = t[0] * N0INV;
    carry = ((u128)t[0] + (u128)m * P[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * P[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    s = (u128)t[4] + carry;
    t[3] = (u64)s;
    t[4] = t[5] + (u64)(s >> 64);
  }
  if (t[4] || geq(t, P)) sub_nocarry(out.l, t, P);
  else memcpy(out.l, t, 4 * sizeof(u64));
}
}  // namespace ref

// fq_add, fq_sub, fq_neg and fq_mul against the reference on every pair of
// edge values and random values; pairing::half through fq_add.
int main() {
  pairing::init_constants();
  std::vector<Fq> xs;
  const u64 pm[4] = {P[0], P[1], P[2], P[3]};
  for (u64 k : {1, 2, 3}) {  // p - k
    Fq v; memcpy(v.l, pm, sizeof pm); v.l[0] -= k; xs.push_back(v);
  }
  for (u64 v : {0ULL, 1ULL, 2ULL, ~0ULL}) xs.push_back(Fq{{v, 0, 0, 0}});
  xs.push_back(Fq{{0, 0, 0, 1}});
  xs.push_back(Fq{{~0ULL, ~0ULL, ~0ULL, P[3] - 1}});
  xs.push_back(FQ_ONE);
  std::mt19937_64 g(7);
  while (xs.size() < 64) {
    Fq v = {{g(), g(), g(), g() >> 2}};
    if (!ref::geq(v.l, P)) xs.push_back(v);
  }
  long bad = 0, n = 0;
  auto same = [&](const Fq &a, const Fq &b) { bad += memcmp(a.l, b.l, 32) != 0; ++n; };
  for (const Fq &x : xs)
    for (const Fq &y : xs) {
      Fq r1, r2;
      ref::add(r1, x, y); fq_add(r2, x, y); same(r1, r2);
      ref::sub(r1, x, y); fq_sub(r2, x, y); same(r1, r2);
      ref::mul(r1, x, y); fq_mul(r2, x, y); same(r1, r2);
    }
  for (const Fq &x : xs) {
    Fq r1, r2;
    ref::neg(r1, x); fq_neg(r2, x); same(r1, r2);
    pairing::half(r2, x); fq_add(r1, r2, r2); same(r1, x);
  }
  printf("%ld %ld\n", bad, n);
  return 0;
}
"""


def test_the_pairings_field_arithmetic_equals_the_ladders(tmp_path):
    """The one Fq addition, subtraction, negation and product, branch-free,
    against the branching forms they replace (copied into the harness), and
    half, on edge values (0, 1, 2, p - 1, p - 2, p - 3, one word full, the
    top word alone) and random values, every pair."""
    (tmp_path / "t.cpp").write_text(ARITH_HARNESS)
    exe = tmp_path / "t"
    subprocess.run([shutil.which("g++"), "-O1", "-std=c++17", f"-I{native.HOST_SRC}", "-o",
                    str(exe), str(tmp_path / "t.cpp")], check=True, capture_output=True, timeout=300)
    bad, n = map(int, subprocess.run([str(exe)], check=True, capture_output=True,
                                        text=True, timeout=60).stdout.split())
    assert n >= 3 * 64 * 64 and bad == 0
