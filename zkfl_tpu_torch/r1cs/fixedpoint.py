"""Fixed-point arithmetic gadgets (Component C4).

Native re-expression of src/circuits/training/fixedpoint.circom: the
reference simulates decimals as r_fixed = r * PRECISION and provides
mul/div/add/sub/sqrt/abs/min/max over that encoding, with hint divisions
verified by remainder range checks.  Template map (reference file:line):

  fixed_mul   FixedPointMul(PRECISION)   :49-74   product = q*P + rem, rem < P (LessThan(64))
  fixed_div   FixedPointDiv(PRECISION)   :101-129 a*P = q*b + rem, rem < b, b != 0 (b*b_inv = 1)
  fixed_add   FixedPointAdd              :156-163 linear
  fixed_sub   FixedPointSub              :187-194 linear
  fixed_sqrt  FixedPointSqrt + sqrt_hint :224-300 Newton hint, |q^2/P - value| < 2P, zero case
  fixed_abs   FixedPointAbs              :323-350 isNeg hint (value > 2^251), negation check
  fixed_min   FixedPointMin              :369-384 LessThan(252) mux
  fixed_max   FixedPointMax              :403-418 LessThan(252) mux

As everywhere in this stack, "negative" fixed-point values are field
elements in the upper half of Fr (value > 2^251 is the reference's
negativity hint boundary, fixedpoint.circom:263,332).

KNOWN INHERITED SOUNDNESS GAPS (faithful to the reference, documented and
covered by tests/test_attacks.py::TestFixedpointInheritedGaps):

  * The remainder checks in fixed_mul/fixed_div/fixed_sqrt use circomlib
    LessThan(64) exactly as fixedpoint.circom:64-73 does.  LessThan(n)
    only bit-decomposes a + 2^n - b, so a field-negative remainder
    rem = FR - k with k < 2^64 - P still satisfies the check, letting a
    malicious prover shift the quotient.  The division results are
    therefore HINT-VERIFIED only up to this 64-bit wrap, same as the
    reference — do not rely on them for soundness-critical range bounds
    without an additional num2bits range check on the remainder.
  * fixed_abs's branch-consistency constraint (:346-349) is tautological
    for any boolean is_neg (see fixed_abs docstring) — abs is advisory.
"""

from __future__ import annotations

from ..field.bn254 import FR
from .builder import ConstraintSystem, LinComb
from .gadgets import less_than

_NEG_BOUNDARY = 1 << 251


def is_zero(cs: ConstraintSystem, v: LinComb) -> LinComb:
    """circomlib IsZero: out = 1 iff v == 0 (inv hint, v*out = 0)."""
    val = v.value % FR
    inv = cs.witness_wire(pow(val, -1, FR) if val else 0)
    out = cs.one() - cs.mul(v, inv)
    cs.enforce(v, out, cs.zero())
    return out


def enforce_nonzero(cs: ConstraintSystem, v: LinComb) -> None:
    """v != 0 via the inverse witness: v * v_inv = 1 (fixedpoint.circom:126-128)."""
    val = v.value % FR
    inv = cs.witness_wire(pow(val, -1, FR) if val else 0)
    cs.enforce(v, inv, cs.one())


def _div_hint(cs: ConstraintSystem, numerator: LinComb, divisor_val: int):
    """Quotient/remainder hint wires for the canonical (non-negative) value."""
    n = numerator.value % FR
    q = cs.witness_wire(n // divisor_val)
    rem = cs.witness_wire(n % divisor_val)
    return q, rem


def fixed_mul(cs: ConstraintSystem, a: LinComb, b: LinComb, precision: int) -> LinComb:
    """result = (a*b) / PRECISION with remainder check (FixedPointMul :49-74).

    Inputs are assumed non-negative (biased representation) as in the
    reference (:59-60); the hint floor-division is over canonical values.
    """
    product = cs.mul(a, b)
    q, rem = _div_hint(cs, product, precision)
    cs.enforce_equal(product, q * precision + rem)
    cs.enforce_equal(less_than(cs, rem, cs.constant(precision), 64), cs.one())
    return q


def fixed_div(cs: ConstraintSystem, a: LinComb, b: LinComb, precision: int) -> LinComb:
    """result = (a*PRECISION) / b with remainder + nonzero-divisor checks
    (FixedPointDiv :101-129)."""
    scaled_a = a * precision
    b_val = b.value % FR
    q = cs.witness_wire((scaled_a.value % FR) // b_val if b_val else 0)
    rem = cs.witness_wire((scaled_a.value % FR) % b_val if b_val else 0)
    cs.enforce_equal(scaled_a, cs.mul(q, b) + rem)
    cs.enforce_equal(less_than(cs, rem, b, 64), cs.one())
    enforce_nonzero(cs, b)
    return q


def fixed_add(cs: ConstraintSystem, a: LinComb, b: LinComb) -> LinComb:
    """FixedPointAdd :156-163 (linear, no constraint)."""
    return a + b


def fixed_sub(cs: ConstraintSystem, a: LinComb, b: LinComb) -> LinComb:
    """FixedPointSub :187-194 (linear, no constraint)."""
    return a - b


def sqrt_hint(value: int, precision: int) -> int:
    """Newton's-method hint, exact reference iteration
    (fixedpoint.circom:290-300): guess -> (guess + value*P/guess)/2, 15 iters,
    early exit when non-decreasing."""
    guess = value // 2
    if guess == 0:
        guess = precision
    for _ in range(15):
        nxt = (guess + (value * precision) // guess) // 2
        if nxt >= guess:
            return guess
        guess = nxt
    return guess


def fixed_sqrt(cs: ConstraintSystem, value: LinComb, precision: int) -> LinComb:
    """FixedPointSqrt :224-287: hinted sqrt with |hint^2/P - value| < 2P
    tolerance and an explicit zero case."""
    zero_flag = is_zero(cs, value)
    v = value.value % FR
    hint_val = 0 if v == 0 else sqrt_hint(v, precision)
    hint = cs.witness_wire(hint_val)

    # hint^2 = scaled*P + rem, rem < P  (:241-257)
    squared = cs.mul(hint, hint)
    scaled, rem = _div_hint(cs, squared, precision)
    cs.enforce_equal(squared, scaled * precision + rem)
    cs.enforce_equal(less_than(cs, rem, cs.constant(precision), 64), cs.one())

    # |scaled - value| < 2*PRECISION, negativity hint at 2^251 (:261-283).
    diff = scaled - value
    diff_val = diff.value % FR
    is_neg = cs.witness_wire(1 if diff_val > _NEG_BOUNDARY else 0)
    cs.enforce_bool(is_neg)
    neg_diff = -diff
    abs_diff = cs.mul(is_neg, neg_diff) + diff - cs.mul(is_neg, diff)
    error_ok = less_than(cs, abs_diff, cs.constant(2 * precision), 64) + zero_flag
    # errorOk must be nonzero: IsZero(errorOk) === 0 (:279-283).
    cs.enforce_zero(is_zero(cs, error_ok))

    return cs.mul(cs.one() - zero_flag, hint)


def fixed_abs(cs: ConstraintSystem, value: LinComb) -> LinComb:
    """FixedPointAbs :323-350: negativity hint + branch-consistency check.

    ADVISORY ONLY (inherited from the reference): given
    result = is_neg*(-value - value) + value, the consistency constraint
    is_neg*(result+value) + (1-is_neg)*(result-value) == 0 holds for
    EITHER boolean is_neg, so the sign hint is effectively unconstrained —
    a malicious prover may return value instead of -value.  Identical to
    FixedPointAbs (:341-349); callers must not rely on abs for
    soundness-critical bounds.  Demonstrated by
    tests/test_attacks.py::TestFixedpointInheritedGaps."""
    v = value.value % FR
    is_neg = cs.witness_wire(1 if v > _NEG_BOUNDARY else 0)
    cs.enforce_bool(is_neg)
    neg_value = -value
    result = cs.mul(is_neg, neg_value - value) + value
    # isNeg*(result+value) + (1-isNeg)*(result-value) === 0  (:346-349)
    check = cs.mul(is_neg, result + value) + cs.mul(cs.one() - is_neg, result - value)
    cs.enforce_zero(check)
    return result


def fixed_min(cs: ConstraintSystem, a: LinComb, b: LinComb) -> LinComb:
    """FixedPointMin :369-384: LessThan(252) mux, result = lt*(a-b) + b."""
    lt = less_than(cs, a, b, 252)
    return cs.mul(lt, a - b) + b


def fixed_max(cs: ConstraintSystem, a: LinComb, b: LinComb) -> LinComb:
    """FixedPointMax :403-418: LessThan(252) mux, result = lt*(b-a) + a."""
    lt = less_than(cs, a, b, 252)
    return cs.mul(lt, b - a) + a
