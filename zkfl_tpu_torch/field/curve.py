"""BN254 group arithmetic: G1 over FQ (raw ints) and G2 over FQ2.

G1 uses hand-specialised Jacobian formulas on Python ints (the fast host
path: trusted setup fallback and proof assembly for micro circuits).  G2 and
pairing-embedded points use the generic field interface of
:mod:`zkfl_tpu_torch.field.tower`.

The batched device MSM of :mod:`zkfl_tpu_torch.ops.msm` is tested bit-exactly
against this module.
"""

from __future__ import annotations

from .bn254 import CURVE_B, FQ, FR, G1_GEN, G2_GEN_X, G2_GEN_Y
from .tower import FQ2, FQ12

# ---------------------------------------------------------------------------
# G1: affine tuples (x, y) of ints, None = point at infinity.
# Jacobian tuples (X, Y, Z) with Z == 0 meaning infinity.
# ---------------------------------------------------------------------------

G1_INFINITY = None


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - CURVE_B) % FQ == 0


def g1_to_jacobian(p):
    if p is None:
        return (1, 1, 0)
    return (p[0], p[1], 1)


def g1_from_jacobian(p):
    X, Y, Z = p
    if Z == 0:
        return None
    zinv = pow(Z, FQ - 2, FQ)
    zinv2 = zinv * zinv % FQ
    return (X * zinv2 % FQ, Y * zinv2 * zinv % FQ)


def g1_double_jac(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return (1, 1, 0)
    # dbl-2009-l
    A = X * X % FQ
    B = Y * Y % FQ
    C = B * B % FQ
    D = 2 * ((X + B) * (X + B) - A - C) % FQ
    E = 3 * A % FQ
    F = E * E % FQ
    X3 = (F - 2 * D) % FQ
    Y3 = (E * (D - X3) - 8 * C) % FQ
    Z3 = 2 * Y * Z % FQ
    return (X3, Y3, Z3)


def g1_add_jac(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % FQ
    Z2Z2 = Z2 * Z2 % FQ
    U1 = X1 * Z2Z2 % FQ
    U2 = X2 * Z1Z1 % FQ
    S1 = Y1 * Z2 * Z2Z2 % FQ
    S2 = Y2 * Z1 * Z1Z1 % FQ
    if U1 == U2:
        if S1 != S2:
            return (1, 1, 0)
        return g1_double_jac(p)
    H = (U2 - U1) % FQ
    I = 4 * H * H % FQ
    J = H * I % FQ
    r = 2 * (S2 - S1) % FQ
    V = U1 * I % FQ
    X3 = (r * r - J - 2 * V) % FQ
    Y3 = (r * (V - X3) - 2 * S1 * J) % FQ
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % FQ * H % FQ
    return (X3, Y3, Z3)


def g1_mul(p, k: int):
    """Scalar multiplication, affine in/out."""
    k %= FR
    acc = (1, 1, 0)
    add = g1_to_jacobian(p)
    while k:
        if k & 1:
            acc = g1_add_jac(acc, add)
        add = g1_double_jac(add)
        k >>= 1
    return g1_from_jacobian(acc)


def g1_add(p, q):
    return g1_from_jacobian(g1_add_jac(g1_to_jacobian(p), g1_to_jacobian(q)))


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % FQ)


def g1_generator():
    return G1_GEN


def g1_msm(points, scalars):
    """Reference MSM (double-and-add over Jacobian accumulator).

    O(n * 254) group ops — only for tests/micro circuits; the production
    path is the Pippenger kernel in ops/msm.py.
    """
    acc = (1, 1, 0)
    for p, s in zip(points, scalars):
        s %= FR
        if s == 0 or p is None:
            continue
        add = g1_to_jacobian(p)
        while s:
            if s & 1:
                acc = g1_add_jac(acc, add)
            s >>= 1
            if s:
                add = g1_double_jac(add)
    return g1_from_jacobian(acc)


# ---------------------------------------------------------------------------
# Generic affine ops over any field implementing the FQP interface.
# Used for G2 (FQ2 coordinates) and the pairing embedding (FQ12).
# ---------------------------------------------------------------------------

# b' = 3 / (9 + u): twist coefficient of E'(FQ2).
TWIST_B = FQ2([3, 0]) / FQ2([9, 1])


def ec_double(p, field):
    if p is None:
        return None
    x, y = p
    if y.is_zero():
        return None
    lam = (x * x * 3) / (y * 2)
    x3 = lam * lam - x - x
    y3 = lam * (x - x3) - y
    return (x3, y3)


def ec_add(p, q, field):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return ec_double(p, field)
        return None
    lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def ec_neg(p):
    if p is None:
        return None
    return (p[0], -p[1])


def ec_mul(p, k: int, field):
    k %= FR
    result = None
    add = p
    while k:
        if k & 1:
            result = ec_add(result, add, field)
        add = ec_double(add, field)
        k >>= 1
    return result


def g2_generator():
    return (FQ2(list(G2_GEN_X)), FQ2(list(G2_GEN_Y)))


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - x * x * x - TWIST_B).is_zero()


def g2_mul(p, k: int):
    return ec_mul(p, k, FQ2)


def g2_add(p, q):
    return ec_add(p, q, FQ2)


def g2_neg(p):
    return ec_neg(p)


def g2_msm(points, scalars):
    acc = None
    for p, s in zip(points, scalars):
        if p is None or s % FR == 0:
            continue
        acc = g2_add(acc, g2_mul(p, s))
    return acc


# ---------------------------------------------------------------------------
# Jacobian arithmetic over FQ2 (G2 fast path — no per-add inversions).
# Points: (X, Y, Z) FQ2 triples, Z == zero -> infinity.
# ---------------------------------------------------------------------------

_FQ2_ZERO = FQ2.zero()
_FQ2_ONE = FQ2.one()

G2_JAC_INF = (_FQ2_ONE, _FQ2_ONE, _FQ2_ZERO)


def g2_to_jacobian(p):
    if p is None:
        return G2_JAC_INF
    return (p[0], p[1], _FQ2_ONE)


def g2_from_jacobian(p):
    X, Y, Z = p
    if Z.is_zero():
        return None
    zinv = Z.inv()
    zinv2 = zinv * zinv
    return (X * zinv2, Y * zinv2 * zinv)


def g2_double_jac(p):
    X, Y, Z = p
    if Z.is_zero() or Y.is_zero():
        return G2_JAC_INF
    A = X * X
    B = Y * Y
    C = B * B
    t = X + B
    D = (t * t - A - C) * 2
    E = A * 3
    F = E * E
    X3 = F - D - D
    Y3 = E * (D - X3) - C * 8
    Z3 = Y * Z * 2
    return (X3, Y3, Z3)


def g2_add_jac(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1.is_zero():
        return q
    if Z2.is_zero():
        return p
    Z1Z1 = Z1 * Z1
    Z2Z2 = Z2 * Z2
    U1 = X1 * Z2Z2
    U2 = X2 * Z1Z1
    S1 = Y1 * Z2 * Z2Z2
    S2 = Y2 * Z1 * Z1Z1
    if U1 == U2:
        if S1 != S2:
            return G2_JAC_INF
        return g2_double_jac(p)
    H = U2 - U1
    I = (H * 2) * (H * 2)
    J = H * I
    rr = (S2 - S1) * 2
    V = U1 * I
    X3 = rr * rr - J - V * 2
    Y3 = rr * (V - X3) - S1 * J * 2
    t = Z1 + Z2
    Z3 = (t * t - Z1Z1 - Z2Z2) * H
    return (X3, Y3, Z3)


def g2_mul_jac(p, k: int):
    """Fast G2 scalar mul (Jacobian), affine in/out."""
    k %= FR
    if p is None or k == 0:
        return None
    acc = G2_JAC_INF
    add = g2_to_jacobian(p)
    while k:
        if k & 1:
            acc = g2_add_jac(acc, add)
        add = g2_double_jac(add)
        k >>= 1
    return g2_from_jacobian(acc)


class FixedBaseG2:
    """Windowed fixed-base multiplier over G2 (mirrors setup's G1 table)."""

    WINDOW = 8

    def __init__(self, base=None):
        base = base or g2_generator()
        self.tables = []
        cur = g2_to_jacobian(base)
        n_windows = (256 + self.WINDOW - 1) // self.WINDOW
        for _ in range(n_windows):
            row = [G2_JAC_INF]
            acc = G2_JAC_INF
            for _ in range((1 << self.WINDOW) - 1):
                acc = g2_add_jac(acc, cur)
                row.append(acc)
            self.tables.append(row)
            for _ in range(self.WINDOW):
                cur = g2_double_jac(cur)

    def mul(self, k: int):
        k %= FR
        acc = G2_JAC_INF
        w = 0
        mask = (1 << self.WINDOW) - 1
        while k:
            d = k & mask
            if d:
                acc = g2_add_jac(acc, self.tables[w][d])
            k >>= self.WINDOW
            w += 1
        return g2_from_jacobian(acc)
