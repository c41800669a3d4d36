"""Optimal-ate pairing on BN254.

Host-side verifier oracle replacing the reference's `snarkjs groth16 verify`
subprocess (invoked at tests/full_system_simulation.mjs:865-868 etc.).  The
Miller loop runs over the sextic-twist embedding of G2 into E(FQ12); the final
exponentiation is split into the cheap ``p^6-1`` / ``p^2+1`` parts and a
single-exponent hard part.

Verification cost is a few hundred ms per pairing product in pure Python,
comfortably inside the reference's design envelope (verify is the cheap side
of Groth16).
"""

from __future__ import annotations

from .bn254 import ATE_LOOP_COUNT, FQ, FR, LOG_ATE_LOOP_COUNT
from .tower import FQ2, FQ12

_W = FQ12([0, 1] + [0] * 10)
_W2 = _W * _W
_W3 = _W2 * _W

# Hard-part exponent of the final exponentiation: (p^4 - p^2 + 1) / r.
_HARD_EXP = (FQ**4 - FQ**2 + 1) // FR


def twist(pt):
    """Map a point of E'(FQ2) into E(FQ12) (untwist)."""
    if pt is None:
        return None
    x, y = pt
    # Change of basis: FQ2 is represented over u with u^2 = -1, while w^6
    # corresponds to 9 + u.  So c0 + c1*u  ==  (c0 - 9 c1) + c1 * w^6.
    xc = [x.coeffs[0] - 9 * x.coeffs[1], x.coeffs[1]]
    yc = [y.coeffs[0] - 9 * y.coeffs[1], y.coeffs[1]]
    nx = FQ12([xc[0], 0, 0, 0, 0, 0, xc[1], 0, 0, 0, 0, 0])
    ny = FQ12([yc[0], 0, 0, 0, 0, 0, yc[1], 0, 0, 0, 0, 0])
    return (nx * _W2, ny * _W3)


def embed_g1(pt):
    """Embed a G1 point (int coords) into E(FQ12)."""
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x] + [0] * 11), FQ12([y] + [0] * 11))


def _double(p):
    x, y = p
    if y.is_zero():
        return None
    lam = (x * x * 3) / (y * 2)
    x3 = lam * lam - x - x
    y3 = lam * (x - x3) - y
    return (x3, y3)


def _add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return _double(p)
        return None
    lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(Q, P):
    """Miller loop for e(P, Q): Q already twisted into E(FQ12), P embedded.

    Returns the un-exponentiated loop value; combine several and call
    :func:`final_exponentiate` once for pairing products.
    """
    if Q is None or P is None:
        return FQ12.one()
    R = Q
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(R, R, P)
        R = _double(R)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(R, Q, P)
            R = _add(R, Q)
    # Frobenius endomorphism steps of the optimal ate pairing.
    Q1 = (Q[0] ** FQ, Q[1] ** FQ)
    nQ2 = (Q1[0] ** FQ, -(Q1[1] ** FQ))
    f = f * _linefunc(R, Q1, P)
    R = _add(R, Q1)
    f = f * _linefunc(R, nQ2, P)
    return f


def final_exponentiate(f):
    """f^((p^12-1)/r) via easy part + single hard-part exponent."""
    # Easy part: f^(p^6 - 1) = conj(f) / f, then ^(p^2 + 1).
    f = f.conjugate() * f.inv()
    f = f.frobenius().frobenius() * f
    # Hard part.
    return f**_HARD_EXP


def pairing(P, Q):
    """e(P, Q) for P in G1 (int coords), Q in G2 (FQ2 coords)."""
    return final_exponentiate(miller_loop(twist(Q), embed_g1(P)))


def pairing_product(pairs):
    """prod_i e(P_i, Q_i) with a single final exponentiation."""
    f = FQ12.one()
    for P, Q in pairs:
        f = f * miller_loop(twist(Q), embed_g1(P))
    return final_exponentiate(f)


def pairing_check(pairs) -> bool:
    """True iff prod_i e(P_i, Q_i) == 1."""
    return pairing_product(pairs) == FQ12.one()
