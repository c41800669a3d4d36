"""BN254 in plain Python: G1 over Fq, G2 over Fq2, the optimal ate pairing
and the Groth16 verification equation.

Written for the benchmark's judge, apart from the program under test: it
imports nothing but the standard library.  Points are plain ints:
G1 affine (x, y) or None for the identity; G2 affine ((x0, x1), (y0, y1))
for x0 + x1 u, with u^2 = -1.

Fq12 is Fq[w] / (w^12 - 18 w^6 + 82), so w^6 = 9 + u (the twist's xi),
and a G2 point (x, y) of the twist y^2 = x^3 + 3 / xi maps into E(Fq12) as
(x w^2, y w^3).  The Miller loop keeps its point on the twist and
evaluates each line at P as a sparse Fq12 element: for a slope L in Fq2
through T = (xT, yT), l(P) = -yP + (L xP) w + (yT - L xT) w^3.
"""

from __future__ import annotations

Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ATE_LOOP = 29793968203157093288          # 6x + 2, x = 4965661367192848881
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

# -- Fq2 on (a, b) = a + b u ---------------------------------------------------


def f2_add(x, y):
    return ((x[0] + y[0]) % Q, (x[1] + y[1]) % Q)


def f2_sub(x, y):
    return ((x[0] - y[0]) % Q, (x[1] - y[1]) % Q)


def f2_mul(x, y):
    return ((x[0] * y[0] - x[1] * y[1]) % Q, (x[0] * y[1] + x[1] * y[0]) % Q)


def f2_scale(x, k):
    return (x[0] * k % Q, x[1] * k % Q)


def f2_inv(x):
    d = pow((x[0] * x[0] + x[1] * x[1]) % Q, Q - 2, Q)
    return (x[0] * d % Q, -x[1] * d % Q)


def f2_pow(x, e):
    out = (1, 0)
    while e:
        if e & 1:
            out = f2_mul(out, x)
        x = f2_mul(x, x)
        e >>= 1
    return out


def f2_conj(x):
    return (x[0], -x[1] % Q)


XI = (9, 1)
TWIST_B = f2_mul((3, 0), f2_inv(XI))
# Frobenius on the twist: pi(x, y) = (conj(x) GAMMA_X, conj(y) GAMMA_Y).
GAMMA_X = f2_pow(XI, (Q - 1) // 3)
GAMMA_Y = f2_pow(XI, (Q - 1) // 2)

# -- G1 --------------------------------------------------------------------


def g1_on_curve(p) -> bool:
    return p is None or (p[1] * p[1] - p[0] ** 3 - 3) % Q == 0


def g1_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if (p[1] + q[1]) % Q == 0:
            return None
        lam = 3 * p[0] * p[0] * pow(2 * p[1], Q - 2, Q) % Q
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], Q - 2, Q) % Q
    x = (lam * lam - p[0] - q[0]) % Q
    return (x, (lam * (p[0] - x) - p[1]) % Q)


def g1_neg(p):
    return None if p is None else (p[0], -p[1] % Q)


def g1_mul(p, k: int):
    """k p by double-and-add in Jacobian coordinates."""
    k %= R
    if p is None or k == 0:
        return None
    X, Y, Z = 0, 1, 0
    for bit in bin(k)[2:]:
        if Z:  # double
            A, B = X * X % Q, Y * Y % Q
            C = B * B % Q
            D = 2 * ((X + B) ** 2 - A - C) % Q
            E = 3 * A % Q
            X3 = (E * E - 2 * D) % Q
            Y, Z = (E * (D - X3) - 8 * C) % Q, 2 * Y * Z % Q
            X = X3
        if bit == "1":  # add the affine p
            if not Z:
                X, Y, Z = p[0], p[1], 1
                continue
            z2 = Z * Z % Q
            U2, S2 = p[0] * z2 % Q, p[1] * z2 * Z % Q
            H, rr = (U2 - X) % Q, (S2 - Y) % Q
            if H == 0:
                raise ArithmeticError("g1_mul met a doubling inside the ladder")
            H2 = H * H % Q
            H3 = H2 * H % Q
            V = X * H2 % Q
            X3 = (rr * rr - H3 - 2 * V) % Q
            Y, Z = (rr * (V - X3) - Y * H3) % Q, Z * H % Q
            X = X3
    if not Z:
        return None
    zi = pow(Z, Q - 2, Q)
    return (X * zi * zi % Q, Y * zi * zi * zi % Q)


# -- G2 on the twist -------------------------------------------------------


def g2_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return f2_sub(f2_mul(y, y), f2_add(f2_mul(f2_mul(x, x), x), TWIST_B)) == (0, 0)


def g2_mul(p, k: int):
    out, add = None, p
    while k:
        if k & 1:
            out = _g2_add(out, add)
        add = _g2_add(add, add)
        k >>= 1
    return out


def _g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    lam = _slope(p, q)
    if lam is None:
        return None
    return _g2_step(p, q, lam)


def _slope(t, q):
    """Slope of the line through t and q (the tangent where they meet), or
    None for a vertical line."""
    if t[0] == q[0]:
        if f2_add(t[1], q[1]) == (0, 0):
            return None
        return f2_mul(f2_scale(f2_mul(t[0], t[0]), 3), f2_inv(f2_scale(t[1], 2)))
    return f2_mul(f2_sub(q[1], t[1]), f2_inv(f2_sub(q[0], t[0])))


def _g2_step(t, q, lam):
    x = f2_sub(f2_sub(f2_mul(lam, lam), t[0]), q[0])
    return (x, f2_sub(f2_mul(lam, f2_sub(t[0], x)), t[1]))


# -- Fq12 as 12 coefficients ------------------------------------------------


def f12_mul(a, b):
    out = [0] * 23
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                if bj:
                    out[i + j] += ai * bj
    for i in range(22, 11, -1):  # w^12 = 18 w^6 - 82
        c = out[i]
        if c:
            out[i - 6] += 18 * c
            out[i - 12] -= 82 * c
    return [c % Q for c in out[:12]]


ONE12 = [1] + [0] * 11


def f12_pow(a, e):
    out = ONE12
    for bit in bin(e)[2:]:
        out = f12_mul(out, out)
        if bit == "1":
            out = f12_mul(out, a)
    return out


def f12_inv(a):
    """Inverse by the extended Euclidean algorithm on polynomials over Fq."""
    def deg(p):
        d = len(p) - 1
        while d and p[d] == 0:
            d -= 1
        return d

    lm, hm = [1] + [0] * 12, [0] * 13
    low, high = list(a) + [0], [82, 0, 0, 0, 0, 0, -18 % Q, 0, 0, 0, 0, 0, 1]
    while deg(low):
        r = [0] * 13
        rr = list(high)
        inv = pow(low[deg(low)], Q - 2, Q)
        while deg(rr) >= deg(low) and any(rr):
            k = deg(rr) - deg(low)
            c = rr[deg(rr)] * inv % Q
            r[k] = (r[k] + c) % Q
            for i in range(deg(low) + 1):
                rr[i + k] = (rr[i + k] - c * low[i]) % Q
            if deg(rr) == 0 and rr[0] == 0:
                break
        nm = list(hm)
        for i in range(13):
            for j in range(13 - i):
                nm[i + j] = (nm[i + j] - lm[i] * r[j]) % Q
        lm, low, hm, high = nm, rr, lm, low
    inv = pow(low[0], Q - 2, Q)
    return [c * inv % Q for c in lm[:12]]


def _embed(x, shift):
    """The Fq2 element x times w^shift, as 12 coefficients (u = w^6 - 9)."""
    out = [0] * 12
    out[shift] = (x[0] - 9 * x[1]) % Q
    out[shift + 6] = x[1] % Q
    return out


def _line(t, lam, p):
    """l(P) for the line of slope lam through the twist point t."""
    out = _embed(f2_scale(lam, p[0]), 1)
    for i, c in enumerate(_embed(f2_sub(t[1], f2_mul(lam, t[0])), 3)):
        out[i] = (out[i] + c) % Q
    out[0] = (out[0] - p[1]) % Q
    return out


def _vertical(t, p):
    """l(P) = xP - xT w^2 for the vertical line through t."""
    out = [(-c) % Q for c in _embed(t[0], 2)]
    out[0] = (out[0] + p[0]) % Q
    return out


def miller_loop(q, p):
    """f_{6x+2, Q}(P) times the two Frobenius lines, before the final
    exponentiation; 1 where either point is the identity."""
    if q is None or p is None:
        return ONE12
    t, f = q, ONE12
    for i in range(ATE_LOOP.bit_length() - 2, -1, -1):
        lam = _slope(t, t)
        f = f12_mul(f12_mul(f, f), _line(t, lam, p))
        t = _g2_step(t, t, lam)
        if (ATE_LOOP >> i) & 1:
            lam = _slope(t, q)
            f = f12_mul(f, _line(t, lam, p))
            t = _g2_step(t, q, lam)
    q1 = (f2_mul(f2_conj(q[0]), GAMMA_X), f2_mul(f2_conj(q[1]), GAMMA_Y))
    nq2 = (f2_mul(f2_conj(q1[0]), GAMMA_X), f2_sub((0, 0), f2_mul(f2_conj(q1[1]), GAMMA_Y)))
    for nxt in (q1, nq2):
        lam = _slope(t, nxt)
        if lam is None:
            f = f12_mul(f, _vertical(t, p))
            t = None
        else:
            f = f12_mul(f, _line(t, lam, p))
            t = _g2_step(t, nxt, lam)
    return f


def _frobenius_table():
    """w^(i q) for i < 12, so that f^q = sum_i f_i w^(i q)."""
    wq = f12_pow([0, 1] + [0] * 10, Q)
    table, acc = [], ONE12
    for _ in range(12):
        table.append(acc)
        acc = f12_mul(acc, wq)
    return table


_FROB = None


def f12_frobenius(a, times: int = 1):
    global _FROB
    if _FROB is None:
        _FROB = _frobenius_table()
    for _ in range(times):
        out = [0] * 12
        for c, row in zip(a, _FROB):
            if c:
                for j, v in enumerate(row):
                    out[j] += c * v
        a = [v % Q for v in out]
    return a


def final_exponentiation(f):
    """f^((q^12 - 1) / r): the easy part (q^6 - 1)(q^2 + 1) by the
    conjugate (w^(q^6) = -w) and the Frobenius, the hard part
    (q^4 - q^2 + 1) / r by a plain power."""
    conj = [c if i % 2 == 0 else (-c) % Q for i, c in enumerate(f)]
    f = f12_mul(conj, f12_inv(f))
    f = f12_mul(f12_frobenius(f, 2), f)
    return f12_pow(f, (Q ** 4 - Q ** 2 + 1) // R)


def pairing(q, p):
    return final_exponentiation(miller_loop(q, p))


def pairing_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 over (G1, G2) pairs, one final exponentiation."""
    f = ONE12
    for p, q in pairs:
        f = f12_mul(f, miller_loop(q, p))
    return final_exponentiation(f) == ONE12


def groth16_verify(vk: dict, proof: dict, publics) -> bool:
    """e(A, B) = e(alpha, beta) e(vk_x, gamma) e(C, delta), with
    vk_x = IC_0 + sum_i s_i IC_i, on points checked to lie on their curves.
    ``vk``: alpha1, beta2, gamma2, delta2, ic; ``proof``: a, b, c."""
    if len(publics) != len(vk["ic"]) - 1:
        return False
    g1s = [proof["a"], proof["c"], vk["alpha1"], *vk["ic"]]
    g2s = [proof["b"], vk["beta2"], vk["gamma2"], vk["delta2"]]
    if not all(map(g1_on_curve, g1s)) or not all(map(g2_on_curve, g2s)):
        return False
    vk_x = vk["ic"][0]
    for point, s in zip(vk["ic"][1:], publics):
        vk_x = g1_add(vk_x, g1_mul(point, s))
    return pairing_product_is_one([
        (g1_neg(proof["a"]), proof["b"]),
        (vk["alpha1"], vk["beta2"]),
        (vk_x, vk["gamma2"]),
        (proof["c"], vk["delta2"]),
    ])
