"""Extension-field tower for BN254: Fq2 and Fq12.

Used by the pairing-based Groth16 verifier and by G2 arithmetic in the
trusted setup.  Representation follows the classic polynomial-basis layout:

  * ``FQ2  = FQ[u] / (u^2 + 1)``
  * ``FQ12 = FQ[w] / (w^12 - 18 w^6 + 82)``

with the sextic twist ``xi = 9 + u`` satisfying ``xi = w^6`` under the
embedding used by :mod:`zkfl_tpu_torch.field.pairing`.  This matches the conventions
of ffjavascript/snarkjs (reference dependency, package.json:44) so that
exported proofs/keys are interoperable.

Performance note: this layer is host-side verifier code (milliseconds per
pairing); the prover hot path never touches it.
"""

from __future__ import annotations

from .bn254 import FQ

# Modulus coefficients  w^12 = 18 w^6 - 82  (i.e. poly w^12 - 18w^6 + 82).
_FQ12_MOD = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]
_FQ2_MOD = [1, 0]


class FQP:
    """Element of FQ[x]/(modulus), coefficients little-endian."""

    __slots__ = ("coeffs",)
    degree = 0
    mod = ()

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = tuple(c % FQ for c in coeffs)

    # -- ring ops ---------------------------------------------------------
    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, other):
        d = self.degree
        if isinstance(other, int):
            return type(self)([a * other for a in self.coeffs])
        prod = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a == 0:
                continue
            for j, b in enumerate(other.coeffs):
                prod[i + j] += a * b
        # Reduce modulo the defining polynomial.
        for i in range(2 * d - 2, d - 1, -1):
            top = prod[i]
            if top == 0:
                continue
            prod[i] = 0
            for j, m in enumerate(self.mod):
                if m:
                    prod[i - d + j] -= top * m
        return type(self)([c % FQ for c in prod[:d]])

    __rmul__ = __mul__

    def __pow__(self, e):
        result = type(self).one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid over FQ[x]."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.coeffs) + [0]
        high = list(self.mod) + [1]

        def deg(p):
            for i in range(len(p) - 1, -1, -1):
                if p[i] % FQ:
                    return i
            return 0

        def poly_rounded_div(a, b):
            dega, degb = deg(a), deg(b)
            temp = [x for x in a]
            o = [0] * len(a)
            binv = pow(b[degb], FQ - 2, FQ)
            for i in range(dega - degb, -1, -1):
                o[i] = (o[i] + temp[degb + i] * binv) % FQ
                for c in range(degb + 1):
                    temp[c + i] = (temp[c + i] - o[i] * b[c]) % FQ
            return [x % FQ for x in o[: deg(o) + 1]]

        while deg(low):
            r = poly_rounded_div(high, low)
            r += [0] * (d + 1 - len(r))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * r[j]
                    new[i + j] -= low[i] * r[j]
            nm = [x % FQ for x in nm]
            new = [x % FQ for x in new]
            lm, low, hm, high = nm, new, lm, low
        c0inv = pow(low[0], FQ - 2, FQ)
        return type(self)([c * c0inv % FQ for c in lm[:d]])

    def __truediv__(self, other):
        if isinstance(other, int):
            return self * pow(other, FQ - 2, FQ)
        return self * other.inv()

    def __eq__(self, other):
        return type(self) is type(other) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash((type(self).__name__, self.coeffs))

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)

    def __repr__(self):
        return f"{type(self).__name__}{list(self.coeffs)}"


class FQ2(FQP):
    degree = 2
    mod = tuple(_FQ2_MOD)

    def conjugate(self):
        return FQ2([self.coeffs[0], -self.coeffs[1]])


class FQ12(FQP):
    degree = 12
    mod = tuple(_FQ12_MOD)

    def frobenius(self):
        """x -> x^p, via pow (verifier-path only; not perf critical)."""
        return self ** FQ

    def conjugate(self):
        """x -> x^(p^6): negate odd coefficients (since w^(p^6) = -w)."""
        return FQ12([c if i % 2 == 0 else -c for i, c in enumerate(self.coeffs)])
