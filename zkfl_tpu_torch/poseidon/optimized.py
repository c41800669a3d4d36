"""The optimized form of the width-t Poseidon permutation, derived from
``poseidon_params(t)`` in exact Fr arithmetic.

The form is that of the Poseidon paper (Grassi et al., USENIX Security 2021,
Appendix B) and of circomlib's ``poseidon.circom`` with its C, S, M and P
constants; it computes the same permutation as ``reference.py`` with far
fewer products in the partial rounds.  With h = R_F / 2 and x^5 the S-box:

    s += c0
    h full rounds r:     s = x^5 on every lane; s += d_r; s = M s
                         (the last of them mixes with P instead of M)
    R_P partial rounds:  s_0 = s_0^5 + k; then the sparse mix
                         s_0 = row . s,  s_i = s_i + col_{i-1} s_0 (i >= 1)
    h full rounds r:     s = x^5 on every lane; s += d_r (not after the
                         last); s = M s

Derivation from the dense rounds s = M x^5(s + c_r):
  * every round constant after the first moves behind the previous round's
    S-box through M^-1 (d_r = M^-1 c_{r+1});
  * in the partial rounds only lane 0 passes the S-box, so the other lanes
    of each d move backwards through M^-1 into the round before, from the
    last partial round to the first; what is left is one scalar k per
    partial round, and the rest lands in the last first-half d;
  * each partial round's matrix A = [[a00, a], [b, Â]] factors as
    S · D with D = diag(1, Â), which commutes with the S-box on lane 0 and
    with k, and the sparse S = [[a00, a Â^-1], [b, I]]; D moves into the
    round before (A_prev = D M), and the first partial round's D gives
    P = D M.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from ..field.bn254 import FR
from .grain import R_F, partial_rounds, poseidon_params


def _inv_matrix(a):
    """Inverse of a square matrix over Fr (Gauss-Jordan); raises if singular."""
    n = len(a)
    m = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(a)]
    for col in range(n):
        piv = next((r for r in range(col, n) if m[r][col] % FR), None)
        if piv is None:
            raise ValueError("singular matrix")
        m[col], m[piv] = m[piv], m[col]
        inv = pow(m[col][col], FR - 2, FR)
        m[col] = [v * inv % FR for v in m[col]]
        for r in range(n):
            if r != col and m[r][col]:
                f = m[r][col]
                m[r] = [(v - f * w) % FR for v, w in zip(m[r], m[col])]
    return [row[n:] for row in m]


def _mat_vec(a, v):
    return [sum(x * y for x, y in zip(row, v)) % FR for row in a]


def _mat_mul(a, b):
    cols = list(zip(*b))
    return [[sum(x * y for x, y in zip(row, col)) % FR for col in cols] for row in a]


@dataclass(frozen=True)
class OptimizedParams:
    """Constants of the optimized permutation (standard-form Fr ints).

    c0: t; first: h vectors d (after the S-box of each first-half full
    round); partial: R_P tuples (k, row of t, col of t - 1); last: h - 1
    vectors d (after the S-box of each second-half full round but the
    last); M and P: t x t."""

    c0: tuple
    first: tuple
    partial: tuple
    last: tuple
    M: tuple
    P: tuple

    def kernel_buffers(self):
        """K5's two constant buffers as flat lists of elements: c = c0,
        first, the R_P scalars k, last; m = M, P, then per partial round its
        row and its column."""
        c = list(self.c0) + [v for d in self.first for v in d] + [k for k, _, _ in self.partial]
        c += [v for d in self.last for v in d]
        m = [v for row in self.M for v in row] + [v for row in self.P for v in row]
        for _, row, col in self.partial:
            m += list(row) + list(col)
        return c, m


@lru_cache(maxsize=32)
def optimized_params(t: int) -> OptimizedParams:
    C, M = poseidon_params(t)
    rp, h = partial_rounds(t), R_F // 2
    n_rounds = R_F + rp
    minv = _inv_matrix(M)
    # d_r = M^-1 c_{r+1}: the constant of round r + 1 added before round r's mix.
    d = [_mat_vec(minv, C[(r + 1) * t:(r + 2) * t]) for r in range(n_rounds - 1)] + [[0] * t]
    for r in range(h + rp - 1, h - 1, -1):
        rest = [0] + d[r][1:]
        d[r] = [d[r][0]] + [0] * (t - 1)
        d[r - 1] = [(x + y) % FR for x, y in zip(d[r - 1], _mat_vec(minv, rest))]

    partial = [None] * rp
    cur = [list(row) for row in M]
    for j in range(rp - 1, -1, -1):
        inner = [row[1:] for row in cur[1:]]
        row = [cur[0][0]] + _mat_vec(list(zip(*_inv_matrix(inner))), cur[0][1:])
        col = [cur[i][0] for i in range(1, t)]
        partial[j] = (d[h + j][0], tuple(row), tuple(col))
        dmat = [[1] + [0] * (t - 1)] + [[0] + inner[i - 1] for i in range(1, t)]
        cur = _mat_mul(dmat, M)
    return OptimizedParams(
        c0=tuple(C[:t]),
        first=tuple(tuple(d[r]) for r in range(h)),
        partial=tuple(partial),
        last=tuple(tuple(d[r]) for r in range(h + rp, n_rounds - 1)),
        M=tuple(tuple(row) for row in M),
        P=tuple(tuple(row) for row in cur),
    )


def permute_optimized(state):
    """The permutation of ``state`` (t ints) through the optimized constants."""
    t = len(state)
    o = optimized_params(t)
    h = R_F // 2
    s = [(x + c) % FR for x, c in zip(state, o.c0)]

    def full(s, d, mat):
        s = [pow(x, 5, FR) for x in s]
        if d is not None:
            s = [(x + y) % FR for x, y in zip(s, d)]
        return _mat_vec(mat, s)

    for r in range(h):
        s = full(s, o.first[r], o.P if r == h - 1 else o.M)
    for k, row, col in o.partial:
        s[0] = (pow(s[0], 5, FR) + k) % FR
        s = [sum(x * y for x, y in zip(row, s)) % FR] + [
            (s[i] + col[i - 1] * s[0]) % FR for i in range(1, t)]
    for r in range(h):
        s = full(s, o.last[r] if r < h - 1 else None, o.M)
    return s
