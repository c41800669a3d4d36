"""QAP machinery: radix-2 NTT over FR and constraint-matrix evaluation.

Pure-Python reference path (micro circuits + oracle for the device NTT in
zkfl_tpu_torch/ops/qap.py).  Replaces the FFT inside `snarkjs groth16 prove`
(reference hot path, SURVEY.md §3.3).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ..field.bn254 import FR, FR_GENERATOR, fr_inv, fr_nth_root


def bit_reverse_permute(a: List[int]) -> List[int]:
    n = len(a)
    bits = n.bit_length() - 1
    out = [0] * n
    for i in range(n):
        out[int(format(i, f"0{bits}b")[::-1], 2)] = a[i]
    return out


def ntt(a: Sequence[int], inverse: bool = False) -> List[int]:
    """In-order radix-2 NTT over FR; len(a) must be a power of two."""
    n = len(a)
    assert n & (n - 1) == 0
    out = bit_reverse_permute([x % FR for x in a])
    length = 2
    while length <= n:
        w_len = fr_nth_root(length)
        if inverse:
            w_len = fr_inv(w_len)
        half = length // 2
        for start in range(0, n, length):
            w = 1
            for k in range(half):
                u = out[start + k]
                v = out[start + k + half] * w % FR
                out[start + k] = (u + v) % FR
                out[start + k + half] = (u - v) % FR
                w = w * w_len % FR
        length <<= 1
    if inverse:
        n_inv = fr_inv(n)
        out = [x * n_inv % FR for x in out]
    return out


def coset_ntt(coeffs: Sequence[int], shift: int = FR_GENERATOR) -> List[int]:
    """Evaluate polynomial on the coset shift * <omega>."""
    scaled = []
    s = 1
    for c in coeffs:
        scaled.append(c * s % FR)
        s = s * shift % FR
    return ntt(scaled)


def coset_intt(evals: Sequence[int], shift: int = FR_GENERATOR) -> List[int]:
    coeffs = ntt(evals, inverse=True)
    s_inv = fr_inv(shift)
    out = []
    s = 1
    for c in coeffs:
        out.append(c * s % FR)
        s = s * s_inv % FR
    return out


def matrix_evals(
    constraints: Sequence[Tuple[Dict[int, int], Dict[int, int], Dict[int, int]]],
    witness: Sequence[int],
    domain: int,
) -> Tuple[List[int], List[int], List[int]]:
    """Per-constraint evaluations  a_j = A_j . s  etc., zero-padded to the
    FFT domain.  This is the sparse-matvec step of the prover."""
    a = [0] * domain
    b = [0] * domain
    c = [0] * domain
    for j, (A, B, C) in enumerate(constraints):
        a[j] = sum(coef * witness[w] for w, coef in A.items()) % FR
        b[j] = sum(coef * witness[w] for w, coef in B.items()) % FR
        c[j] = sum(coef * witness[w] for w, coef in C.items()) % FR
    return a, b, c


def compute_podd(a_evals, b_evals, c_evals=None) -> List[int]:
    """(A.B - C) evaluated at the ODD 2n-th roots w_{2n}^{2k+1} — the MSM
    scalars snarkjs's prover pairs with its Lagrange-basis H points
    (ProvingKey.h_basis == "odd_evals"; see setup.odd_lagrange_h_scalars).

    `c_evals=None` recovers C's domain evaluations as A.B pointwise — valid
    because a satisfying witness has C_k = A_k B_k on the domain, which is
    why snarkjs zkeys store no C matrix (section 4 holds A and B only)."""
    n = len(a_evals)
    if c_evals is None:
        c_evals = [x * y % FR for x, y in zip(a_evals, b_evals)]
    w2 = fr_nth_root(2 * n)
    a_odd = coset_ntt(ntt(a_evals, inverse=True), shift=w2)
    b_odd = coset_ntt(ntt(b_evals, inverse=True), shift=w2)
    c_odd = coset_ntt(ntt(c_evals, inverse=True), shift=w2)
    return [(x * y - z) % FR for x, y, z in zip(a_odd, b_odd, c_odd)]


def compute_h_coeffs(a_evals, b_evals, c_evals) -> List[int]:
    """Coefficients of h(X) = (a(X) b(X) - c(X)) / Z(X), deg <= n-2.

    Uses the coset trick: on the coset g<omega>, Z(g w^k) = g^n - 1 is a
    nonzero constant, so the division is a scalar multiply.
    """
    n = len(a_evals)
    a_c = ntt(a_evals, inverse=True)
    b_c = ntt(b_evals, inverse=True)
    c_c = ntt(c_evals, inverse=True)
    a_s = coset_ntt(a_c)
    b_s = coset_ntt(b_c)
    c_s = coset_ntt(c_c)
    z_inv = fr_inv((pow(FR_GENERATOR, n, FR) - 1) % FR)
    h_s = [(x * y - z) * z_inv % FR for x, y, z in zip(a_s, b_s, c_s)]
    h_c = coset_intt(h_s)
    # deg h = n - 2, so the top coefficient must vanish for satisfied systems.
    return h_c
