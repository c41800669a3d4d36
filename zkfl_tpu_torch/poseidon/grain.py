"""Grain-LFSR generation of Poseidon round constants and MDS matrices.

circomlib's `poseidon_constants.circom` (included by the reference circuits
via src/circuits/lib/poseidon.circom:17) hardcodes constants that were
produced by the official Poseidon reference script
(`generate_parameters_grain.sage`, Grassi et al. 2019) for the BN254 scalar
field, alpha = 5, R_F = 8, and t-dependent R_P.  We regenerate them from the
published algorithm instead of copying the tables; bit-exactness against
circomlibjs is pinned by test vectors (tests/test_poseidon.py) and by the
committed Merkle roots in the reference's data/test_input_v5.json.

Grain LFSR (80-bit state):
  * init state  = field(2b) || sbox(4b) || n(12b) || t(12b) || R_F(10b)
                  || R_P(10b) || 1^30   (each field big-endian)
  * update      = b62 ^ b51 ^ b38 ^ b23 ^ b13 ^ b0 appended, b0 dropped
  * discard 160 update rounds, then output via self-shrinking: per output
    bit draw a pair (b1, b2); emit b2 iff b1 == 1.
  * field elements: draw n=254 bits MSB-first, rejection-sample < p.
"""

from __future__ import annotations

from functools import lru_cache

from ..field.bn254 import FR

N_BITS = 254
R_F = 8
# circomlib N_ROUNDS_P for t = 2 .. 17.
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]


def partial_rounds(t: int) -> int:
    return N_ROUNDS_P[t - 2]


class GrainLFSR:
    def __init__(self, t: int):
        bits = []
        for value, width in ((1, 2), (0, 4), (N_BITS, 12), (t, 12), (R_F, 10), (partial_rounds(t), 10)):
            bits.extend(int(b) for b in format(value, f"0{width}b"))
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits

    def _raw_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def warm_up(self):
        for _ in range(160):
            self._raw_bit()

    def bit(self) -> int:
        # Self-shrinking generator.
        while True:
            b1 = self._raw_bit()
            b2 = self._raw_bit()
            if b1 == 1:
                return b2

    def field_element(self) -> int:
        """Round-constant draw: 254 bits MSB-first, rejection-sampled < p."""
        while True:
            v = 0
            for _ in range(N_BITS):
                v = (v << 1) | self.bit()
            if v < FR:
                return v

    def raw_field_element(self) -> int:
        """MDS draw: 254 raw bits reduced mod p (no rejection)."""
        v = 0
        for _ in range(N_BITS):
            v = (v << 1) | self.bit()
        return v % FR


@lru_cache(maxsize=32)
def poseidon_params(t: int):
    """(C, M) for the Poseidon permutation of width t over FR.

    C: flat list of (R_F + R_P(t)) * t round constants (round-major),
       rejection-sampled from the Grain stream.
    M: t x t MDS matrix, Cauchy-form M[i][j] = (x_i + y_j)^-1, with the
       x/y coordinates drawn from the SAME stream continuing after the round
       constants, without rejection (raw 254-bit values mod p).  This exact
       recipe reproduces circomlib's POSEIDON_C/POSEIDON_M bit-for-bit
       (pinned by tests/test_poseidon.py).
    """
    rp = partial_rounds(t)

    g = GrainLFSR(t)
    g.warm_up()
    consts = [g.field_element() for _ in range((R_F + rp) * t)]

    xs = [g.raw_field_element() for _ in range(t)]
    ys = [g.raw_field_element() for _ in range(t)]
    mds = [[pow((xs[i] + ys[j]) % FR, FR - 2, FR) for j in range(t)] for i in range(t)]
    return consts, mds
