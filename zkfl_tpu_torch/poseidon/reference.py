"""Pure-Python Poseidon permutation/hash over BN254-Fr.

Bit-exact mirror of circomlibjs `buildPoseidon()` as used by the reference
host code (tests/full_system_simulation.mjs:134-137).  The batched device
permutation in zkfl_tpu_torch/ops/poseidon.py is validated against this module, which in turn
is validated against the reference's committed vectors.

Structure (unoptimised datapath; identical output to circomlib's optimised
circuit form):
  state = [0, in_0, .., in_{n-1}]   (t = n + 1, capacity slot 0)
  for each of R_F + R_P rounds:  add round constants; x^5 S-box (all lanes in
  full rounds, lane 0 only in partial rounds); multiply by the MDS matrix.
  output = state[0].
"""

from __future__ import annotations

from ..field.bn254 import FR
from .grain import R_F, partial_rounds, poseidon_params


def poseidon_permutation(state):
    t = len(state)
    C, M = poseidon_params(t)
    rp = partial_rounds(t)
    rf_half = R_F // 2
    s = [x % FR for x in state]
    idx = 0
    for r in range(R_F + rp):
        s = [(x + C[idx + i]) % FR for i, x in enumerate(s)]
        idx += t
        if r < rf_half or r >= rf_half + rp:
            s = [pow(x, 5, FR) for x in s]
        else:
            s[0] = pow(s[0], 5, FR)
        s = [sum(M[i][j] * s[j] for j in range(t)) % FR for i in range(t)]
    return s


def poseidon(inputs):
    """Poseidon hash of 1..16 field elements (circomlibjs-compatible)."""
    n = len(inputs)
    if not 1 <= n <= 16:
        raise ValueError(f"poseidon arity must be 1..16, got {n}")
    state = [0] + [x % FR for x in inputs]
    return poseidon_permutation(state)[0]
