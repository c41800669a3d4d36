"""The commitments that every traffic kind's plain round uses: vector
hashes, Poseidon-Merkle roots and the gradient commitment, as the
reference project computes them.

Each traffic kind's plain round is a module ``zkbench/plain/<kind>.py``
with ``expect(config, seed)``: what one round should produce, worked out
from the configuration and the round's seed alone, apart from the
program under test.
"""

from __future__ import annotations

from .poseidon import R, poseidon

MASK_31 = 0x7FFFFFFF  # the reference's 31-bit LCG


def vector_hash(values) -> int:
    """Poseidon of up to 16 values; longer vectors hash in chunks of 16,
    then the chunk hashes."""
    vals = [v % R for v in values]
    if len(vals) <= 16:
        return poseidon(vals)
    return poseidon([poseidon(vals[i:i + 16]) for i in range(0, len(vals), 16)])


def merkle_root(leaves, depth: int) -> int:
    """Poseidon(left, right) tree over the leaves padded to 2^depth with
    Poseidon(0)."""
    level = list(leaves) + [poseidon([0])] * ((1 << depth) - len(leaves))
    while len(level) > 1:
        level = [poseidon(level[i:i + 2]) for i in range(0, len(level), 2)]
    return level[0]


def gradient_commitment(gradient, client_id: int, round_num: int) -> int:
    return poseidon([vector_hash(gradient), poseidon([client_id, round_num])])
