"""Poseidon Merkle trees (host reference path).

Matches the reference host implementation exactly
(tests/full_system_simulation.mjs:198-238):
  * leaves padded to 2^depth with Poseidon(0) (the E2E convention; the
    reference's alternative VectorHash(zero-vector) padding in
    balance_integration_test.mjs is a known inconsistency we deliberately do
    not model — see SURVEY.md §"quirks").
  * parent = Poseidon(left, right)
  * proofs are (siblings, path_indices) with path bit = index parity per
    level, 0 = current node is the left child.
"""

from __future__ import annotations

from typing import List, Sequence

from ..poseidon.reference import poseidon


class MerkleTree:
    def __init__(self, leaf_hashes: Sequence[int], depth: int):
        padded = 1 << depth
        if len(leaf_hashes) > padded:
            raise ValueError(f"{len(leaf_hashes)} leaves exceed 2^{depth}")
        zero = poseidon([0])
        leaves = list(leaf_hashes) + [zero] * (padded - len(leaf_hashes))
        from .. import native

        if native.available() and padded > 1:
            levels = native.merkle_levels(leaves)
        else:
            levels: List[List[int]] = [leaves]
            cur = leaves
            while len(cur) > 1:
                cur = [poseidon([cur[i], cur[i + 1]]) for i in range(0, len(cur), 2)]
                levels.append(cur)
        self.depth = depth
        self.levels = levels

    @property
    def root(self) -> int:
        return self.levels[-1][0]

    def prove(self, leaf_idx: int):
        siblings, path = [], []
        idx = leaf_idx
        for level in range(self.depth):
            siblings.append(self.levels[level][idx ^ 1])
            path.append(idx & 1)
            idx >>= 1
        return siblings, path


def verify_merkle_path(leaf: int, siblings: Sequence[int], path_indices: Sequence[int], root: int) -> bool:
    cur = leaf
    for sib, bit in zip(siblings, path_indices):
        cur = poseidon([sib, cur] if bit else [cur, sib])
    return cur == root
