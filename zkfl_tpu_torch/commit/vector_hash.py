"""Vector hashing and commitment schemes (host reference path).

Mirrors the semantics of src/circuits/training/vector_hash.circom and the
host helpers of tests/full_system_simulation.mjs:139-196 in the reference:

  * vector_hash:      chunked 16-ary Poseidon (VectorHash template, :46-89)
  * sample_hash:      Poseidon(features || label)   (SampleHash, :156)
  * gradient_commitment: Poseidon(VectorHash(g), Poseidon(client_id, round))
                      (GradientCommitment, :195)
  * weight_commitment: VectorHash(weights)  (WeightCommitmentSimple,
                      sgd_verified.circom:157)
  * key_material_commitment: Poseidon(master_key, K_1..K_n)
                      (KeyMaterialCommitment, secure_masked_update.circom:188)
  * derive_pairwise_mask: r_ij[k] = Poseidon(K_ij, round, min, max, k)
                      (PairwiseMaskDerivation, secure_masked_update.circom:55)

Batched device equivalents live in zkfl_tpu_torch/ops/poseidon.py.
"""

from __future__ import annotations

from typing import List, Sequence

from ..field.bn254 import FR
from ..poseidon.reference import poseidon as _poseidon_py

CHUNK_SIZE = 16


def poseidon(inputs: Sequence[int]) -> int:
    """Poseidon hash; native C++ batch kernel when built, Python fallback."""
    from .. import native

    if native.available():
        return native.poseidon_batch([[v % FR for v in inputs]])[0]
    return _poseidon_py(inputs)


def vector_hash_many(rows: Sequence[Sequence[int]]) -> List[int]:
    """Batched VectorHash of equal-dim rows (native path when available) —
    the host-side hot loop of dataset commitment (one call for all N
    samples instead of N WASM invocations in the reference)."""
    from .. import native

    rows = [[v % FR for v in row] for row in rows]
    if native.available():
        return native.vector_hash_batch(rows)
    return [vector_hash(row) for row in rows]


def vector_hash(values: Sequence[int]) -> int:
    vals = [v % FR for v in values]
    if len(vals) <= CHUNK_SIZE:
        return poseidon(vals)
    chunk_hashes = [poseidon(vals[i : i + CHUNK_SIZE]) for i in range(0, len(vals), CHUNK_SIZE)]
    return poseidon(chunk_hashes)


def sample_hash(features: Sequence[int], label: int) -> int:
    return vector_hash(list(features) + [label])


def gradient_commitment(gradient: Sequence[int], client_id: int, round_num: int) -> int:
    grad_hash = vector_hash(gradient)
    meta_hash = poseidon([client_id, round_num])
    return poseidon([grad_hash, meta_hash])


def weight_commitment(weights: Sequence[int]) -> int:
    return vector_hash(weights)


def key_material_commitment(master_key: int, shared_keys: Sequence[int]) -> int:
    return poseidon([master_key] + list(shared_keys))


def derive_pairwise_mask(shared_key: int, round_num: int, client_id: int, peer_id: int, dim: int):
    lo, hi = min(client_id, peer_id), max(client_id, peer_id)
    return [poseidon([shared_key, round_num, lo, hi, k]) for k in range(dim)]


def to_field(x: int) -> int:
    """Signed int -> canonical field element (negatives wrap mod FR)."""
    return x % FR


def from_field(x: int) -> int:
    """Field element -> signed int, treating values > p/2 as negative."""
    x %= FR
    return x - FR if x > FR // 2 else x
