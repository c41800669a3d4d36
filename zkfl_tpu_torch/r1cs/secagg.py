"""Component C: secure-aggregation masking proof.

Native re-expression of SecureMaskedUpdate(DIM, NUM_PEERS)
(src/circuits/secureagg/secure_masked_update.circom:231-360):
  1. gradient commitment == root_G           (:253-262)
  2. key-material commitment == root_K       (:264-272)
  3. gradient norm bound (LessEqThan(128))   (:274-281)
  4. pairwise PRF masks with canonical min/max ordering, sign +1 iff i<j,
     accumulated onto the gradient          (:283-326)
  5. masked_update equality                  (:328-333)
  6. root_D/root_W inclusion-only binding    (:335-342)

Public signals: [client_id, round, root_D, root_G, root_W, root_K,
tauSquared, masked_update[DIM], peer_ids[NUM_PEERS]].
"""

from __future__ import annotations

from dataclasses import dataclass

from .builder import ConstraintSystem
from .gadgets import (
    gradient_commitment_gadget,
    less_eq_than,
    less_than,
    poseidon_gadget,
)


@dataclass(frozen=True)
class SecaggParams:
    dim: int = 4
    num_peers: int = 2

    @property
    def name(self) -> str:
        return f"secure_masked_update_{self.dim}_{self.num_peers}"


def build_secagg(params: SecaggParams, inputs: dict, witness_only: bool = False) -> ConstraintSystem:
    cs = ConstraintSystem(name=params.name, witness_only=witness_only)
    DIM, PEERS = params.dim, params.num_peers

    client_id = cs.public_input("client_id", int(inputs["client_id"]))
    round_num = cs.public_input("round", int(inputs["round"]))
    root_d = cs.public_input("root_D", int(inputs["root_D"]))
    root_g = cs.public_input("root_G", int(inputs["root_G"]))
    root_w = cs.public_input("root_W", int(inputs["root_W"]))
    root_k = cs.public_input("root_K", int(inputs["root_K"]))
    tau_squared = cs.public_input("tauSquared", int(inputs["tauSquared"]))
    masked_update = cs.public_inputs("masked_update", [int(x) for x in inputs["masked_update"]])
    peer_ids = cs.public_inputs("peer_ids", [int(x) for x in inputs["peer_ids"]])

    gradient = cs.private_inputs("gradient", [int(x) for x in inputs["gradient"]])
    master_key = cs.private_input("master_key", int(inputs["master_key"]))
    shared_keys = cs.private_inputs("shared_keys", [int(x) for x in inputs["shared_keys"]])

    # STEP 1: gradient commitment binding to the training proof.
    cs.enforce_equal(root_g, gradient_commitment_gadget(cs, gradient, client_id, round_num))

    # STEP 2: key-material commitment: Poseidon(master_key, K_1..K_n).
    cs.enforce_equal(root_k, poseidon_gadget(cs, [master_key] + shared_keys))

    # STEP 3: norm bound (GradientNormBound, LessEqThan(128)).
    norm_sq = cs.zero()
    for k in range(DIM):
        norm_sq = norm_sq + cs.square(gradient[k])
    cs.enforce_equal(less_eq_than(cs, norm_sq, tau_squared, 128), cs.one())

    # STEP 4: derive masks and accumulate.
    accumulated = list(gradient)
    for j in range(PEERS):
        # Canonical ordering via LessThan(64) mux (PairwiseMaskDerivation).
        lt = less_than(cs, client_id, peer_ids[j], 64)
        min_id = cs.mul(lt, client_id) + cs.mul(cs.one() - lt, peer_ids[j])
        max_id = cs.mul(lt, peer_ids[j]) + cs.mul(cs.one() - lt, client_id)
        # Sign: +1 iff client_id < peer_id  (SignDetermination reuses the
        # same comparison; sign multiplier = 2*lt - 1).
        sign = lt * 2 - 1
        for k in range(DIM):
            mask_k = poseidon_gadget(
                cs, [shared_keys[j], round_num, min_id, max_id, cs.constant(k)]
            )
            accumulated[k] = accumulated[k] + cs.mul(sign, mask_k)

    # STEP 5: masked update equality.
    for k in range(DIM):
        cs.enforce_equal(masked_update[k], accumulated[k])

    # STEP 6: binding inclusion (root_D * 0 + root_W * 0 == 0).
    cs.enforce_zero(root_d * 0 + root_w * 0)
    return cs


# ---------------------------------------------------------------------------
# Legacy single-mask variant (Component C11).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SecaggLegacyParams:
    """secure_agg_client.circom's MainWrapper is fixed at DIM=8 (:116-163);
    kept parametric here with dim=8 as the reference instantiation."""

    dim: int = 8

    @property
    def name(self) -> str:
        return f"secure_agg_client_{self.dim}"


def derive_legacy_mask(prf_seed: int, client_id: int, dim: int):
    """Host-side PRFDerivation mirror: mask[i] = Poseidon(seed, id*DIM + i)
    (secure_agg_client.circom:7-19)."""
    from ..commit.vector_hash import poseidon

    return [poseidon([prf_seed, client_id * dim + i]) for i in range(dim)]


def build_secagg_legacy(
    params: SecaggLegacyParams, inputs: dict, witness_only: bool = False
) -> ConstraintSystem:
    """Legacy additive single-mask circuit
    (src/circuits/secureagg/secure_agg_client.circom:7-163):

      1. GradientBoundednessProof (:21-43): norm^2 <= tau^2 via LessThan(252)
         against tau^2 + 1.
      2. MaskDerivationProof (:45-65): shared_key_hash == Poseidon(seed);
         mask[i] == Poseidon(seed, client_id*DIM + i)  (PRFDerivation :7-19).
      3. MaskingCorrectnessProof (:67-75): masked_update = gradient + mask
         (additive, no pairwise sign).
      4. root_G == VectorHash(gradient)  (AggregationWellFormenessProof
         :109-113 — note: plain VectorHash, not GradientCommitment).

    Public signals (MainWrapper :156-163): [client_id, shared_key_hash,
    root_G, tauSquared, masked_update[DIM] (scalar-unrolled in the
    reference)].
    """
    from .gadgets import vector_hash_gadget

    cs = ConstraintSystem(name=params.name, witness_only=witness_only)
    DIM = params.dim

    client_id = cs.public_input("client_id", int(inputs["client_id"]))
    shared_key_hash = cs.public_input("shared_key_hash", int(inputs["shared_key_hash"]))
    root_g = cs.public_input("root_G", int(inputs["root_G"]))
    tau_squared = cs.public_input("tauSquared", int(inputs["tauSquared"]))
    masked_update = cs.public_inputs(
        "masked_update", [int(x) for x in inputs["masked_update"]]
    )

    gradient = cs.private_inputs("gradient", [int(x) for x in inputs["gradient"]])
    mask = cs.private_inputs("mask", [int(x) for x in inputs["mask"]])
    prf_seed = cs.private_input("prf_seed", int(inputs["prf_seed"]))

    # 1. GradientBoundednessProof: running-sum of squares, LessThan(252).
    norm_sq = cs.zero()
    for k in range(DIM):
        norm_sq = norm_sq + cs.square(gradient[k])
    cs.enforce_equal(less_than(cs, norm_sq, tau_squared + 1, 252), cs.one())

    # 2. MaskDerivationProof: seed commitment + PRF re-derivation.
    cs.enforce_equal(shared_key_hash, poseidon_gadget(cs, [prf_seed]))
    for i in range(DIM):
        prf_i = poseidon_gadget(cs, [prf_seed, client_id * DIM + i])
        cs.enforce_equal(mask[i], prf_i)

    # 3. MaskingCorrectnessProof: additive masking.
    for i in range(DIM):
        cs.enforce_equal(masked_update[i], gradient[i] + mask[i])

    # 4. Gradient commitment: plain VectorHash (no client/round binding).
    cs.enforce_equal(root_g, vector_hash_gadget(cs, gradient))
    return cs
