"""Component B: training-integrity proofs.

Native re-expressions of:
  * TrainingStepVerified(BATCH_SIZE, MODEL_DIM, DEPTH, PRECISION)
    (src/circuits/training/sgd_verified.circom:230-316) — the E2E circuit
    with in-circuit linear-regression gradient recomputation.
  * TrainingStepV5(BATCH_SIZE, MODEL_DIM, DEPTH)
    (src/circuits/training/sgd_step_v5.circom:86-168) — sound clipping +
    overflow range checks, no gradient correctness.
  * TrainingStepQuick — v5 minus the range checks
    (src/circuits/training/sgd_step_quick.circom).

Range-check hygiene note (SURVEY.md quirks): sgd_verified's LessThan(64)
remainder checks assume non-negative operands; v5 adds explicit 2^30/2^60
bounds.  We keep each variant's public interface and constraint semantics
faithful so reference-generated inputs (data/test_input_v5.json) satisfy the
regenerated systems.
"""

from __future__ import annotations

from dataclasses import dataclass

from .builder import ConstraintSystem, LinComb
from .gadgets import (
    gradient_commitment_gadget,
    less_than,
    merkle_proof_gadget,
    vector_hash_gadget,
)


@dataclass(frozen=True)
class TrainingParams:
    batch_size: int = 8
    model_dim: int = 4
    depth: int = 3
    precision: int = 1000
    variant: str = "verified"  # "verified" | "v5" | "quick"

    @property
    def name(self) -> str:
        return f"sgd_{self.variant}_{self.batch_size}_{self.model_dim}_{self.depth}"


def _clipping_sound(cs, grad_pos, grad_neg, tau_squared, bits: int):
    """VerifyClippingSound (sgd_verified.circom:168-209 with LessThan(64);
    sgd_step_v5.circom:38-84 with LessThan(128))."""
    dim = len(grad_pos)
    norm_sq = cs.zero()
    for j in range(dim):
        cs.enforce(grad_pos[j], grad_neg[j], cs.zero())  # pos*neg == 0
        norm_sq = norm_sq + cs.square(grad_pos[j]) + cs.square(grad_neg[j])
    valid = less_than(cs, norm_sq, tau_squared + 1, bits)
    cs.enforce_equal(valid, cs.one())
    gradient = [grad_pos[j] - grad_neg[j] for j in range(dim)]
    return gradient, norm_sq


def _batch_membership(cs, features, labels, siblings, path_indices, root_d):
    """Leaf = VectorHash(features || label), BatchMerkleProofPreHashed."""
    for i in range(len(features)):
        leaf = vector_hash_gadget(cs, features[i] + [labels[i]])
        merkle_proof_gadget(cs, leaf, siblings[i], path_indices[i], root_d)


def build_training_verified(params: TrainingParams, inputs: dict, witness_only: bool = False) -> ConstraintSystem:
    """sgd_verified: the five-step E2E training circuit."""
    cs = ConstraintSystem(name=params.name, witness_only=witness_only)
    B, DIM, DEPTH, P = params.batch_size, params.model_dim, params.depth, params.precision

    client_id = cs.public_input("client_id", int(inputs["client_id"]))
    round_num = cs.public_input("round", int(inputs["round"]))
    root_d = cs.public_input("root_D", int(inputs["root_D"]))
    root_g = cs.public_input("root_G", int(inputs["root_G"]))
    root_w = cs.public_input("root_W", int(inputs["root_W"]))
    tau_squared = cs.public_input("tauSquared", int(inputs["tauSquared"]))

    weights = cs.private_inputs("weights", [int(x) for x in inputs["weights"]])
    summed_grad = cs.private_inputs("expectedSummedGrad", [int(x) for x in inputs["expectedSummedGrad"]])
    remainder = cs.private_inputs("remainder", [int(x) for x in inputs["remainder"]])
    grad_pos = cs.private_inputs("gradPos", [int(x) for x in inputs["gradPos"]])
    grad_neg = cs.private_inputs("gradNeg", [int(x) for x in inputs["gradNeg"]])
    features = [cs.private_inputs(f"features[{i}]", [int(x) for x in inputs["features"][i]]) for i in range(B)]
    labels = cs.private_inputs("labels", [int(x) for x in inputs["labels"]])
    siblings = [cs.private_inputs(f"siblings[{i}]", [int(x) for x in inputs["siblings"][i]]) for i in range(B)]
    path_indices = [
        cs.private_inputs(f"pathIndices[{i}]", [int(x) for x in inputs["pathIndices"][i]]) for i in range(B)
    ]

    # STEP 1: weight commitment (WeightCommitmentSimple = VectorHash).
    cs.enforce_equal(root_w, vector_hash_gadget(cs, weights))

    # STEP 2: batch membership.
    _batch_membership(cs, features, labels, siblings, path_indices, root_d)

    # STEP 3: sound clipping (64-bit comparator in this variant).
    gradient, _ = _clipping_sound(cs, grad_pos, grad_neg, tau_squared, bits=64)

    # STEP 4: gradient correctness (VerifyGradientCorrectness :83-154).
    divisor = B * P
    computed_sum = [cs.zero() for _ in range(DIM)]
    for i in range(B):
        # prediction_i = weights . features_i
        pred = cs.zero()
        for j in range(DIM):
            pred = pred + cs.mul(features[i][j], weights[j])
        err = pred - labels[i] * P
        for j in range(DIM):
            computed_sum[j] = computed_sum[j] + cs.mul(err, features[i][j])
    for j in range(DIM):
        cs.enforce_equal(summed_grad[j], computed_sum[j])
        lt = less_than(cs, remainder[j], cs.constant(divisor), 64)
        cs.enforce_equal(lt, cs.one())
        cs.enforce_equal(summed_grad[j], gradient[j] * divisor + remainder[j])

    # STEP 5: gradient commitment.
    cs.enforce_equal(root_g, gradient_commitment_gadget(cs, gradient, client_id, round_num))

    cs.enforce_zero(client_id * 0)
    return cs


def build_training_v5(params: TrainingParams, inputs: dict, witness_only: bool = False) -> ConstraintSystem:
    """sgd_step_v5 (and the 'quick' variant when params.variant == 'quick',
    which drops the overflow range checks)."""
    cs = ConstraintSystem(name=params.name, witness_only=witness_only)
    B, DIM = params.batch_size, params.model_dim

    client_id = cs.public_input("client_id", int(inputs["client_id"]))
    round_num = cs.public_input("round", int(inputs["round"]))
    root_d = cs.public_input("root_D", int(inputs["root_D"]))
    root_g = cs.public_input("root_G", int(inputs["root_G"]))
    tau_squared = cs.public_input("tauSquared", int(inputs["tauSquared"]))

    grad_pos = cs.private_inputs("gradPos", [int(x) for x in inputs["gradPos"]])
    grad_neg = cs.private_inputs("gradNeg", [int(x) for x in inputs["gradNeg"]])
    features = [cs.private_inputs(f"features[{i}]", [int(x) for x in inputs["features"][i]]) for i in range(B)]
    labels = cs.private_inputs("labels", [int(x) for x in inputs["labels"]])
    siblings = [cs.private_inputs(f"siblings[{i}]", [int(x) for x in inputs["siblings"][i]]) for i in range(B)]
    path_indices = [
        cs.private_inputs(f"pathIndices[{i}]", [int(x) for x in inputs["pathIndices"][i]]) for i in range(B)
    ]

    # STEP 1: batch membership.
    _batch_membership(cs, features, labels, siblings, path_indices, root_d)

    # STEP 2: sound clipping with 128-bit comparator.
    gradient, _ = _clipping_sound(cs, grad_pos, grad_neg, tau_squared, bits=128)

    # STEP 2b: overflow range checks (v5 only; sgd_step_v5.circom:130-152).
    if params.variant == "v5":
        max_grad = 1 << 30
        for j in range(DIM):
            cs.enforce_equal(less_than(cs, grad_pos[j], cs.constant(max_grad), 64), cs.one())
            cs.enforce_equal(less_than(cs, grad_neg[j], cs.constant(max_grad), 64), cs.one())
        cs.enforce_equal(less_than(cs, tau_squared, cs.constant(1 << 60), 80), cs.one())

    # STEP 3: gradient commitment.
    cs.enforce_equal(root_g, gradient_commitment_gadget(cs, gradient, client_id, round_num))

    cs.enforce_zero(client_id * 0)
    return cs


def build_training(params: TrainingParams, inputs: dict, witness_only: bool = False) -> ConstraintSystem:
    if params.variant == "verified":
        return build_training_verified(params, inputs, witness_only)
    return build_training_v5(params, inputs, witness_only)
