"""Tiny demo training circuits (Component C12).

Native re-expression of src/circuits/training/tiny_training.circom (main =
TinyTrainingStep(2, 4, 2, 1000) :60) and simple_tiny_training.circom (main =
SimpleTinyTraining(2, 4, 2) :52).  Both are demo circuits: the "gradient" is
just the element-wise sum of the two batch samples' features
(tiny_training.circom:44-49, simple_tiny_training.circom:35-42) — no actual
SGD math.  They differ in the Merkle leaf convention:

  * tiny_training: leaf = VectorHash(features || label) pre-hashed, verified
    with BatchMerkleProofPreHashed (merkle.circom:200-220).
  * simple_tiny_training: leaf = Poseidon(label) raw-value convention,
    verified with BatchMerkleProof -> MerkleTreeInclusionProof
    (merkle.circom:109-176); root_G = PoseidonHashN(gradient), not
    VectorHash.

Public signals for both: [client_id, root_D, root_G, alpha, tau].
"""

from __future__ import annotations

from dataclasses import dataclass

from .builder import ConstraintSystem
from .gadgets import merkle_proof_gadget, poseidon_gadget, vector_hash_gadget


@dataclass(frozen=True)
class TinyParams:
    batch_size: int = 2
    model_dim: int = 4
    depth: int = 2
    precision: int = 1000
    simple: bool = False  # True -> simple_tiny_training conventions

    @property
    def name(self) -> str:
        kind = "simple_tiny" if self.simple else "tiny"
        return f"{kind}_training_{self.batch_size}_{self.model_dim}_{self.depth}"


def build_tiny_training(params: TinyParams, inputs: dict, witness_only: bool = False) -> ConstraintSystem:
    cs = ConstraintSystem(name=params.name, witness_only=witness_only)
    B, D, DEPTH = params.batch_size, params.model_dim, params.depth

    cs.public_input("client_id", int(inputs["client_id"]))
    root_d = cs.public_input("root_D", int(inputs["root_D"]))
    root_g = cs.public_input("root_G", int(inputs["root_G"]))
    cs.public_input("alpha", int(inputs["alpha"]))
    cs.public_input("tau", int(inputs["tau"]))

    cs.private_inputs("weights_old", [int(x) for x in inputs["weights_old"]])
    features = [
        cs.private_inputs(f"features[{i}]", [int(x) for x in inputs["features"][i]])
        for i in range(B)
    ]
    labels = cs.private_inputs("labels", [int(x) for x in inputs["labels"]])
    siblings = [
        cs.private_inputs(f"siblings[{i}]", [int(x) for x in inputs["siblings"][i]])
        for i in range(B)
    ]
    path_indices = [
        cs.private_inputs(f"pathIndices[{i}]", [int(x) for x in inputs["pathIndices"][i]])
        for i in range(B)
    ]

    # Batch membership — leaf convention differs between the two variants.
    for i in range(B):
        if params.simple:
            # BatchMerkleProof: leaf = Poseidon(label) raw-value convention.
            leaf = poseidon_gadget(cs, [labels[i]])
        else:
            # Pre-hashed: leaf = VectorHash(features || label).
            leaf = vector_hash_gadget(cs, features[i] + [labels[i]])
        merkle_proof_gadget(cs, leaf, siblings[i], path_indices[i], root_d)

    # Demo "gradient": element-wise sum of the batch's features.
    gradient = [sum((features[i][j] for i in range(B)), cs.zero()) for j in range(D)]

    # Gradient commitment.
    if params.simple:
        grad_hash = poseidon_gadget(cs, gradient)
    else:
        grad_hash = vector_hash_gadget(cs, gradient)
    cs.enforce_equal(root_g, grad_hash)
    return cs
