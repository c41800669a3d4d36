"""Component A: dataset balance proof.

Native re-expression of src/circuits/balance/balance_unified.circom
(template BalanceProofUnified(N, DEPTH, MODEL_DIM):74-188; prod config in
balance_unified_prod.circom:101).  Constraints:
  1. label booleanity                        (:98-100)
  2. running label sum == c1                 (:107-115)
  3. c0 + c1 == N_public == N                (:122-123)
  4. per-sample Merkle membership with leaf = VectorHash(features || label)
                                             (:136-161)
Public signals (order matters for server positional checks):
  [client_id, root, N_public, c0, c1].
"""

from __future__ import annotations

from dataclasses import dataclass

from .builder import ConstraintSystem
from .gadgets import merkle_proof_gadget, vector_hash_gadget


@dataclass(frozen=True)
class BalanceParams:
    n: int = 8
    depth: int = 3
    model_dim: int = 4

    @property
    def name(self) -> str:
        return f"balance_unified_{self.n}_{self.depth}_{self.model_dim}"


def build_balance(params: BalanceParams, inputs: dict, witness_only: bool = False) -> ConstraintSystem:
    """inputs uses the reference's input-JSON field names
    (full_system_simulation.mjs:358-368)."""
    cs = ConstraintSystem(name=params.name, witness_only=witness_only)
    N, DEPTH, DIM = params.n, params.depth, params.model_dim

    client_id = cs.public_input("client_id", int(inputs["client_id"]))
    root = cs.public_input("root", int(inputs["root"]))
    n_public = cs.public_input("N_public", int(inputs["N_public"]))
    c0 = cs.public_input("c0", int(inputs["c0"]))
    c1 = cs.public_input("c1", int(inputs["c1"]))

    features = [cs.private_inputs(f"features[{i}]", [int(x) for x in inputs["features"][i]]) for i in range(N)]
    labels = cs.private_inputs("labels", [int(x) for x in inputs["labels"]])
    siblings = [cs.private_inputs(f"siblings[{i}]", [int(x) for x in inputs["siblings"][i]]) for i in range(N)]
    path_indices = [
        cs.private_inputs(f"pathIndices[{i}]", [int(x) for x in inputs["pathIndices"][i]]) for i in range(N)
    ]

    # 1. booleanity
    for i in range(N):
        cs.enforce_bool(labels[i])

    # 2. running sum == c1
    total = cs.zero()
    for i in range(N):
        total = total + labels[i]
    cs.enforce_equal(total, c1)

    # 3. totals
    cs.enforce_equal(c0 + c1, n_public)
    cs.enforce_equal(n_public, cs.constant(N))

    # 4. membership with unified leaf hash
    for i in range(N):
        leaf = vector_hash_gadget(cs, features[i] + [labels[i]])
        merkle_proof_gadget(cs, leaf, siblings[i], path_indices[i], root)

    # keep client_id constrained (reference binds it via the public list only)
    cs.enforce_zero(client_id * 0)
    return cs
