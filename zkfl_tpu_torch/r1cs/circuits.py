"""Uniform circuit registry: (params -> builder, dummy inputs).

One config object drives both data shapes and constraint-system
instantiation — the reference requires manually mirroring CONFIG constants
into `component main = ...` template args (test_verified_gradient.mjs:28-46
"must match circuit parameters"); here they are a single source of truth.

Dummy inputs exist so trusted setup can build the canonical R1CS structure
without a real witness (structure is value-independent).
"""

from __future__ import annotations

from typing import Union

from .balance import BalanceParams, build_balance
from .builder import ConstraintSystem
from .secagg import (
    SecaggLegacyParams,
    SecaggParams,
    build_secagg,
    build_secagg_legacy,
)
from .tiny import TinyParams, build_tiny_training
from .training import TrainingParams, build_training

CircuitParams = Union[
    BalanceParams, TrainingParams, SecaggParams, SecaggLegacyParams, TinyParams
]


def dummy_inputs(params: CircuitParams) -> dict:
    if isinstance(params, BalanceParams):
        N, D, M = params.n, params.depth, params.model_dim
        return {
            "client_id": 1, "root": 0, "N_public": N, "c0": N, "c1": 0,
            "features": [[0] * M for _ in range(N)],
            "labels": [0] * N,
            "siblings": [[0] * D for _ in range(N)],
            "pathIndices": [[0] * D for _ in range(N)],
        }
    if isinstance(params, TrainingParams):
        B, M, D = params.batch_size, params.model_dim, params.depth
        base = {
            "client_id": 1, "round": 1, "root_D": 0, "root_G": 0, "tauSquared": 0,
            "gradPos": [0] * M, "gradNeg": [0] * M,
            "features": [[0] * M for _ in range(B)],
            "labels": [0] * B,
            "siblings": [[0] * D for _ in range(B)],
            "pathIndices": [[0] * D for _ in range(B)],
        }
        if params.variant == "verified":
            base.update({
                "root_W": 0,
                "weights": [0] * M,
                "expectedSummedGrad": [0] * M,
                "remainder": [0] * M,
            })
        return base
    if isinstance(params, SecaggParams):
        M, P = params.dim, params.num_peers
        return {
            "client_id": 1, "round": 1, "root_D": 0, "root_G": 0, "root_W": 0,
            "root_K": 0, "tauSquared": 0,
            "masked_update": [0] * M,
            "peer_ids": list(range(2, 2 + P)),
            "gradient": [0] * M, "master_key": 0, "shared_keys": [0] * P,
        }
    if isinstance(params, SecaggLegacyParams):
        M = params.dim
        return {
            "client_id": 1, "shared_key_hash": 0, "root_G": 0, "tauSquared": 0,
            "masked_update": [0] * M,
            "gradient": [0] * M, "mask": [0] * M, "prf_seed": 0,
        }
    if isinstance(params, TinyParams):
        B, M, D = params.batch_size, params.model_dim, params.depth
        return {
            "client_id": 1, "root_D": 0, "root_G": 0, "alpha": 0, "tau": 0,
            "weights_old": [0] * M,
            "features": [[0] * M for _ in range(B)],
            "labels": [0] * B,
            "siblings": [[0] * D for _ in range(B)],
            "pathIndices": [[0] * D for _ in range(B)],
        }
    raise TypeError(f"unknown circuit params {params!r}")


def build_circuit(params: CircuitParams, inputs: dict, witness_only: bool = False) -> ConstraintSystem:
    if isinstance(params, BalanceParams):
        return build_balance(params, inputs, witness_only)
    if isinstance(params, TrainingParams):
        return build_training(params, inputs, witness_only)
    if isinstance(params, SecaggParams):
        return build_secagg(params, inputs, witness_only)
    if isinstance(params, SecaggLegacyParams):
        return build_secagg_legacy(params, inputs, witness_only)
    if isinstance(params, TinyParams):
        return build_tiny_training(params, inputs, witness_only)
    raise TypeError(f"unknown circuit params {params!r}")


def build_structure(params: CircuitParams) -> ConstraintSystem:
    """Canonical R1CS for setup (dummy witness values, valid structure)."""
    return build_circuit(params, dummy_inputs(params), witness_only=False)


def generate_witness(params: CircuitParams, inputs: dict) -> ConstraintSystem:
    """Fast value-only pass; returns a CS whose .witness is the assignment."""
    return build_circuit(params, inputs, witness_only=True)
