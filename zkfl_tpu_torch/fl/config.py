"""Federated-round configuration.

One config object drives BOTH the data shapes and the three constraint
systems — the reference requires manually mirroring its CONFIG constants
into circuit template instantiations (full_system_simulation.mjs:38-66 vs
`component main = ...`; test_verified_gradient.mjs:28-46 "must match
circuit parameters").  Here the circuit params derive from the config.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..r1cs.balance import BalanceParams
from ..r1cs.secagg import SecaggParams
from ..r1cs.training import TrainingParams


@dataclass(frozen=True)
class FLConfig:
    """Mirrors full_system_simulation.mjs CONFIG semantics."""

    num_clients: int = 3
    n: int = 8                      # samples per client
    model_dim: int = 4
    depth: int = 3                  # Merkle depth, 2^depth = n
    batch_size: int = 8
    tau_squared: int = 100_000_000  # clipping threshold
    precision: int = 1000           # fixed-point scale
    current_round: int = 1
    learning_rate: float = 0.01
    seed: int = 12345
    # Persistent setup/zkey cache (the reference's artifacts/ dir,
    # full_system_simulation.mjs:57-61) — build/zkfl_artifacts/ beside the
    # package, so the port writes nothing outside its checkout; override
    # per-config or via ZKFL_ARTIFACTS_DIR.
    artifacts_dir: str = field(
        default_factory=lambda: os.environ.get(
            "ZKFL_ARTIFACTS_DIR",
            os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "build", "zkfl_artifacts"),
        )
    )

    # -- circuit instantiations ------------------------------------------
    @property
    def balance_params(self) -> BalanceParams:
        return BalanceParams(n=self.n, depth=self.depth, model_dim=self.model_dim)

    @property
    def training_params(self) -> TrainingParams:
        return TrainingParams(
            batch_size=self.batch_size,
            model_dim=self.model_dim,
            depth=self.depth,
            precision=self.precision,
            variant="verified",
        )

    @property
    def secagg_params(self) -> SecaggParams:
        return SecaggParams(dim=self.model_dim, num_peers=self.num_clients - 1)


# The reference E2E configuration (Report.pdf Table 1).
REFERENCE_CONFIG = FLConfig()

# Micro configuration for the CPU test suite (identical protocol flow,
# small enough for pure-Python / virtual-device proving).
MICRO_CONFIG = FLConfig(
    num_clients=3, n=2, model_dim=2, depth=1, batch_size=2,
    tau_squared=10**14, precision=1000,
)
