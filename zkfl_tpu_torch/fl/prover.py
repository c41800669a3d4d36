"""Round prover on TorchEngine (counterpart of zkfl_tpu/fl/prover.py).

The three circuits pad to one ``PipelineProfile`` and their setups are built
at its domain, as zkfl_tpu does for its JAX engine.  Single proofs and
verification are inherited from the shared ``RoundProver``; the batched
``prove_*_many`` go through the port's ``groth16_prove_many``, so the shared
``run_round(config, prover=...)`` runs unchanged, with client batching.
"""

from __future__ import annotations

from typing import Optional

from zkfl_tpu.fl.config import FLConfig
from zkfl_tpu.fl.prover import RoundProver as SharedRoundProver
from zkfl_tpu.r1cs.circuits import build_structure

from ..groth16.device_prover import PipelineProfile
from ..groth16.engine import TorchEngine
from ..groth16.prover import groth16_prove_many
from ..groth16.setup import setup_cached_many


class RoundProver(SharedRoundProver):
    """Circuit structures + keys for one FL configuration on a TorchEngine.

    Does not call the shared ``__init__``: its cold setups would import the
    JAX fixed-base batches."""

    def __init__(self, config: FLConfig, engine: TorchEngine, cache_dir: Optional[str] = None):
        self.cfg = config
        self.engine = engine
        cache = cache_dir or config.artifacts_dir

        self.balance_cs = build_structure(config.balance_params)
        self.training_cs = build_structure(config.training_params)
        self.secagg_cs = build_structure(config.secagg_params)
        structures = [self.balance_cs, self.training_cs, self.secagg_cs]
        if engine.profile is None:
            engine.profile = PipelineProfile.cover(structures)
        keys = setup_cached_many(structures, cache, domain=engine.profile.domain)
        (self.balance_pk, self.balance_vk), (self.training_pk, self.training_vk), \
            (self.secagg_pk, self.secagg_vk) = keys

    def _many(self, pk, cs, witnesses, mesh):
        if mesh is not None:
            raise NotImplementedError("sharding the client batch is not ported yet")
        return groth16_prove_many(pk, cs, witnesses, self.engine)

    def prove_balance_many(self, witnesses, mesh=None):
        return self._many(self.balance_pk, self.balance_cs, witnesses, mesh)

    def prove_training_many(self, witnesses, mesh=None):
        return self._many(self.training_pk, self.training_cs, witnesses, mesh)

    def prove_secagg_many(self, witnesses, mesh=None):
        return self._many(self.secagg_pk, self.secagg_cs, witnesses, mesh)
