"""Round prover (counterpart of zkfl_tpu/fl/prover.py).

One trusted setup per circuit, shared by all clients and cached on disk
(the reference skips compile/setup when .r1cs/.zkey exist,
full_system_simulation.mjs:698-739).  On a TorchEngine the three circuits
pad to one ``PipelineProfile`` and their setups are built at its domain on
the engine's device, so every proof of a round runs through one set of
device shapes, and batched proving goes through ``groth16_prove_many``
(client-batch data parallelism; with a ``mesh``, sharded over its
"clients" axis).  A HostEngine proves stage by stage in
pure Python, one client at a time, on setups from the pure-Python ladder.
Verification is the native pairing check.
"""

from __future__ import annotations

from typing import Optional

from ..groth16.device_prover import PipelineProfile
from ..groth16.prover import groth16_prove, groth16_prove_many
from ..groth16.setup import setup_cached_many
from ..groth16.verifier import groth16_verify
from ..r1cs.circuits import build_structure
from .config import FLConfig


class RoundProver:
    """The three circuit structures + proving/verifying keys of one FL
    configuration, proved on ``engine`` (a TorchEngine or a HostEngine)."""

    def __init__(self, config: FLConfig, engine, cache_dir: Optional[str] = None):
        self.cfg = config
        self.engine = engine
        cache = cache_dir or config.artifacts_dir

        self.balance_cs = build_structure(config.balance_params)
        self.training_cs = build_structure(config.training_params)
        self.secagg_cs = build_structure(config.secagg_params)
        structures = [self.balance_cs, self.training_cs, self.secagg_cs]
        domain = device = None  # HostEngine: natural domains, the pure-Python ladder
        if self.can_batch:
            if engine.profile is None:
                engine.profile = PipelineProfile.cover(structures)
            domain, device = engine.profile.domain, engine.device
        keys = setup_cached_many(structures, cache, domain=domain, device=device)
        (self.balance_pk, self.balance_vk), (self.training_pk, self.training_vk), \
            (self.secagg_pk, self.secagg_vk) = keys

    # -- proving ----------------------------------------------------------
    def prove_balance(self, witness):
        return groth16_prove(self.balance_pk, self.balance_cs, witness, engine=self.engine)

    def prove_training(self, witness):
        return groth16_prove(self.training_pk, self.training_cs, witness, engine=self.engine)

    def prove_secagg(self, witness):
        return groth16_prove(self.secagg_pk, self.secagg_cs, witness, engine=self.engine)

    # -- batched proving (client-batch data parallelism) ------------------
    @property
    def can_batch(self) -> bool:
        """True for an engine with the fused device pipeline (TorchEngine):
        it batches clients, pads to one profile and sets up on its device."""
        return hasattr(self.engine, "fused_msms")

    def prove_balance_many(self, witnesses, mesh=None):
        return groth16_prove_many(self.balance_pk, self.balance_cs, witnesses, self.engine,
                                  mesh=mesh)

    def prove_training_many(self, witnesses, mesh=None):
        return groth16_prove_many(self.training_pk, self.training_cs, witnesses, self.engine,
                                  mesh=mesh)

    def prove_secagg_many(self, witnesses, mesh=None):
        return groth16_prove_many(self.secagg_pk, self.secagg_cs, witnesses, self.engine,
                                  mesh=mesh)

    # -- verification (server side) --------------------------------------
    def verify_balance(self, proof) -> bool:
        return groth16_verify(self.balance_vk, proof)

    def verify_training(self, proof) -> bool:
        return groth16_verify(self.training_vk, proof)

    def verify_secagg(self, proof) -> bool:
        return groth16_verify(self.secagg_vk, proof)
