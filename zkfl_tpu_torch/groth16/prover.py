"""Batched Groth16 proving on TorchEngine (counterpart of
zkfl_tpu/groth16/prover.py groth16_prove_many).

Single proofs go through the shared ``groth16_prove`` unchanged: it runs
``engine.fused_msms`` when the engine has one.  Proof assembly and blinding
are the shared ``_assemble_proof`` and ``default_blinding``.
"""

from __future__ import annotations

from typing import List, Sequence

from zkfl_tpu.groth16.prover import Proof, _assemble_proof, default_blinding, groth16_prove
from zkfl_tpu.groth16.setup import ProvingKey
from zkfl_tpu.r1cs.builder import ConstraintSystem

from .device_prover import device_prover
from .engine import TorchEngine

__all__ = ["groth16_prove", "groth16_prove_many"]


def groth16_prove_many(
    pk: ProvingKey,
    structure: ConstraintSystem,
    witnesses: Sequence[Sequence[int]],
    engine: TorchEngine,
) -> List[Proof]:
    """B independent witnesses of one circuit through one batched run of the
    fused device pipeline (client-batch data parallelism)."""
    if not isinstance(engine, TorchEngine):
        raise TypeError("groth16_prove_many needs a TorchEngine")
    witnesses = [list(w) for w in witnesses]
    dp = device_prover(pk, structure, engine.device, engine.profile)
    proofs = []
    for w, msms in zip(witnesses, dp.msm_results_many(witnesses)):
        r, s = default_blinding(w)
        proofs.append(_assemble_proof(pk, w, msms, r, s))
    return proofs
