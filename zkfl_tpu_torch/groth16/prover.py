"""Groth16 prover: proof assembly on the host, MSMs on an engine.

Replaces `snarkjs groth16 prove` (reference hot path at
full_system_simulation.mjs:770-780; ~95% of round latency per SURVEY §3.3).
The pure-Python MSMs here are the correctness oracle and the small-circuit
fallback (HostEngine); TorchEngine runs the same algebra through the fused
device pipeline (groth16/device_prover.py), and ``groth16_prove_many``
batches B independent witnesses of one circuit through it.

Proof: pi_A = alpha + sum s_i A_i(tau) + r delta
       pi_B = beta  + sum s_i B_i(tau) + s delta          (G2)
       pi_C = sum_priv s_i K_i/delta + h(tau) Z(tau)/delta
              + s pi_A + r pi_B1 - r s delta              (G1)
"""

from __future__ import annotations

import hashlib
import os
import secrets
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from ..field.bn254 import FR
from ..field.curve import (
    G2_JAC_INF,
    g1_add_jac,
    g1_double_jac,
    g1_from_jacobian,
    g1_to_jacobian,
    g2_add_jac,
    g2_double_jac,
    g2_from_jacobian,
    g2_to_jacobian,
)
from ..r1cs.builder import ConstraintSystem
from .setup import ProvingKey


@dataclass
class Proof:
    pi_a: tuple
    pi_b: tuple  # G2 point (FQ2 coords)
    pi_c: tuple
    public_signals: List[int]


def _auto_window(n: int) -> int:
    """Pippenger window ~ log2(n) - 2, clamped: balances n adds/window
    against 2^c bucket-reduction adds."""
    return max(2, min(13, n.bit_length() - 2))


def pippenger_g1(points: Sequence[Optional[tuple]], scalars: Sequence[int], window: int = 0):
    """Bucketed MSM over G1 (Jacobian accumulation).  Reference/CPU path."""
    pairs = [(p, s % FR) for p, s in zip(points, scalars) if p is not None and s % FR]
    if not pairs:
        return None
    window = window or _auto_window(len(pairs))
    n_buckets = 1 << window
    n_windows = (254 + window - 1) // window
    total = (1, 1, 0)
    for w in range(n_windows - 1, -1, -1):
        shift = w * window
        buckets = [None] * n_buckets
        for p, s in pairs:
            d = (s >> shift) & (n_buckets - 1)
            if d:
                jp = g1_to_jacobian(p)
                buckets[d] = g1_add_jac(buckets[d], jp) if buckets[d] is not None else jp
        # running-sum bucket reduction
        running = (1, 1, 0)
        acc = (1, 1, 0)
        for d in range(n_buckets - 1, 0, -1):
            if buckets[d] is not None:
                running = g1_add_jac(running, buckets[d])
            acc = g1_add_jac(acc, running)
        if w != n_windows - 1:
            for _ in range(window):
                total = g1_double_jac(total)
        total = g1_add_jac(total, acc)
    return g1_from_jacobian(total)


def msm_g2(points, scalars, window: int = 0):
    """Bucketed Pippenger MSM over G2 (Jacobian, no inversions)."""
    pairs = [(p, s % FR) for p, s in zip(points, scalars) if p is not None and s % FR]
    if not pairs:
        return None
    window = window or _auto_window(len(pairs))
    n_buckets = 1 << window
    n_windows = (254 + window - 1) // window
    total = G2_JAC_INF
    for w in range(n_windows - 1, -1, -1):
        shift = w * window
        buckets = [None] * n_buckets
        for p, s in pairs:
            d = (s >> shift) & (n_buckets - 1)
            if d:
                jp = g2_to_jacobian(p)
                buckets[d] = g2_add_jac(buckets[d], jp) if buckets[d] is not None else jp
        running = G2_JAC_INF
        acc = G2_JAC_INF
        for d in range(n_buckets - 1, 0, -1):
            if buckets[d] is not None:
                running = g2_add_jac(running, buckets[d])
            acc = g2_add_jac(acc, running)
        if w != n_windows - 1:
            for _ in range(window):
                total = g2_double_jac(total)
        total = g2_add_jac(total, acc)
    return g2_from_jacobian(total)


def mul_g2(p, k: int):
    k %= FR
    if p is None or k == 0:
        return None
    acc = G2_JAC_INF
    add = g2_to_jacobian(p)
    while k:
        if k & 1:
            acc = g2_add_jac(acc, add)
        add = g2_double_jac(add)
        k >>= 1
    return g2_from_jacobian(acc)


def _derive_blinding(witness: Sequence[int], tag: str) -> int:
    """Deterministic r/s nonces (RFC6979-style): hashes the witness so tests
    are reproducible while remaining witness-dependent."""
    h = hashlib.sha256()
    h.update(tag.encode())
    for v in witness[: min(len(witness), 64)]:
        h.update(v.to_bytes(32, "little"))
    return int.from_bytes(h.digest() + hashlib.sha256(h.digest()).digest(), "big") % FR


def default_blinding(witness: Sequence[int]) -> Tuple[int, int]:
    """(r, s) blinding nonces.  RANDOM by default — snarkjs semantics: two
    proofs of the same witness are unlinkable.  Set
    ZKFL_DETERMINISTIC_BLINDING=1 (the test suites do) for reproducible
    proofs via the RFC6979-style witness hash."""
    if os.environ.get("ZKFL_DETERMINISTIC_BLINDING"):
        return _derive_blinding(witness, "r"), _derive_blinding(witness, "s")
    return secrets.randbelow(FR), secrets.randbelow(FR)


def _assemble_proof(pk: ProvingKey, witness: Sequence[int], msms: dict,
                    r: int, s: int) -> Proof:
    """Shared proof assembly from the five MSM results (host affine points,
    None = identity): msms keys a, b1, c, h (G1) and b2 (G2)."""
    n_pub = pk.n_pub

    pi_a_j = g1_to_jacobian(pk.alpha1)
    if msms["a"] is not None:
        pi_a_j = g1_add_jac(pi_a_j, g1_to_jacobian(msms["a"]))
    pi_a_j = g1_add_jac(pi_a_j, mul_g1(pk.delta1, r))
    pi_a = g1_from_jacobian(pi_a_j)

    pi_b_j = g2_to_jacobian(pk.beta2)
    if msms["b2"] is not None:
        pi_b_j = g2_add_jac(pi_b_j, g2_to_jacobian(msms["b2"]))
    if s:
        pi_b_j = g2_add_jac(pi_b_j, g2_to_jacobian(mul_g2(pk.delta2, s)))
    pi_b = g2_from_jacobian(pi_b_j)

    pi_b1_j = g1_to_jacobian(pk.beta1)
    if msms["b1"] is not None:
        pi_b1_j = g1_add_jac(pi_b1_j, g1_to_jacobian(msms["b1"]))
    pi_b1_j = g1_add_jac(pi_b1_j, mul_g1(pk.delta1, s))
    pi_b1 = g1_from_jacobian(pi_b1_j)

    pi_c_j = (1, 1, 0)
    if msms["c"] is not None:
        pi_c_j = g1_add_jac(pi_c_j, g1_to_jacobian(msms["c"]))
    if msms["h"] is not None:
        pi_c_j = g1_add_jac(pi_c_j, g1_to_jacobian(msms["h"]))
    pi_c_j = g1_add_jac(pi_c_j, mul_g1(pi_a, s))
    pi_c_j = g1_add_jac(pi_c_j, mul_g1(pi_b1, r))
    pi_c_j = g1_add_jac(pi_c_j, mul_g1(pk.delta1, (-r * s) % FR))
    pi_c = g1_from_jacobian(pi_c_j)

    return Proof(
        pi_a=pi_a, pi_b=pi_b, pi_c=pi_c,
        public_signals=[x % FR for x in witness[1 : n_pub + 1]],
    )


def groth16_prove(
    pk: ProvingKey,
    structure: ConstraintSystem,
    witness: Optional[Sequence[int]] = None,
    msm_g1=None,
    engine=None,
    blinding: Optional[Tuple[int, int]] = None,
) -> Proof:
    """Prove `witness` against the circuit `structure` (a CS built in
    structure mode, carrying the constraint matrices, or a CompiledCircuit,
    which needs an engine with `fused_msms`).  When `witness` is
    None the structure's own values are used.  A witness produced by the
    fast value-only pass (circuits.generate_witness) must be passed
    explicitly — its CS records no constraints.

    `engine` selects the compute backend: an engine exposing `fused_msms`
    (TorchEngine) runs the entire witness -> h(X) -> 5-MSM pipeline on device
    with the proving key resident (groth16/device_prover.py); otherwise the
    stage-by-stage path runs with the engine's msm/NTT primitives.  The
    proof assembly is identical either way.  `msm_g1` remains as a raw
    override for tests; `blinding` overrides the (r, s) nonces."""
    if engine is None:
        from .engine import HostEngine

        engine = HostEngine()
    compiled = getattr(structure, "is_compiled", False)
    if not compiled and not structure.constraints:
        raise ValueError(
            "groth16_prove needs the structure-mode ConstraintSystem "
            "(witness-only CS has no constraint matrices)"
        )
    if compiled and not hasattr(engine, "fused_msms"):
        raise ValueError(
            "CompiledCircuit proving needs the fused TorchEngine "
            "(host stage-by-stage path requires dict-form constraints)"
        )
    witness = list(witness) if witness is not None else structure.witness
    n_pub = pk.n_pub
    n_wires = structure.n_wires
    if len(witness) != n_wires:
        raise ValueError(f"witness length {len(witness)} != wires {n_wires}")

    r, s = blinding if blinding is not None else default_blinding(witness)

    h_basis = getattr(pk, "h_basis", "monomial")
    if msm_g1 is None and hasattr(engine, "fused_msms") and h_basis == "monomial":
        msms = engine.fused_msms(pk, structure, witness)
    else:
        _msm_g1 = msm_g1 or engine.msm_g1
        a_e, b_e, c_e = engine.matrix_evals(structure.constraints, witness, pk.domain)
        if h_basis == "odd_evals":
            # snarkjs-basis H query (e.g. an imported zkey): scalars are the
            # odd-2n-th-root evaluations of A.B - C, not h's coefficients.
            # Structures imported from a zkey have no C matrix (section 4 is
            # A/B only); c_from_ab recovers C's domain evals as A.B, exactly
            # as snarkjs's buildABC1 does.
            from .qap import compute_podd

            h = compute_podd(
                a_e, b_e,
                None if getattr(structure, "c_from_ab", False) else c_e,
            )
        else:
            h = engine.compute_h(a_e, b_e, c_e)
        msms = {
            "a": _msm_g1(pk.a_query, witness),
            "b1": _msm_g1(pk.b1_query, witness),
            "b2": engine.msm_g2(pk.b2_query, witness),
            "c": _msm_g1(pk.c_query, witness[n_pub + 1 :]),
            "h": _msm_g1(pk.h_query, h[: len(pk.h_query)]),
        }
    return _assemble_proof(pk, witness, msms, r, s)


def groth16_prove_many(
    pk: ProvingKey,
    structure: ConstraintSystem,
    witnesses: Sequence[Sequence[int]],
    engine,
    mesh=None,
    axis: str = "clients",
) -> List[Proof]:
    """B independent witnesses of one circuit through one batched run of the
    fused device pipeline (client-batch data parallelism; the reference
    proves clients one `execSync` at a time,
    full_system_simulation.mjs:1298-1343).  Needs a TorchEngine.

    With ``mesh`` (parallel/mesh.py) the client batch shards over ``axis``
    (DeviceProver.msm_results_many)."""
    from .device_prover import device_prover
    from .engine import TorchEngine

    if not isinstance(engine, TorchEngine):
        raise TypeError("groth16_prove_many needs a TorchEngine")
    witnesses = [list(w) for w in witnesses]
    dp = device_prover(pk, structure, engine.device, engine.profile)
    proofs = []
    for w, msms in zip(witnesses, dp.msm_results_many(witnesses, mesh=mesh, axis=axis)):
        r, s = default_blinding(w)
        proofs.append(_assemble_proof(pk, w, msms, r, s))
    return proofs


def mul_g1(p, k: int):
    """Scalar mul returning Jacobian (internal helper)."""
    k %= FR
    acc = (1, 1, 0)
    if p is None or k == 0:
        return acc
    add = g1_to_jacobian(p)
    while k:
        if k & 1:
            acc = g1_add_jac(acc, add)
        add = g1_double_jac(add)
        k >>= 1
    return acc
