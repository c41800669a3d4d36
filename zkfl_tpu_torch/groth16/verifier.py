"""Groth16 verifier via the native BN254 pairing.

Replaces the reference's `snarkjs groth16 verify` subprocess calls
(full_system_simulation.mjs:865-868, :975-978, :1116-1119).  The check is

    e(pi_A, pi_B) = e(alpha, beta) * e(vk_x, gamma) * e(pi_C, delta)
    vk_x = IC_0 + sum_i s_i IC_i

implemented as a 4-term product check with a single final exponentiation.
"""

from __future__ import annotations

from typing import Sequence

from .. import native, trace
from ..field.curve import g1_neg
from ..field.pairing import pairing_check
from .prover import Proof
from .setup import VerifyingKey


@trace.spanned("groth16.vk_x")
def compute_vk_x(vk: VerifyingKey, public_signals: Sequence[int]):
    """IC_0 + sum_i s_i IC_i, affine (None = the identity): one csrc/host
    call."""
    if len(public_signals) != len(vk.ic) - 1:
        raise ValueError(
            f"expected {len(vk.ic) - 1} public signals, got {len(public_signals)}"
        )
    with trace.span("groth16.scalar_mul"):
        jac = native.g1_lincomb_native(vk.ic, public_signals)
    trace.count("groth16.scalar_mul", len(public_signals))
    return None if jac[2] == 0 else jac[:2]


@trace.spanned("groth16.verify")
def groth16_verify(vk: VerifyingKey, proof: Proof, public_signals: Sequence[int] = None) -> bool:
    publics = proof.public_signals if public_signals is None else list(public_signals)
    try:
        vk_x = compute_vk_x(vk, publics)
    except ValueError:
        return False
    # e(-pi_A, pi_B) * e(alpha, beta) * e(vk_x, gamma) * e(pi_C, delta) == 1
    pairs = [
        (g1_neg(proof.pi_a), proof.pi_b),
        (vk.alpha1, vk.beta2),
        (vk_x, vk.gamma2),
        (proof.pi_c, vk.delta2),
    ]
    # Native C++ multi-pairing (csrc/host/zkfl_pairing.cpp; the reference
    # verifies in 8-9 ms via snarkjs, ref:Report.pdf Table 3); the Python
    # oracle decides where the native loop meets a degenerate step.
    # groth16.pairing_native counts the checks the library decided.
    trace.count("groth16.pairing")
    with trace.span("groth16.pairing"):
        ok = native.pairing_check_native(pairs)
        if ok is not None:
            trace.count("groth16.pairing_native")
            return ok
        return pairing_check(pairs)
