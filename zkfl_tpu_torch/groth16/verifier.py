"""Groth16 verifier via the native BN254 pairing.

Replaces the reference's `snarkjs groth16 verify` subprocess calls
(full_system_simulation.mjs:865-868, :975-978, :1116-1119).  The check is

    e(pi_A, pi_B) = e(alpha, beta) * e(vk_x, gamma) * e(pi_C, delta)
    vk_x = IC_0 + sum_i s_i IC_i

implemented as a 4-term product check with a single final exponentiation.
"""

from __future__ import annotations

from typing import Sequence

from .. import trace
from ..field.bn254 import FR
from ..field.curve import g1_add_jac, g1_from_jacobian, g1_neg, g1_to_jacobian
from ..field.pairing import pairing_check
from .prover import Proof, mul_g1
from .setup import VerifyingKey


@trace.spanned("groth16.vk_x")
def compute_vk_x(vk: VerifyingKey, public_signals: Sequence[int]):
    if len(public_signals) != len(vk.ic) - 1:
        raise ValueError(
            f"expected {len(vk.ic) - 1} public signals, got {len(public_signals)}"
        )
    acc = g1_to_jacobian(vk.ic[0])
    for point, s in zip(vk.ic[1:], public_signals):
        acc = g1_add_jac(acc, mul_g1(point, s % FR))
    return g1_from_jacobian(acc)


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
    # Native C++ multi-pairing (csrc/zkfl_pairing.cpp): ~25 ms vs ~800 ms
    # for the Python Miller loops (reference verifies in 8-9 ms via snarkjs,
    # ref:Report.pdf Table 3); falls back to the Python oracle when the
    # library is unavailable or an input is degenerate.
    from ..native import pairing_check_native

    with trace.span("groth16.pairing"):
        native = pairing_check_native(pairs)
        if native is not None:
            return native
        return pairing_check(pairs)
