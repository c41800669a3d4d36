"""snarkjs-schema JSON serialisation for proofs, public signals and vkeys
(counterpart of zkfl_tpu/groth16/serialize.py).

The reference exchanges artifacts as snarkjs JSON files
(proof.json/public.json/_vkey.json written by `_runZKProof`,
full_system_simulation.mjs:770-787) — decimal strings, G1 affine [x, y, "1"],
G2 as [[c0, c1], ...] with the Fq2 coefficient pair per coordinate.  We emit
and parse the same schema so artifacts are drop-in interchangeable at the
file level.
"""

from __future__ import annotations

import json
from typing import List

from ..field.bn254 import FQ
from ..field.tower import FQ2
from .prover import Proof
from .setup import VerifyingKey


def _g1_json(p) -> List[str]:
    if p is None:
        return ["0", "1", "0"]
    return [str(p[0]), str(p[1]), "1"]


def _g2_json(p) -> List[List[str]]:
    if p is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    x, y = p
    return [
        [str(x.coeffs[0]), str(x.coeffs[1])],
        [str(y.coeffs[0]), str(y.coeffs[1])],
        ["1", "0"],
    ]


def _g1_parse(v):
    x, y, z = (int(c) for c in v)
    if z == 0:
        return None
    if z != 1:
        zinv = pow(z, FQ - 2, FQ)
        return (x * zinv % FQ, y * zinv % FQ)
    return (x, y)


def _g2_parse(v):
    (x0, x1), (y0, y1), (z0, z1) = ((int(a), int(b)) for a, b in v)
    if z0 == 0 and z1 == 0:
        return None
    x, y, z = FQ2([x0, x1]), FQ2([y0, y1]), FQ2([z0, z1])
    if z != FQ2.one():
        zi = z.inv()
        x, y = x * zi, y * zi
    return (x, y)


def proof_to_json(proof: Proof) -> dict:
    return {
        "pi_a": _g1_json(proof.pi_a),
        "pi_b": _g2_json(proof.pi_b),
        "pi_c": _g1_json(proof.pi_c),
        "protocol": "groth16",
        "curve": "bn128",
    }


def proof_from_json(data: dict, public_signals=None) -> Proof:
    return Proof(
        pi_a=_g1_parse(data["pi_a"]),
        pi_b=_g2_parse(data["pi_b"]),
        pi_c=_g1_parse(data["pi_c"]),
        public_signals=[int(s) for s in (public_signals or [])],
    )


def public_to_json(public_signals) -> list:
    return [str(int(s)) for s in public_signals]


def public_from_json(data) -> list:
    return [int(s) for s in data]


def vkey_to_json(vk: VerifyingKey) -> dict:
    return {
        "protocol": "groth16",
        "curve": "bn128",
        "nPublic": len(vk.ic) - 1,
        "vk_alpha_1": _g1_json(vk.alpha1),
        "vk_beta_2": _g2_json(vk.beta2),
        "vk_gamma_2": _g2_json(vk.gamma2),
        "vk_delta_2": _g2_json(vk.delta2),
        "IC": [_g1_json(p) for p in vk.ic],
    }


def vkey_from_json(data: dict) -> VerifyingKey:
    return VerifyingKey(
        alpha1=_g1_parse(data["vk_alpha_1"]),
        beta2=_g2_parse(data["vk_beta_2"]),
        gamma2=_g2_parse(data["vk_gamma_2"]),
        delta2=_g2_parse(data["vk_delta_2"]),
        ic=[_g1_parse(p) for p in data["IC"]],
    )


def write_artifacts(dir_path, prefix: str, proof: Proof, vk: VerifyingKey = None):
    """Write proof/public(/vkey) JSON files like _runZKProof does."""
    import os

    os.makedirs(dir_path, exist_ok=True)
    with open(os.path.join(dir_path, f"{prefix}_proof.json"), "w") as f:
        json.dump(proof_to_json(proof), f, indent=1)
    with open(os.path.join(dir_path, f"{prefix}_public.json"), "w") as f:
        json.dump(public_to_json(proof.public_signals), f, indent=1)
    if vk is not None:
        with open(os.path.join(dir_path, f"{prefix}_vkey.json"), "w") as f:
            json.dump(vkey_to_json(vk), f, indent=1)
