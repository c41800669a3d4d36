"""The comparison that decides a run's ``correct``: every round the window
completed, against what ``zkbench/plain/<kind>.py`` works out for its seed,
and a sample of its proofs, drawn from the run's seed, verified by
``bn254.py``.

It reads what the program produced only to judge it.  A record is a dict
of plain ints and floats: ``seed``; ``proofs``, {(circuit, client): {"a",
"b", "c", "publics"}}; and for a federated round ``aggregate`` and
``model``.  The verifying keys come from the program's set-up; their
alpha, beta, gamma and delta are worked out again here from the
development setup's published derivation (its toxic waste is the SHA-256
of "zkfl-setup|<seed>|<name>"), each IC point is checked to lie on G1,
and each circuit's IC list is held to the SHA-256 pinned for it in
``zkbench/plain/ic/<config>.json``.
"""

from __future__ import annotations

import hashlib
import importlib
import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor

from . import bn254

SETUP_SEED = "zkfl-dev"


def toxic_waste(seed: str = SETUP_SEED) -> dict:
    out = {}
    for tag in ("tau", "alpha", "beta", "gamma", "delta"):
        h = hashlib.sha256(f"zkfl-setup|{seed}|{tag}".encode()).digest()
        out[tag] = int.from_bytes(h + hashlib.sha256(h).digest(), "big") % bn254.R or 1
    return out


def ic_sha256(ic) -> str:
    """The SHA-256 of a verifying key's IC points, "x,y" (or "inf") joined
    by ";"."""
    text = ";".join("inf" if p is None else f"{p[0]},{p[1]}" for p in ic)
    return hashlib.sha256(text.encode()).hexdigest()


def keys_wrong(vks: dict, ic_pins: dict) -> int:
    """Verifying-key elements that differ from the development setup's, IC
    points off the curve, and IC lists that differ from their pins, over
    every circuit's key."""
    tw = toxic_waste()
    want = {"alpha1": bn254.g1_mul(bn254.G1_GEN, tw["alpha"]),
            "beta2": bn254.g2_mul(bn254.G2_GEN, tw["beta"]),
            "gamma2": bn254.g2_mul(bn254.G2_GEN, tw["gamma"]),
            "delta2": bn254.g2_mul(bn254.G2_GEN, tw["delta"])}
    bad = 0
    for circuit, vk in vks.items():
        bad += sum(vk[k] != v for k, v in want.items())
        bad += sum(not bn254.g1_on_curve(p) for p in vk["ic"])
        bad += ic_sha256(vk["ic"]) != ic_pins.get(circuit)
    return bad


def _expect(kind: str, config: dict, seed: int) -> dict:
    return importlib.import_module(f"zkbench.plain.{kind}").expect(config, seed)


def expected_rounds(kind: str, config: dict, seeds) -> list:
    """The plain round of each seed, worked out in worker processes (one a
    core), each importing only ``zkbench.plain``."""
    seeds = list(seeds)
    if len(seeds) <= 1:
        return [_expect(kind, config, s) for s in seeds]
    workers = min(len(seeds), len(os.sched_getaffinity(0)))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(_expect, [kind] * len(seeds), [config] * len(seeds), seeds))


def judge(kind: str, config: dict, records, vks: dict, ic_pins: dict, proof_sample: int,
          seed: int) -> dict:
    """The numbers compared, each an exact count with the limit 0:
    rounds the program's own server rejected (``rounds_failed``, counted by
    the caller), public signals that differ from the plain round's
    (``publics_wrong``), sampled proofs that the pairing check rejects
    against the plain public signals (``proofs_rejected``), aggregate and
    model entries that differ (``aggregate_wrong``), key elements that
    differ (``keys_wrong``).  Every round is worked out again;
    ``proof_sample`` proofs among theirs are verified."""
    rng = random.Random(f"zkbench-judge|{seed}")
    records = list(records)
    publics_wrong = aggregate_wrong = 0
    checked = []
    for rec, ref in zip(records, expected_rounds(kind, config, [r["seed"] for r in records])):
        if set(ref["publics"]) != set(rec["proofs"]):
            publics_wrong += len(set(ref["publics"]) ^ set(rec["proofs"]))
        for key, publics in ref["publics"].items():
            proof = rec["proofs"].get(key)
            if proof is None:
                continue
            if list(proof["publics"]) != publics:
                publics_wrong += 1
            checked.append((key, proof, publics))
        for name in ("aggregate", "model"):
            if name in ref:
                got = rec.get(name) or []
                aggregate_wrong += sum(a != b for a, b in zip(got, ref[name]))
                aggregate_wrong += abs(len(got) - len(ref[name]))
    sample = checked if len(checked) <= proof_sample else rng.sample(checked, proof_sample)
    rejected = sum(not bn254.groth16_verify(vks[key[0]], proof, publics)
                   for key, proof, publics in sample)
    return {
        "publics_wrong": publics_wrong,
        "proofs_rejected": rejected,
        "aggregate_wrong": aggregate_wrong,
        "keys_wrong": keys_wrong(vks, ic_pins),
        "rounds_judged": len(records),
        "proofs_verified": len(sample),
        "ic_sha256": {circuit: ic_sha256(vk["ic"]) for circuit, vk in vks.items()},
    }
