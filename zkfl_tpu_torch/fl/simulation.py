"""One verifiable FL round on the port: N clients x (balance + training +
secagg) proofs, server-side verification + binding + aggregation
(counterpart of zkfl_tpu/fl/simulation.py, the analog of the reference's
`node tests/full_system_simulation.mjs`, runSimulation :1244-1395).

Run:  python -m zkfl_tpu_torch.fl.simulation [--micro] [--clients N]
                                              [--device cuda|cpu | --host-engine]
Exits non-zero unless every proof of the round verified.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace
from typing import Dict, Optional

from .. import backend
from ..groth16.engine import HostEngine, TorchEngine
from ..poseidon.reference import poseidon
from .client import Client, SharedLCG
from .config import FLConfig, MICRO_CONFIG, REFERENCE_CONFIG
from .prover import RoundProver
from .server import Server


def simulate_key_exchange(num_clients: int) -> Dict[int, Dict[int, int]]:
    """Deterministic pairwise keys K_ij = Poseidon(min, max, 12345)
    (full_system_simulation.mjs:1320-1337; stands in for Diffie-Hellman)."""
    keys: Dict[int, Dict[int, int]] = {i: {} for i in range(1, num_clients + 1)}
    for i in range(1, num_clients + 1):
        for j in range(1, num_clients + 1):
            if i != j:
                lo, hi = min(i, j), max(i, j)
                keys[i][j] = poseidon([lo, hi, 12345])
    return keys


def run_round(
    config: FLConfig = REFERENCE_CONFIG,
    engine=None,
    prover: Optional[RoundProver] = None,
    verbose: bool = True,
    batch_clients: Optional[bool] = None,
    mesh=None,
):
    """Execute one complete verifiable FL round; returns (server, timings).

    Without ``prover`` one is built on ``engine`` (default: a TorchEngine on
    the first CUDA card; a HostEngine proves in pure Python).  With
    ``batch_clients`` (default: on for more than one client when the
    engine has the fused pipeline) each proof phase generates every
    client's witness and proves them in ONE batched device pipeline instead
    of the reference's client-at-a-time loop
    (full_system_simulation.mjs:1298-1343); ``mesh`` (parallel/mesh.py)
    additionally shards each client batch over its "clients" axis.
    """
    t_start = time.time()
    timings = {}

    def phase(name):
        timings[name] = time.time()

    def done(name):
        timings[name] = time.time() - timings[name]
        if verbose:
            print(f"[{timings[name]:8.2f}s] {name}")

    phase("setup")
    if prover is None:
        prover = RoundProver(config, engine or TorchEngine(backend.device("cuda")))
    server = Server(config, prover)
    clients = [Client(i, config, prover) for i in range(1, config.num_clients + 1)]
    if batch_clients is None:
        batch_clients = prover.can_batch and config.num_clients > 1
    done("setup")

    # Phase 0/1: model init, dataset generation, registration.
    phase("datasets")
    server.initialize_model()
    rng = SharedLCG(config.seed)
    for c in clients:
        server.register_client(c.client_id, c.generate_private_dataset(rng))
    done("datasets")

    # Phase 2: dataset commitments.
    phase("commitments")
    for c in clients:
        server.receive_dataset_commitment(c.compute_dataset_commitment())
    done("commitments")

    # Phase 3: balance proofs.
    phase("balance_proofs")
    if batch_clients:
        proofs = prover.prove_balance_many([c.balance_witness() for c in clients], mesh=mesh)
        packages = [c.package_balance(p) for c, p in zip(clients, proofs)]
    else:
        packages = [c.generate_balance_proof() for c in clients]
    for c, pkg in zip(clients, packages):
        ok = server.verify_balance_proof(pkg)
        assert ok, f"balance proof rejected for client {c.client_id}: {server.log}"
    done("balance_proofs")

    # Phase 4: training proofs.
    phase("training_proofs")
    if batch_clients:
        proofs = prover.prove_training_many(
            [c.training_witness(server.global_model) for c in clients], mesh=mesh
        )
        packages = [c.package_training(p) for c, p in zip(clients, proofs)]
    else:
        packages = [c.train_and_generate_proof(server.global_model) for c in clients]
    for c, pkg in zip(clients, packages):
        ok = server.verify_training_proof(pkg)
        assert ok, f"training proof rejected for client {c.client_id}: {server.log}"
    done("training_proofs")

    # Phase 4.5: secure aggregation proofs.
    phase("secagg_proofs")
    shared_keys = simulate_key_exchange(config.num_clients)
    if batch_clients:
        proofs = prover.prove_secagg_many([c.secagg_witness(shared_keys) for c in clients],
                                          mesh=mesh)
        packages = [c.package_secagg(p) for c, p in zip(clients, proofs)]
    else:
        packages = [c.generate_secagg_proof(shared_keys) for c in clients]
    for c, pkg in zip(clients, packages):
        ok = server.verify_secagg_proof(pkg)
        assert ok, f"secagg proof rejected for client {c.client_id}: {server.log}"
    done("secagg_proofs")

    # Phase 5: aggregate (masks cancel).
    phase("aggregate")
    result = server.aggregate_updates()
    assert result is not None, "no verified clients to aggregate"
    done("aggregate")

    timings["total"] = time.time() - t_start
    if verbose:
        summary = server.get_summary()
        print(f"summary: {summary}")
        print(f"aggregated gradient: {server.aggregated_gradient}")
        print(f"total: {timings['total']:.2f}s")
    return server, timings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ZK-FL round on the PyTorch/CUDA prover")
    ap.add_argument("--micro", action="store_true", help="micro circuit dims")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda or cpu (default cuda)")
    ap.add_argument("--host-engine", action="store_true", help="pure-Python prover engine")
    args = ap.parse_args(argv)

    cfg = MICRO_CONFIG if args.micro else REFERENCE_CONFIG
    if args.clients:
        cfg = replace(cfg, num_clients=args.clients)
    engine = HostEngine() if args.host_engine else TorchEngine(backend.device(args.device))
    server, _ = run_round(cfg, engine=engine)
    summary = server.get_summary()
    if not summary["all_passed"]:
        print(f"round failed: {summary}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
