"""FL protocol layer of the port: prover clients, verifier/aggregator
server, round simulation (counterpart of zkfl_tpu/fl/__init__.py; the
reference's L4 protocol layer, tests/full_system_simulation.mjs:244-1395)."""

from .client import Client, ProofPackage, SharedLCG
from .config import FLConfig, MICRO_CONFIG, REFERENCE_CONFIG
from .prover import RoundProver
from .server import Server
from .simulation import run_round, simulate_key_exchange

__all__ = [
    "Client", "ProofPackage", "SharedLCG", "FLConfig", "MICRO_CONFIG",
    "REFERENCE_CONFIG", "RoundProver", "Server", "run_round",
    "simulate_key_exchange",
]
