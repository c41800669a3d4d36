"""One verifiable FL round on the port: the shared zkfl_tpu ``run_round``
driven by the port's ``RoundProver`` on a TorchEngine.

Run:  python -m zkfl_tpu_torch.fl.simulation [--micro] [--clients N]
                                              [--device cuda|cpu]
Exits non-zero unless every proof of the round verified.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

from zkfl_tpu.fl.config import MICRO_CONFIG, REFERENCE_CONFIG
from zkfl_tpu.fl.simulation import run_round

from .. import backend
from ..groth16.engine import TorchEngine
from .prover import RoundProver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ZK-FL round on the PyTorch/CUDA prover")
    ap.add_argument("--micro", action="store_true", help="micro circuit dims")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda or cpu (default cuda)")
    args = ap.parse_args(argv)

    cfg = MICRO_CONFIG if args.micro else REFERENCE_CONFIG
    if args.clients:
        cfg = replace(cfg, num_clients=args.clients)
    engine = TorchEngine(backend.device(args.device))
    prover = RoundProver(cfg, engine)
    server, _ = run_round(cfg, prover=prover)
    summary = server.get_summary()
    if not summary["all_passed"]:
        print(f"round failed: {summary}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
