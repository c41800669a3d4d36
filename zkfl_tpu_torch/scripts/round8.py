"""8-client verifiable FL round on one card (counterpart of the repository's
scripts/round8.py; BASELINE.json config 4).

    python -m zkfl_tpu_torch.scripts.round8 [--device cuda|cpu] [--json-out=PATH]

The reference proves clients one after another (about 14.1 s a client, so a
3-client round takes 43 s, Report.pdf Table 4).  Here each proof phase
proves its 8 client witnesses as one batched run of the fused device
pipeline (groth16_prove_many).  A warm-up round, then the measured round;
every proof of both must verify.  Prints the result as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BASELINE_ROUND_S = 43.0          # Report.pdf Table 4, 3-client round
BASELINE_CLIENT_PROVE_S = 14.1   # Report.pdf Table 4, per client
NUM_CLIENTS = 8


def round_result(timings: dict, num_clients: int) -> dict:
    """The measured round's timings -> the result line."""
    per_client = (timings["balance_proofs"] + timings["training_proofs"]
                  + timings["secagg_proofs"]) / num_clients
    return {
        "num_clients": num_clients,
        "proofs": 3 * num_clients,
        "round_s": timings["total"],
        "prove_per_client_s": per_client,
        "baseline_3client_round_s": BASELINE_ROUND_S,
        "baseline_prove_per_client_s": BASELINE_CLIENT_PROVE_S,
        "prove_per_client_vs_baseline": BASELINE_CLIENT_PROVE_S / per_client,
        "phases_s": dict(timings),
    }


def _checked_round(cfg, prover):
    from ..fl.simulation import run_round

    server, timings = run_round(cfg, prover=prover, verbose=False)
    summary = server.get_summary()
    if not summary["all_passed"]:
        raise AssertionError(f"a proof of the {cfg.num_clients}-client round failed: {summary}")
    return server, timings


def run(device, cache_dir=None, log=print):
    """The setups (from ``cache_dir``, default the round's artifacts), a
    warm-up round and the measured round of NUM_CLIENTS clients on
    ``device``; returns (the result line, the measured round's server)."""
    from ..fl.config import FLConfig
    from ..fl.prover import RoundProver
    from ..groth16.engine import TorchEngine

    cfg = FLConfig(num_clients=NUM_CLIENTS)
    cache = cache_dir or cfg.artifacts_dir
    before = set(os.listdir(cache)) if os.path.isdir(cache) else set()
    t0 = time.time()
    prover = RoundProver(cfg, TorchEngine(device), cache_dir=cache)
    cold = sorted(set(os.listdir(cache)) - before)
    log(f"# setups ready in {time.time() - t0:.1f} s (profile {prover.engine.profile}); "
        f"cold: {cold or 'none, all from the cache'}")
    _, warm = _checked_round(cfg, prover)
    log(f"# warm-up round {warm['total']:.2f} s")
    server, timings = _checked_round(cfg, prover)
    return round_result(timings, cfg.num_clients), server


def main(argv=None) -> int:
    from .. import backend

    ap = argparse.ArgumentParser(description="8-client FL round on the PyTorch/CUDA prover")
    ap.add_argument("--device", default="cuda", help="cuda or cpu (default cuda)")
    ap.add_argument("--json-out", default=None, help="write the result here too")
    args = ap.parse_args(argv)
    dev = backend.device(args.device)
    if dev.type == "cuda":
        print(f"# {backend.gpu_name_and_power_limit()}", flush=True)
    result, _ = run(dev)
    print(json.dumps(result), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
