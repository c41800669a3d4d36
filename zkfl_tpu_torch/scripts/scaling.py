"""Dataset-size scaling curve on one card (counterpart of the repository's
scripts/scaling.py; Report.pdf Table 5).

    python -m zkfl_tpu_torch.scripts.scaling [--n=16,32,64] [--device cuda|cpu]
                                             [--json-out=PATH]

The reference publishes the prove time per client (balance + training) at
N = 8/16/32/64/128: 14.1 / 28.3 / 56.7 / 114.2 / 231.5 s on the
i7-10750H, linear in N because snarkjs proves on one thread.  Each point
proves balance_unified(N, log2 N, 4) and the "verified" training circuit
at batch N through the fused device pipeline, both padded to one
PipelineProfile.  Setups are cached per N (under build/zkfl_scaling_artifacts,
or $ZKFL_ARTIFACTS_DIR/scaling) and run on the card where the cache misses;
the recorded number is the steady prove (the second), beside the first.
Every proof is verified natively.  Each point prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

BASELINE = {8: 14.1, 16: 28.3, 32: 56.7, 64: 114.2, 128: 231.5}
# Beside the round's artifacts (fl/config.py), inside the checkout.
CACHE_DIR = (
    os.path.join(os.environ["ZKFL_ARTIFACTS_DIR"], "scaling")
    if os.environ.get("ZKFL_ARTIFACTS_DIR")
    else os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "zkfl_scaling_artifacts")
)


def point_config(n: int, cache_dir: str):
    """The FL configuration of point N: N samples, depth log2 N, 4 model
    weights, a training batch of N."""
    from ..fl.config import FLConfig

    if n < 2 or n & (n - 1):
        raise ValueError(f"N must be a power of two >= 2, got {n}")
    return FLConfig(n=n, depth=int(math.log2(n)), model_dim=4, batch_size=n,
                    artifacts_dir=cache_dir)


def point_witnesses(cfg):
    """Client 1's balance and training witnesses under ``cfg`` (the
    training witness at the zero model)."""
    from ..bench import balance_inputs, canonical_client
    from ..r1cs.circuits import generate_witness

    client = canonical_client(cfg)
    bal = generate_witness(cfg.balance_params, balance_inputs(client)).witness
    return bal, client.training_witness([0] * cfg.model_dim)


def run_point(n: int, cache_dir: str, device) -> dict:
    """One point of the curve on ``device``: a TorchEngine there, both
    circuits padded to one profile, the setups on the device; with device
    None, HostEngine (natural domains, the pure-Python ladder).  Raises if
    a proof fails."""
    from ..groth16.device_prover import PipelineProfile
    from ..groth16.engine import HostEngine, TorchEngine
    from ..groth16.prover import groth16_prove
    from ..groth16.setup import setup_cached_many
    from ..groth16.verifier import groth16_verify
    from ..r1cs.circuits import build_structure

    cfg = point_config(n, cache_dir)
    out = {"n": n}

    t0 = time.time()
    bal_cs = build_structure(cfg.balance_params)
    tr_cs = build_structure(cfg.training_params)
    out["constraints"] = len(bal_cs.constraints) + len(tr_cs.constraints)
    out["structures_s"] = time.time() - t0

    if device is None:
        engine, domain = HostEngine(), None
    else:
        engine = TorchEngine(device, profile=PipelineProfile.cover([bal_cs, tr_cs]))
        domain = engine.profile.domain
    t0 = time.time()
    (bal_pk, bal_vk), (tr_pk, tr_vk) = setup_cached_many([bal_cs, tr_cs], cache_dir,
                                                         domain=domain, device=device)
    out["setups_s"] = time.time() - t0

    t0 = time.time()
    bal_wit, tr_wit = point_witnesses(cfg)
    out["witness_s"] = time.time() - t0

    def prove_both(key):
        t0 = time.time()
        bp = groth16_prove(bal_pk, bal_cs, bal_wit, engine=engine)
        tp = groth16_prove(tr_pk, tr_cs, tr_wit, engine=engine)
        out[key] = time.time() - t0
        if not (groth16_verify(bal_vk, bp) and groth16_verify(tr_vk, tp)):
            raise AssertionError(f"N={n}: a proof of the {key} pair does not verify")

    prove_both("prove_first_s")   # key upload, COO stream, NTT tables, then the run
    prove_both("prove_s")
    out["baseline_s"] = BASELINE.get(n)
    if out["baseline_s"]:
        out["vs_baseline"] = out["baseline_s"] / out["prove_s"]
    return out


def main(argv=None) -> int:
    from .. import backend

    ap = argparse.ArgumentParser(description="Report.pdf Table 5 sweep on the PyTorch/CUDA prover")
    ap.add_argument("--n", default="16,32,64", help="comma-separated N (powers of two, 8..128)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu (default cuda)")
    ap.add_argument("--json-out", default=None, help="write the result here too")
    args = ap.parse_args(argv)
    ns = [int(x) for x in args.n.split(",")]
    dev = backend.device(args.device)
    where = backend.gpu_name_and_power_limit() if dev.type == "cuda" else "the CPU"
    print(f"# {where}", flush=True)
    os.makedirs(CACHE_DIR, exist_ok=True)
    points = []
    for n in ns:
        print(f"# === N={n} ===", flush=True)
        points.append(run_point(n, CACHE_DIR, dev))
        print(json.dumps(points[-1]), flush=True)
    result = {"points": points, "baseline": BASELINE,
              "note": f"prove_s = steady balance+training prove on {where}"}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=1)
        print(f"# wrote {os.path.abspath(args.json_out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
