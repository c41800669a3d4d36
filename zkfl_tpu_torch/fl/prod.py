"""Production-dims integration flow on the port: N=128, DIM=16, DEPTH=7
(+ sgd_step_v5) (counterpart of zkfl_tpu/fl/prod.py).

The reference's production-scale run (tests/integration_test.mjs:557-697):
a seeded 128-sample dataset, the balance proof at (128,7,16) via
`balance_unified_prod` (balance_unified_prod.circom:101), the training
proof at (8,16,7) via `sgd_step_v5` (sgd_step_v5.circom:168), and the
cross-proof binding check on the shared root_D (integration_test.mjs:672-697).
Reference baseline for the two proves at N=128: 231.5 s on the i7-10750H
(Report.pdf Table 5).

Artifact reuse mirrors full_system_simulation.mjs:698-739: the trusted
setups (zkey pickles, computed on the engine's device) and the compiled COO
constraint matrices are disk cached under ``CACHE_DIR``, so a warm run skips
the Python structure build and the setup entirely.  Both proofs run from
the compiled COO form through the fused TorchEngine pipeline.

Run:  python -m zkfl_tpu_torch.fl.prod [--device cuda|cpu] [--json-out PATH]
Exits non-zero unless both proofs verify and bind the same root_D.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

from .. import backend
from ..commit.merkle import MerkleTree
from ..commit.vector_hash import gradient_commitment, sample_hash
from ..field.bn254 import FR, domain_size_for
from ..groth16.engine import TorchEngine
from ..groth16.prover import groth16_prove
from ..groth16.setup import setup_cached
from ..groth16.verifier import groth16_verify
from ..r1cs.balance import BalanceParams
from ..r1cs.circuits import build_structure, generate_witness
from ..r1cs.compiled import compile_and_cache, compiled_cached, n_constraints
from ..r1cs.training import TrainingParams

PROD_N = 128
PROD_DIM = 16
PROD_DEPTH = 7
PROD_BATCH = 8
PROD_SEED = 42
# Beside the round's artifacts (fl/config.py), inside the checkout.
CACHE_DIR = (
    os.path.join(os.environ["ZKFL_ARTIFACTS_DIR"], "prod")
    if os.environ.get("ZKFL_ARTIFACTS_DIR")
    else os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "zkfl_prod_artifacts")
)

BALANCE_PARAMS = BalanceParams(n=PROD_N, depth=PROD_DEPTH, model_dim=PROD_DIM)
V5_PARAMS = TrainingParams(
    batch_size=PROD_BATCH, model_dim=PROD_DIM, depth=PROD_DEPTH,
    precision=1000, variant="v5",
)


class _LCG:
    """integration_test.mjs:67-75 seeded-random semantics."""

    def __init__(self, seed: int = PROD_SEED):
        self.state = seed

    def next(self) -> float:
        self.state = (self.state * 1103515245 + 12345) & 0x7FFFFFFF
        return self.state / 0x7FFFFFFF

    def randint(self, lo: int, hi: int) -> int:
        return lo + int(self.next() * (hi - lo))


def generate_dataset(seed: int = PROD_SEED) -> Dict:
    """Seeded dataset + Merkle commitment (integration_test.mjs:209-252)."""
    rng = _LCG(seed)
    features = [
        [rng.randint(0, 1000) for _ in range(PROD_DIM)] for _ in range(PROD_N)
    ]
    labels = [i % 2 for i in range(PROD_N)]  # exactly balanced
    leaves = [sample_hash(features[i], labels[i]) for i in range(PROD_N)]
    tree = MerkleTree(leaves, PROD_DEPTH)
    return {
        "features": features,
        "labels": labels,
        "tree": tree,
        "root_d": tree.root,
    }


def balance_inputs(ds: Dict, client_id: int = 1) -> Dict:
    tree: MerkleTree = ds["tree"]
    paths = [tree.prove(i) for i in range(PROD_N)]
    c1 = sum(ds["labels"])
    return {
        "client_id": client_id,
        "root": ds["root_d"],
        "N_public": PROD_N,
        "c0": PROD_N - c1,
        "c1": c1,
        "features": ds["features"],
        "labels": ds["labels"],
        "siblings": [p[0] for p in paths],
        "pathIndices": [p[1] for p in paths],
    }


def v5_inputs(ds: Dict, client_id: int = 1, round_num: int = 1) -> Dict:
    """Sign-magnitude gradient within the clipping bound + the first
    PROD_BATCH samples of the shared dataset (binding through root_D)."""
    rng = _LCG(PROD_SEED + 1)
    grad = [rng.randint(-10000, 10001) for _ in range(PROD_DIM)]
    norm_sq = sum(g * g for g in grad)
    tau_squared = max(norm_sq + 1, 76014)  # < 2^60 range check headroom
    grad_pos = [g if g > 0 else 0 for g in grad]
    grad_neg = [-g if g < 0 else 0 for g in grad]
    grad_field = [(p - n) % FR for p, n in zip(grad_pos, grad_neg)]
    tree: MerkleTree = ds["tree"]
    paths = [tree.prove(i) for i in range(PROD_BATCH)]
    return {
        "client_id": client_id,
        "round": round_num,
        "root_D": ds["root_d"],
        "root_G": gradient_commitment(grad_field, client_id, round_num),
        "tauSquared": tau_squared,
        "gradPos": grad_pos,
        "gradNeg": grad_neg,
        "features": ds["features"][:PROD_BATCH],
        "labels": ds["labels"][:PROD_BATCH],
        "siblings": [p[0] for p in paths],
        "pathIndices": [p[1] for p in paths],
    }


def _structure(params, cache_dir: str, log):
    """(compiled form, structure-mode CS or None).  The warm path loads the
    COO cache and skips the Python constraint build; the cold path builds
    the structure once, fills the cache, and hands the structure on for the
    trusted setup."""
    cc = compiled_cached(params, cache_dir)
    if cc is not None:
        return cc, None
    t0 = time.time()
    cs = build_structure(params)
    log(f"{params.name}: structure built in {time.time()-t0:.1f}s "
        f"({len(cs.constraints)} constraints)")
    return compile_and_cache(cs, cache_dir), cs


def _setup(cc, full, params, cache_dir: str, domain, device, log):
    """(pk, vk) of one circuit: from the zkey cache, else set up on
    ``device`` from its structure ``full``.  A cache miss with only the COO
    form on disk rebuilds the full structure once to run the trusted setup.
    ``domain`` None means the circuit's natural domain, named explicitly so
    the zkey cache key is the same whether or not a profile-bearing engine
    is passed."""
    dom = domain or domain_size_for(n_constraints(cc) + 1)
    try:
        return setup_cached(cc if full is None else full, cache_dir, domain=dom, device=device)
    except ValueError:
        log(f"{params.name}: zkey cache cold — rebuilding full structure")
        return setup_cached(build_structure(params), cache_dir, domain=dom, device=device)


def verify_binding(balance_publics: List[int], v5_publics: List[int]) -> bool:
    """Cross-proof binding: the balance proof's Merkle root (public #2,
    wire layout per build_balance declaration order) must equal the
    training proof's root_D (public #3) — integration_test.mjs:672-697."""
    return balance_publics[1] == v5_publics[2]


def run_prod_integration(
    cache_dir: str = CACHE_DIR, verbose: bool = True, engine: TorchEngine | None = None,
) -> Dict:
    """The production run on ``engine`` (default: a TorchEngine on the first
    CUDA card); the setups run on the engine's device."""
    def log(msg):
        if verbose:
            print(f"# {msg}", flush=True)

    if engine is None:
        engine = TorchEngine(backend.device("cuda"))
    timings: Dict[str, float] = {}
    t_all = time.time()

    # --- circuits (cached compiled forms + cached setups) ----------------
    t0 = time.time()
    bal_cc, bal_full = _structure(BALANCE_PARAMS, cache_dir, log)
    v5_cc, v5_full = _structure(V5_PARAMS, cache_dir, log)
    timings["structures_s"] = time.time() - t0

    # Per-circuit native domains: the two circuits differ 14x in size
    # (357,764 vs 25,858 constraints), so padding sgd_v5 to the balance
    # circuit's 2^19 domain would waste device work on every v5 proof.
    domain = getattr(engine.profile, "domain", None)
    t0 = time.time()
    bal_pk, bal_vk = _setup(bal_cc, bal_full, BALANCE_PARAMS, cache_dir, domain, engine.device, log)
    v5_pk, v5_vk = _setup(v5_cc, v5_full, V5_PARAMS, cache_dir, domain, engine.device, log)
    del bal_full, v5_full
    timings["setups_s"] = time.time() - t0
    log(f"setups ready in {timings['setups_s']:.1f}s")

    # --- dataset + witnesses ---------------------------------------------
    t0 = time.time()
    ds = generate_dataset()
    timings["dataset_s"] = time.time() - t0
    t0 = time.time()
    bal_wit = generate_witness(BALANCE_PARAMS, balance_inputs(ds))
    v5_wit = generate_witness(V5_PARAMS, v5_inputs(ds))
    timings["witness_s"] = time.time() - t0
    log(f"witnesses in {timings['witness_s']:.2f}s")

    # --- proofs (first = key upload + run, second = steady state) --------
    t0 = time.time()
    bal_proof = groth16_prove(bal_pk, bal_cc, bal_wit.witness, engine=engine)
    timings["balance_prove_first_s"] = time.time() - t0
    t0 = time.time()
    v5_proof = groth16_prove(v5_pk, v5_cc, v5_wit.witness, engine=engine)
    timings["v5_prove_first_s"] = time.time() - t0
    log(f"first proves: balance {timings['balance_prove_first_s']:.1f}s, "
        f"v5 {timings['v5_prove_first_s']:.1f}s")
    t0 = time.time()
    bal_proof = groth16_prove(bal_pk, bal_cc, bal_wit.witness, engine=engine)
    timings["balance_prove_s"] = time.time() - t0
    t0 = time.time()
    v5_proof = groth16_prove(v5_pk, v5_cc, v5_wit.witness, engine=engine)
    timings["v5_prove_s"] = time.time() - t0
    timings["prove_total_s"] = timings["balance_prove_s"] + timings["v5_prove_s"]

    # --- verify + binding --------------------------------------------------
    t0 = time.time()
    ok_bal = groth16_verify(bal_vk, bal_proof)
    ok_v5 = groth16_verify(v5_vk, v5_proof)
    timings["verify_s"] = time.time() - t0
    bound = verify_binding(bal_proof.public_signals, v5_proof.public_signals)
    timings["total_s"] = time.time() - t_all

    result = {
        "balance_verified": ok_bal,
        "v5_verified": ok_v5,
        "binding_ok": bound,
        "constraints": {"balance": bal_cc.n_constraints, "v5": v5_cc.n_constraints},
        "baseline_prove_s": 231.5,  # Report.pdf Table 5, N=128
        "vs_baseline": round(231.5 / max(timings["prove_total_s"], 1e-9), 2),
        "timings": {k: round(v, 3) for k, v in timings.items()},
    }
    log(json.dumps(result))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ZK-FL production run on the PyTorch/CUDA prover")
    ap.add_argument("--device", default="cuda", help="cuda or cpu (default cuda)")
    ap.add_argument("--json-out", default=None, help="write the result dict here")
    args = ap.parse_args(argv)

    res = run_prod_integration(engine=TorchEngine(backend.device(args.device)))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"# wrote {os.path.abspath(args.json_out)}")
    if not (res["balance_verified"] and res["v5_verified"] and res["binding_ok"]):
        print(f"production run failed: {res}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
