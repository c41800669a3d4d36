"""Benchmark of the port on one NVIDIA card (the counterpart of the
repository's bench.py, function for function).

    python -m zkfl_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "extras"}
on stdout, the log on stderr.

Headline: the balance_unified(8,3,4) Groth16 prove (baseline: snarkjs
4.2 s on the reference i7-10750H, Report.pdf Table 3).  value = the steady
wall time witness -> proof through the fused device pipeline, padded to
REFERENCE_CONFIG's shared PipelineProfile (the shape a round proves at),
over 3 calls; vs_baseline = baseline / ours (> 1: faster than the
reference).  Every proof is verified by the native pairing check.

extras:
  witness_ms              balance witness generation (baseline 45 ms)
  first_prove_s           the first prove: key upload, COO stream, NTT tables
  verify_ms               native verification per proof (baseline 8.1 ms)
  full_round_3clients_s   a REFERENCE_CONFIG round, 3 clients x 3 proofs,
                          clients one at a time (baseline 43 s, Table 4)
  prove_per_client_s      balance + training + secagg (baseline 14.1 s)
  mont_mul_gops_s         K1 fr.mont_mul, 10 chained calls over 2^22 lanes
  poseidon_khashes_s      K5 t=3 permutations over 2^16 states, 5 calls
  ntt_melems_s            ops/qap.py ntt over 3 x 2^14, 10 chained calls
  msm_g1_mpoints_s        msm_batch_g1, 4 x 16,384 points, 5 calls
  msm_g1_prodsize_mpoints_s  msm_batch_g1 over 2^19 points, 3 calls
  msm_g2_mpoints_s        msm_batch_g2 over 16,384 points, 5 calls
  *_mfu                   the rate x the op's fewest 32-bit multiply-adds
                          (costs.py) / the card's derived integer peak
                          (132 SMs x 64 lanes x the max SM clock: derived,
                          not measured, so possibly off 2x); None off the card
  gpu                     nvidia-smi's name and power limit of the card

The rate MSMs repeat 32 G1 (8 G2) bases over their lanes, so each result is
also held against sum_j base_j * (sum_{i = j mod 32} s_i), computed with the
host curve.  Kernel times are CUDA events around the chained calls.

Wall-clock budget: the run limits itself to ZKFL_BENCH_BUDGET seconds
(default 540): an extra whose turn comes when the budget runs low is
skipped and named in "skipped_after", and a SIGALRM backstop emits the
line with what was measured.  An extra that raises fails the run.  If the
headline was not measured the run exits non-zero with an "error" field.
ZKFL_BENCH_QUICK=1 measures the headline only.  Without a CUDA card the run
exits non-zero before any setup; it runs on the CPU only with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
import traceback

BASELINE_PROVE_S = 4.2        # Report.pdf Table 3, balance circuit
BASELINE_ROUND_S = 43.0       # Report.pdf Table 4, 3-client round
BASELINE_WITNESS_MS = 45.0    # Report.pdf Table 3, balance witness
BASELINE_CLIENT_PROVE_S = 14.1
BASELINE_VERIFY_MS = 8.1      # Report.pdf Table 3

# What a whole run's extras hold; a run cut by its budget adds
# "skipped_after" (and "full_round_is_warmup") and lacks what it skipped.
EXTRA_KEYS = (
    "gpu", "witness_ms", "witness_vs_baseline", "first_prove_s", "verify_ms",
    "verify_vs_baseline", "full_round_3clients_s", "full_round_vs_baseline", "round_phases_s",
    "prove_per_client_s", "prove_per_client_vs_baseline", "mont_mul_gops_s", "mont_mul_mfu",
    "poseidon_khashes_s", "poseidon_mfu", "ntt_melems_s", "msm_g1_mpoints_s",
    "msm_g1_prodsize_mpoints_s", "msm_g2_mpoints_s",
)
G1_BASES, G2_BASES = 32, 8    # distinct bases repeated over the rate MSMs' lanes


class Bench:
    """One run: its result line and its wall-clock budget."""

    def __init__(self, budget: float):
        self.t0 = time.time()
        self.budget = budget
        self.result = {
            "metric": "balance_unified(8,3,4) groth16 prove",
            "value": -1.0,
            "unit": "s",
            "vs_baseline": 0.0,
            "extras": {},
        }
        self.extras = self.result["extras"]
        self.checked = []     # the rate MSMs held against their repeated-base sums
        self._emitted = False

    def remaining(self) -> float:
        return self.budget - (time.time() - self.t0)

    def log(self, msg: str) -> None:
        print(f"# [{time.time() - self.t0:6.1f}s] {msg}", file=sys.stderr, flush=True)

    def emit(self) -> None:
        if not self._emitted:
            self._emitted = True
            print(json.dumps(self.result), flush=True)

    def skip(self, after: str) -> None:
        """Record that the budget ran low after ``after`` (the first skip
        names where the run stopped)."""
        self.extras.setdefault("skipped_after", after)
        self.log(f"budget low: extras skipped after {self.extras['skipped_after']}")


# ---------------------------------------------------------------------------
# Timing and data
# ---------------------------------------------------------------------------


def timed(fn, dev):
    """(fn(), seconds): CUDA events around the call on a card (the host
    clock with a synchronise elsewhere)."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end) / 1e3


def random_fr(rng, n: int):
    """n values uniform in [0, r) as standard-form int32 [8, n] limbs,
    drawn in bulk: 254-bit draws, those below r kept."""
    import numpy as np

    from .field.bn254 import FR

    r_words = np.array([(FR >> (32 * k)) & 0xFFFFFFFF for k in range(8)], dtype=np.uint32)
    kept = []
    have = 0
    while have < n:  # about 3 draws in 4 are kept
        w = rng.integers(0, 1 << 32, size=(int(1.4 * (n - have)) + 64, 8), dtype=np.uint32)
        w[:, 7] &= (1 << 30) - 1
        below, equal = np.zeros(len(w), dtype=bool), np.ones(len(w), dtype=bool)
        for k in range(7, -1, -1):
            below |= equal & (w[:, k] < r_words[k])
            equal &= w[:, k] == r_words[k]
        kept.append(w[below])
        have += int(below.sum())
    return np.ascontiguousarray(np.concatenate(kept)[:n].T).view(np.int32)


def class_sums(scalars, period: int) -> list:
    """int32 [m, 8, n] standard-form scalars -> for each row k the sums
    c[k][j] = sum_{i = j mod period} s_{k,i} mod r (n a multiple of period)."""
    import numpy as np

    from .field.bn254 import FR

    s = np.asarray(scalars.cpu() if hasattr(scalars, "cpu") else scalars)
    m, limbs, n = s.shape
    if n % period:
        raise ValueError(f"{n} lanes are not a multiple of the period {period}")
    cols = s.view(np.uint32).astype(np.uint64).reshape(m, limbs, n // period, period).sum(axis=2)
    return [[sum(int(cols[k, l, j]) << (32 * l) for l in range(limbs)) % FR for j in range(period)]
            for k in range(m)]


def _point_key(p):
    if p is None or isinstance(p[0], int):
        return p
    return tuple(tuple(c.coeffs) for c in p)


def check_repeated_msm(name: str, out, bases, scalars, group: str) -> None:
    """Hold an MSM over bases[i % len(bases)] (out [3, (2,), 8, m]) against
    sum_j bases[j] * c_j for each of its m rows, by len(bases) host scalar
    multiplications a row; raises AssertionError where a row differs."""
    from .field import curve
    from .ops import point_kernels as pk

    mul, add, from_dev = ((curve.g1_mul, curve.g1_add, pk.g1_from_device) if group == "g1"
                          else (curve.g2_mul_jac, curve.g2_add, pk.g2_from_device))
    for k, coeffs in enumerate(class_sums(scalars, len(bases))):
        want = None
        for base, c in zip(bases, coeffs):
            want = add(want, mul(base, c))
        if _point_key(from_dev(out[..., k])) != _point_key(want):
            raise AssertionError(f"{name}: row {k} of the MSM != sum_j base_j * c_j on the host curve")


def g1_bases():
    from .field.curve import G1_GEN, g1_mul

    return [g1_mul(G1_GEN, 2 + i) for i in range(G1_BASES)]


def g2_bases():
    from .field.curve import g2_generator, g2_mul_jac

    return [g2_mul_jac(g2_generator(), 2 + i) for i in range(G2_BASES)]


def canonical_client(cfg, client_id: int = 1):
    """Client ``client_id`` of a round under ``cfg`` with its dataset and
    commitment (deterministic seeds)."""
    from .fl.client import Client, SharedLCG

    client = Client(client_id, cfg, None)
    client.generate_private_dataset(SharedLCG(cfg.seed))
    client.compute_dataset_commitment()
    return client


def balance_inputs(client) -> dict:
    """The balance circuit's inputs of a client with a committed dataset."""
    cfg = client.cfg
    sib, idx = client._merkle_paths(cfg.n)
    return {
        "client_id": client.client_id, "root": client.root_d, "N_public": cfg.n,
        "c0": client.c0, "c1": client.c1,
        "features": client.features, "labels": client.labels,
        "siblings": sib, "pathIndices": idx,
    }


# ---------------------------------------------------------------------------
# The measurements
# ---------------------------------------------------------------------------


def headline(b: Bench, prover) -> None:
    """Witness, first prove, the steady prove (the headline) and verify."""
    from .groth16.prover import groth16_prove
    from .groth16.verifier import groth16_verify
    from .r1cs.circuits import generate_witness

    cfg, engine = prover.cfg, prover.engine
    pk, vk, cs = prover.balance_pk, prover.balance_vk, prover.balance_cs
    inputs = balance_inputs(canonical_client(cfg))
    t0 = time.time()
    wit = generate_witness(cfg.balance_params, inputs).witness
    b.extras["witness_ms"] = (time.time() - t0) * 1e3
    b.extras["witness_vs_baseline"] = BASELINE_WITNESS_MS / max(b.extras["witness_ms"], 1e-9)
    b.log(f"witness {b.extras['witness_ms']:.1f} ms")

    t0 = time.time()
    proof = groth16_prove(pk, cs, wit, engine=engine)
    b.extras["first_prove_s"] = time.time() - t0
    if not groth16_verify(vk, proof):
        raise AssertionError("the first balance proof does not verify")
    b.log(f"first prove {b.extras['first_prove_s']:.3f} s")

    n_it = 3
    t0 = time.time()
    proofs = [groth16_prove(pk, cs, wit, engine=engine) for _ in range(n_it)]
    t_prove = (time.time() - t0) / n_it
    if not all(groth16_verify(vk, p) for p in proofs):
        raise AssertionError("a steady balance proof does not verify")
    b.result["value"] = t_prove
    b.result["vs_baseline"] = BASELINE_PROVE_S / t_prove
    b.log(f"balance prove steady {t_prove:.4f} s (vs_baseline {b.result['vs_baseline']:.2f})")

    t0 = time.time()
    for _ in range(10):
        if not groth16_verify(vk, proofs[-1]):
            raise AssertionError("a balance proof failed its repeated verification")
    b.extras["verify_ms"] = (time.time() - t0) / 10 * 1e3
    b.extras["verify_vs_baseline"] = BASELINE_VERIFY_MS / b.extras["verify_ms"]
    b.log(f"verify {b.extras['verify_ms']:.2f} ms/proof")


def _round(prover):
    from .fl.simulation import run_round

    server, timings = run_round(prover.cfg, prover=prover, verbose=False, batch_clients=False)
    summary = server.get_summary()
    if not summary["all_passed"]:
        raise AssertionError(f"a round's proofs failed: {summary}")
    return timings


def extras_round(b: Bench, prover) -> None:
    """A whole round, 3 clients x (balance + training + secagg), clients one
    at a time through the headline's pipeline (the batched round is
    scripts/round8.py's): a warm-up round, then the measured one."""
    if b.remaining() < 60:
        b.skip("headline")
        return
    warm = _round(prover)
    b.log(f"warm-up round total {warm['total']:.2f} s")
    b.extras["full_round_3clients_s"] = warm["total"]
    b.extras["full_round_vs_baseline"] = BASELINE_ROUND_S / warm["total"]
    if b.remaining() < warm["total"] * 1.3 + 30:
        b.extras["full_round_is_warmup"] = True
        b.log("budget low: reporting the warm-up round as full_round")
        return
    timings = _round(prover)
    b.extras["full_round_3clients_s"] = timings["total"]
    b.extras["full_round_vs_baseline"] = BASELINE_ROUND_S / timings["total"]
    b.extras["round_phases_s"] = {k: v for k, v in timings.items() if k != "total"}
    per_client = (timings["balance_proofs"] + timings["training_proofs"]
                  + timings["secagg_proofs"]) / prover.cfg.num_clients
    b.extras["prove_per_client_s"] = per_client
    b.extras["prove_per_client_vs_baseline"] = BASELINE_CLIENT_PROVE_S / per_client
    b.log(f"full round {timings['total']:.3f} s, {per_client:.3f} s of proving a client")


def _mfu(rate: float, madds: int, sm_mhz):
    from .costs import int32_peak

    return None if sm_mhz is None else rate * madds / int32_peak(sm_mhz)


def extras_kernels(b: Bench, dev) -> None:
    """Kernel rates: the field product, Poseidon, the NTT, a G1 MSM."""
    import numpy as np
    import torch

    from . import backend
    from .costs import op_cost, poseidon_madds
    from .ops import point_kernels as pk
    from .ops.limb_kernels import FRK
    from .ops.msm import msm_batch_g1
    from .ops.poseidon import PoseidonKernel
    from .ops.qap import ntt

    rng = np.random.default_rng(7)
    sm_mhz = backend.max_sm_clock_mhz() if dev.type == "cuda" else None

    # K1: each product feeds the next
    if b.remaining() < 45:
        b.skip("headline")
        return
    n_mm, k_mm = 1 << 22, 10
    x0 = torch.from_numpy(random_fr(rng, n_mm)).to(dev)
    y = torch.from_numpy(random_fr(rng, n_mm)).to(dev)

    def mm_chain():
        x = x0
        for _ in range(k_mm):
            x = FRK.mont_mul(x, y)
        return x

    mm_chain()
    _, secs = timed(mm_chain, dev)
    rate = k_mm * n_mm / secs
    b.extras["mont_mul_gops_s"] = rate / 1e9
    b.extras["mont_mul_mfu"] = _mfu(rate, op_cost("fr.mont_mul")[0], sm_mhz)
    b.log(f"mont_mul {b.extras['mont_mul_gops_s']:.3f} G/s (mfu {b.extras['mont_mul_mfu']})")
    del x0, y

    # K5: the states (7 i + 3) in Montgomery form
    if b.remaining() < 45:
        b.skip("mont_mul")
        return
    n_hash, k_hash = 1 << 16, 5
    std = np.zeros((8, 3 * n_hash), dtype=np.int32)
    std[0] = np.arange(3 * n_hash, dtype=np.int64) * 7 + 3
    state = FRK.to_mont(torch.from_numpy(std).to(dev)).reshape(8, n_hash, 3)
    perm = PoseidonKernel(3)
    perm.permute(state)

    def permutes():
        for _ in range(k_hash):
            out = perm.permute(state)
        return out

    _, secs = timed(permutes, dev)
    rate = k_hash * n_hash / secs
    b.extras["poseidon_khashes_s"] = rate / 1e3
    b.extras["poseidon_mfu"] = _mfu(rate, poseidon_madds(3), sm_mhz)
    b.log(f"poseidon {b.extras['poseidon_khashes_s']:.1f} khashes/s (mfu {b.extras['poseidon_mfu']})")

    # K2 and K1 through the NTT of the prover, each transform feeding the next
    if b.remaining() < 45:
        b.skip("poseidon")
        return
    n_ntt, k_ntt = 16384, 10
    x1 = torch.from_numpy(random_fr(rng, n_ntt)).to(dev)
    x3 = torch.stack([x1, x1, x1], dim=1)     # [8, 3, n]

    def ntt_chain():
        v = x3
        for _ in range(k_ntt):
            v = ntt(v)
        return v

    ntt_chain()
    _, secs = timed(ntt_chain, dev)
    b.extras["ntt_melems_s"] = k_ntt * 3 * n_ntt / secs / 1e6
    b.log(f"ntt {b.extras['ntt_melems_s']:.2f} Melems/s")

    # K4 through the G1 MSM: 4 MSMs of 16,384 points
    if b.remaining() < 90:
        b.skip("ntt")
        return
    n, m, reps = 16384, 4, 5
    bases = g1_bases()
    pd = pk.g1_to_device([bases[i % G1_BASES] for i in range(n)], dev)
    pd4 = pd[:, :, None, :].expand(3, 8, m, n)
    sc = torch.from_numpy(np.stack([random_fr(rng, n) for _ in range(m)])).to(dev)
    msm_batch_g1(pd4, sc)

    def msms():
        for _ in range(reps):
            out = msm_batch_g1(pd4, sc)
        return out

    out, secs = timed(msms, dev)
    b.extras["msm_g1_mpoints_s"] = m * n * reps / secs / 1e6
    check_repeated_msm("msm_g1", out, bases, sc, "g1")
    b.checked.append(f"msm_g1 {m} x {n}")
    b.log(f"msm_g1 {b.extras['msm_g1_mpoints_s']:.3f} Mpoints/s; equal to the repeated-base sums")


def extras_kernels_big(b: Bench, dev) -> None:
    """The production-size G1 MSM (2^19 points, the balance_unified_prod
    lane count) and the G2 MSM."""
    import numpy as np
    import torch

    from .ops import point_kernels as pk
    from .ops.msm import msm_batch_g1, msm_batch_g2

    rng = np.random.default_rng(11)
    n = 16384
    if b.remaining() < 120:
        b.skip("round")
        return
    n_big, reps = 1 << 19, 3
    bases = g1_bases()
    pd = pk.g1_to_device([bases[i % G1_BASES] for i in range(n)], dev)
    pd_big = pd[:, :, None, :].repeat(1, 1, 1, n_big // n)
    sc_big = torch.from_numpy(random_fr(rng, n_big)).to(dev)[None]
    msm_batch_g1(pd_big, sc_big)

    def msms():
        for _ in range(reps):
            out = msm_batch_g1(pd_big, sc_big)
        return out

    out, secs = timed(msms, dev)
    b.extras["msm_g1_prodsize_mpoints_s"] = n_big * reps / secs / 1e6
    check_repeated_msm("msm_g1_prodsize", out, bases, sc_big, "g1")
    b.checked.append(f"msm_g1 1 x {n_big}")
    b.log(f"msm_g1 prod-size {b.extras['msm_g1_prodsize_mpoints_s']:.3f} Mpoints/s; "
          f"equal to the repeated-base sums")
    del pd_big, sc_big, out

    if b.remaining() < 90:
        b.skip("msm_g1_prodsize")
        return
    reps = 5
    bases2 = g2_bases()
    p2 = pk.g2_to_device([bases2[i % G2_BASES] for i in range(n)], dev)[:, :, :, None, :]
    sc = torch.from_numpy(random_fr(rng, n)).to(dev)[None]
    msm_batch_g2(p2, sc)

    def msms2():
        for _ in range(reps):
            out = msm_batch_g2(p2, sc)
        return out

    out, secs = timed(msms2, dev)
    b.extras["msm_g2_mpoints_s"] = n * reps / secs / 1e6
    check_repeated_msm("msm_g2", out, bases2, sc, "g2")
    b.checked.append(f"msm_g2 1 x {n}")
    b.log(f"msm_g2 {b.extras['msm_g2_mpoints_s']:.3f} Mpoints/s; equal to the repeated-base sums")


def measure(b: Bench, prover, quick: bool = False) -> None:
    """The headline on ``prover`` (a RoundProver on a TorchEngine), then,
    unless ``quick``, the round and the kernel rates on its device."""
    from . import backend

    dev = prover.engine.device
    b.extras["gpu"] = backend.gpu_name_and_power_limit() if dev.type == "cuda" else None
    headline(b, prover)
    if quick:
        return
    extras_round(b, prover)
    extras_kernels(b, dev)
    extras_kernels_big(b, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Benchmark of the PyTorch/CUDA prover (one JSON line)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu (default cuda)")
    args = ap.parse_args(argv)
    b = Bench(float(os.environ.get("ZKFL_BENCH_BUDGET", "540")))

    def alarm(signum, frame):  # the backstop: never end without the line
        b.log("BUDGET ALARM: emitting the partial result")
        rc = 0
        if b.result["value"] < 0:
            b.result["error"] = "the headline prove did not finish within the budget"
            rc = 1
        b.emit()
        os._exit(rc)

    old = signal.signal(signal.SIGALRM, alarm)
    signal.alarm(int(b.budget) + 20)
    rc = 0
    try:
        from . import backend
        from .fl.config import REFERENCE_CONFIG
        from .fl.prover import RoundProver
        from .groth16.engine import TorchEngine

        dev = backend.device(args.device)
        t0 = time.time()
        prover = RoundProver(REFERENCE_CONFIG, TorchEngine(dev))
        b.log(f"setups ready in {time.time() - t0:.1f} s (profile {prover.engine.profile})")
        measure(b, prover, quick=bool(os.environ.get("ZKFL_BENCH_QUICK")))
    except Exception as e:
        traceback.print_exc()
        b.log(f"FATAL: {type(e).__name__}: {e}")
        b.result["error"] = f"{type(e).__name__}: {e}"
        rc = 1
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    if b.result["value"] < 0:
        b.result.setdefault("error", "the headline was not measured")
        rc = 1
    b.emit()
    return rc


if __name__ == "__main__":
    sys.exit(main())
