#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkfl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this checkout; imports nothing of JAX.
Phases (any failure raises and exits non-zero):
  1. probe: card name and power limit, CUDA / nvcc / Triton versions;
  2. build the four CUDA kernels from zkfl_tpu_torch/csrc;
  3. every kernel op against its plain torch version on the same random
     canonical inputs at main-path lane counts (exact equality), with the
     card time of each (profiler) and the wall time per call;
  4. MICRO_CONFIG balance proof on TorchEngine == the shared HostEngine's,
     bit for bit, under deterministic blinding;
  5. one REFERENCE_CONFIG FL round through the port's RoundProver and the
     shared run_round: 3 clients batched, 9 proofs verified by the native
     verifier, masks cancel; every kernel of the path launched.
The last two lines are the kernel report and the device line, both JSON.
"""

import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIELD_LANES = 1 << 18   # main-path lane counts: matrix terms, NTT stages
POINT_LANES = 1 << 17   # the G1 MSM's serial-scan launches are ~2^17.6 lanes
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def call_ms(fn, reps: int) -> float:
    """Wall time per call of fn() back to back (CUDA events over reps calls,
    after one warm-up): the larger of the host's and the card's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Card time per call of fn(): the summed duration of the CUDA kernels and
    copies the profiler records over reps calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no CUDA activity")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def max_abs_err(a, b) -> int:
    import torch

    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def rand_elems(gen, n, dev, p):
    """Random canonical elements int32 [8, n] (< 2^252 < p), lanes 0-2 set
    to 0, 1 and p - 1."""
    import torch

    from zkfl_tpu_torch.field.limbs import ints_to_limbs

    x = torch.randint(-(2**31), 2**31 - 1, (8, n), dtype=torch.int32, device=dev, generator=gen)
    x[7] &= 0x0FFFFFFF
    x[:, :3] = torch.from_numpy(ints_to_limbs([0, 1, p - 1])).to(dev)
    return x


def phase_kernels(dev, backend):
    """Phase 3: each kernel op vs its plain version; returns report rows."""
    import torch

    from zkfl_tpu.field.curve import G1_GEN, g1_add, g1_mul
    from zkfl_tpu_torch.ops import point_kernels as pk
    from zkfl_tpu_torch.ops.limb_kernels import FQK, FRK

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = {}

    def check(name, kernel_fn, plain_fn, reps=20, plain_reps=3):
        k_out, p_out = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = max_abs_err(k_out, p_out)
        if err != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version (max |diff| {err})")
        row = rows[name] = {"max_abs_err": err, "ms": device_ms(kernel_fn, reps),
                            "plain_ms": device_ms(plain_fn, plain_reps)}
        call, plain_call = call_ms(kernel_fn, reps), call_ms(plain_fn, plain_reps)
        log(f"  {name:22s} equal; card ms kernel {row['ms']:.4f} plain {row['plain_ms']:.3f}; "
            f"ms per call kernel {call:.4f} plain {plain_call:.3f}")
        return k_out

    n = FIELD_LANES
    for F in (FRK, FQK):
        a, b, c = (rand_elems(gen, n, dev, F.p) for _ in range(3))
        k = 0x1234567890ABCDEF1234567890ABCDEF * F.mont_r % F.p
        f = F.name
        check(f"{f}.mont_mul", lambda: F.mont_mul(a, b), lambda: F.mont_mul_plain(a, b))
        check(f"{f}.add", lambda: F.add(a, b), lambda: F.add_plain(a, b))
        check(f"{f}.sub", lambda: F.sub(a, b), lambda: F.sub_plain(a, b))
        check(f"{f}.to_mont", lambda: F.to_mont(a), lambda: F.to_mont_plain(a))
        check(f"{f}.from_mont", lambda: F.from_mont(a), lambda: F.from_mont_plain(a))
        check(f"{f}.mont_mul_const", lambda: F.mont_mul_const(a, k), lambda: F.mont_mul_const_plain(a, k))
        check(f"{f}.mul_sub_mul_const", lambda: F.mul_sub_mul_const(a, b, c, k),
              lambda: F.mul_sub_mul_const_plain(a, b, c, k))
        if F is FRK:
            check("fr.butterfly", lambda: F.butterfly(a, b, c), lambda: F.butterfly_plain(a, b, c))
            cols = torch.randint(0, 2**40, (8, n), dtype=torch.int64, device=dev, generator=gen)
            cols[:, 0] = 2**63 - 1
            cols[:, 1] = 0
            check("fr.normalize_raw", lambda: F.normalize_raw(cols), lambda: F.normalize_raw_plain(cols))

    # G1: random projective points (sums of two affine points, Z != 1), then
    # the identity, P + P and P + (-P) in the first lanes.
    base = [g1_mul(G1_GEN, 1000003 * i + 7) for i in range(64)]
    bdev = pk.g1_to_device(base, dev)
    idx = torch.randint(0, 64, (4, POINT_LANES), device=dev, generator=gen)
    P = pk.padd_plain(bdev[..., idx[0]], bdev[..., idx[1]])
    Q = pk.padd_plain(bdev[..., idx[2]], bdev[..., idx[3]])
    inf = pk.inf_point((1,), dev)[..., 0]
    P[..., 0], Q[..., 1] = inf, inf            # P + O, O + Q
    Q[..., 2] = P[..., 2]                      # P + P
    Q[..., 3] = P[..., 3]                      # P + (-P): negate Y
    Q[1, :, 3] = FQK.sub(torch.zeros_like(P[1, :, 3:4]), P[1, :, 3:4])[:, 0]
    P[..., 4], Q[..., 4] = inf, inf            # O + O
    out = check("g1.padd", lambda: pk.padd(P, Q), lambda: pk.padd_plain(P, Q), reps=10, plain_reps=2)
    host_p = [pk.g1_from_device(P[..., i]) for i in range(6)]
    host_q = [pk.g1_from_device(Q[..., i]) for i in range(6)]
    if [pk.g1_from_device(out[..., i]) for i in range(6)] != [g1_add(x, y) for x, y in zip(host_p, host_q)]:
        raise AssertionError("g1.padd: edge lanes disagree with the host curve oracle")
    out = check("g1.pdbl", lambda: pk.pdbl(P), lambda: pk.pdbl_plain(P), reps=10, plain_reps=2)
    if [pk.g1_from_device(out[..., i]) for i in range(6)] != [g1_add(x, x) for x in host_p]:
        raise AssertionError("g1.pdbl: edge lanes disagree with the host curve oracle")
    return rows


def phase_micro_parity(dev, artifacts):
    """Phase 4: MICRO_CONFIG balance proof, TorchEngine vs HostEngine."""
    from zkfl_tpu.fl.client import Client, SharedLCG
    from zkfl_tpu.fl.config import MICRO_CONFIG
    from zkfl_tpu.groth16.engine import HostEngine
    from zkfl_tpu.groth16.verifier import groth16_verify
    from zkfl_tpu.r1cs.circuits import build_structure
    from zkfl_tpu_torch.groth16.engine import TorchEngine
    from zkfl_tpu_torch.groth16.prover import groth16_prove
    from zkfl_tpu_torch.groth16.setup import setup_cached

    saved = os.environ.get("ZKFL_DETERMINISTIC_BLINDING")
    os.environ["ZKFL_DETERMINISTIC_BLINDING"] = "1"
    try:
        cs = build_structure(MICRO_CONFIG.balance_params)
        pk, vk = setup_cached(cs, artifacts)
        client = Client(1, MICRO_CONFIG, None)
        client.generate_private_dataset(SharedLCG(MICRO_CONFIG.seed))
        client.compute_dataset_commitment()
        witness = client.balance_witness()
        t0 = time.time()
        p_torch = groth16_prove(pk, cs, witness, engine=TorchEngine(dev))
        t1 = time.time()
        p_host = groth16_prove(pk, cs, witness, engine=HostEngine())
        t2 = time.time()
    finally:
        if saved is None:
            del os.environ["ZKFL_DETERMINISTIC_BLINDING"]
        else:
            os.environ["ZKFL_DETERMINISTIC_BLINDING"] = saved
    same = (p_torch.pi_a, p_torch.pi_b, p_torch.pi_c, p_torch.public_signals) == \
        (p_host.pi_a, p_host.pi_b, p_host.pi_c, p_host.public_signals)
    if not same:
        raise AssertionError("MICRO balance proof: TorchEngine != HostEngine")
    if not groth16_verify(vk, p_torch):
        raise AssertionError("MICRO balance proof does not verify")
    log(f"  {cs.name}: {cs.n_wires} wires, domain {pk.domain}; torch {t1 - t0:.2f} s, "
        f"host {t2 - t1:.2f} s; proofs equal bit for bit and verify")


def phase_round(dev, artifacts, backend):
    """Phase 5: one REFERENCE_CONFIG round on the port; returns launch counts."""
    import torch

    from zkfl_tpu.commit.vector_hash import from_field
    from zkfl_tpu.field.bn254 import FR
    from zkfl_tpu.fl.config import REFERENCE_CONFIG
    from zkfl_tpu.fl.simulation import run_round
    from zkfl_tpu_torch.fl.prover import RoundProver
    from zkfl_tpu_torch.groth16.engine import TorchEngine

    cfg = REFERENCE_CONFIG
    t0 = time.time()
    prover = RoundProver(cfg, TorchEngine(dev), cache_dir=artifacts)
    log(f"  setups ready in {time.time() - t0:.1f} s; profile {prover.engine.profile}")
    for cs in (prover.balance_cs, prover.training_cs, prover.secagg_cs):
        log(f"  {cs.name}: {cs.n_wires} wires, {len(cs.constraints)} constraints")

    backend.LAUNCHES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    server, timings = run_round(cfg, prover=prover, verbose=False)
    torch.cuda.synchronize()
    launches = dict(backend.LAUNCHES)

    for name in ("setup", "datasets", "commitments", "balance_proofs", "training_proofs",
                 "secagg_proofs", "aggregate", "total"):
        log(f"  phase {name:16s} {timings[name]:9.3f} s")
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    summary = server.get_summary()
    log(f"  summary {summary}")
    if not summary["all_passed"]:
        raise AssertionError(f"round failed: {summary}")
    proofs = sum(v["passed"] for k, v in summary.items()
                 if isinstance(v, dict) and k in ("balance", "training", "secagg"))
    if proofs != 3 * cfg.num_clients:
        raise AssertionError(f"{proofs} proofs verified, expected {3 * cfg.num_clients}")
    ids = sorted(server.secagg_updates)
    true_sum = [sum(server.training_updates[c].gradient[j] for c in ids) % FR
                for j in range(cfg.model_dim)]
    want = [from_field(v) / len(ids) for v in true_sum]
    masked = [server.secagg_updates[c].masked_update for c in ids]
    if server.aggregated_gradient != want or all(
            m == [g % FR for g in server.training_updates[c].gradient] for c, m in zip(ids, masked)):
        raise AssertionError("masks did not cancel in the aggregate")
    log(f"  {proofs} proofs verified; masks cancel: aggregate {server.aggregated_gradient}")
    return launches


# kernel op -> (route, source, the TPU kernel it replaces)
KERNELS = {
    "fr.to_mont": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:374"),
    "fr.mont_mul": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:357"),
    "fr.mont_mul_const": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:571"),
    "fr.mul_sub_mul_const": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:396"),
    "fr.from_mont": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:370"),
    "fr.butterfly": ("ntt_butterfly.cu", "zkfl_tpu/ops/limb_kernels.py:380"),
    "fr.normalize_raw": ("normalize_raw.cu", "zkfl_tpu/ops/limb_kernels.py:387"),
    "fq.to_mont": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:374"),
    "fq.mont_mul": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:357"),
    "fq.add": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:364"),
    "fq.sub": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:367"),
    "g1.padd": ("g1_point.cu", "zkfl_tpu/ops/point_kernels.py:68"),
    "g1.pdbl": ("g1_point.cu", "zkfl_tpu/ops/point_kernels.py:101"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from zkfl_tpu_torch import backend

    t_start = time.time()
    dev = backend.device("cuda:0")
    artifacts = os.path.join(REPO, "build", "zkfl_artifacts")

    log("[1] probe")
    info = backend.probe()
    smi = backend.gpu_name_and_power_limit()
    if smi is None:
        raise RuntimeError("nvidia-smi did not report the card")
    print(smi, flush=True)
    log(f"  {json.dumps(info)}")

    log("[2] build")
    t0 = time.time()
    lib_path = backend.build()
    backend.lib()
    log(f"  {lib_path} in {time.time() - t0:.1f} s")
    entry, spills = None, ""
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = next((k for k in ("field_ew", "butterfly", "normalize_raw", "g1_padd", "g1_pdbl")
                          if f"{k}_kernel" in mangled), mangled)
            m = re.search(r"IN2zk2(F[rq])ELi(\d)E", mangled)
            entry += f"<{m.group(1)}, op {m.group(2)}>" if m else ""
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used")[1].split(",")[0].strip()
            log(f"  ptxas {entry}: {regs}; {spills}")

    log("[3] kernels vs plain versions")
    t0 = time.time()
    rows = phase_kernels(dev, backend)
    log(f"  phase 3 in {time.time() - t0:.1f} s")

    log("[4] MICRO_CONFIG balance proof parity")
    t0 = time.time()
    phase_micro_parity(dev, artifacts)
    log(f"  phase 4 in {time.time() - t0:.1f} s")

    log("[5] REFERENCE_CONFIG round")
    t0 = time.time()
    launches = phase_round(dev, artifacts, backend)
    log(f"  phase 5 in {time.time() - t0:.1f} s")
    for name in sorted(launches):
        log(f"  launches {name:24s} {launches[name]}")
    missing = [name for name in KERNELS if launches.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"kernels of the path never launched: {missing}")

    report = [
        {"name": name, "route": "cuda", "source": f"zkfl_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"]}
        for name, (src, tpu) in KERNELS.items()
    ]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
