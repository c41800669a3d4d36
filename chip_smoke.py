#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkfl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and this checkout; imports nothing of JAX and
nothing of zkfl_tpu.  Phases (any failure raises and exits non-zero):
  1. probe: card name, power limit and SM clock, CUDA / nvcc / Triton versions;
  2. build the five CUDA kernels (K1-K5) from zkfl_tpu_torch/csrc;
  3. every kernel op against its plain torch version on the same random
     canonical inputs (exact equality): the field ops at 2^18 lanes, the G1
     ops at 2^17, the Poseidon permutation at t = 2, 3, 6, 17 on 2^12
     states; the card time of each (over input sets larger than the L2)
     and the wall time per call;
  4. MICRO_CONFIG balance proof on TorchEngine == HostEngine's, bit for
     bit, under deterministic blinding;
  5. one REFERENCE_CONFIG FL round through the port's RoundProver and
     run_round: 3 clients batched, 9 proofs verified by the native
     verifier, masks cancel; every kernel of the path launched;
  6. a client's dataset commitment on the card: 2^20 samples of 16 features
     and a label, VectorHash per sample and a depth-20 Poseidon Merkle tree;
     each K5 launch of it timed by CUDA events in that run, and 2^12 of its
     states (a seeded slice of every launch) equal permute_plain's;
     32 seeded leaves equal the host hash and their device paths verify to
     the device root; at depth 12 the root equals the native host tree's.
fr.poseidon's row in the kernel report is phase 6's launches.
The last two lines are the kernel report and the device line, both JSON.
"""

import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIELD_LANES = 1 << 18    # main-path lane counts: matrix terms, NTT stages
POINT_LANES = 1 << 17    # the G1 MSM's serial-scan launches are ~2^17.6 lanes
POSEIDON_LANES = 1 << 12
POSEIDON_WIDTHS = (2, 3, 6, 17)
COMMIT_DEPTH = 20        # 2^20 samples: a realistic client's dataset
CHECK_DEPTH = 12         # the depth whose root the native host tree checks
PROD_DIM = 16            # features per sample (zkfl_tpu/fl/prod.py:37-40)
SEED = 20261016

# The card's rates for the bound (H100 SXM: NVIDIA's data sheet for the
# memory; the integer rate is derived, not a data-sheet figure: 132 SMs x
# 64 INT32 lanes x the SM clock, one 32-bit multiply-add per lane a cycle).
HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64
MONT = 2 * 8 * 8 + 8     # 32-bit multiply-adds of one CIOS Montgomery product
SLEEP_CYCLES = 10**8     # about 50 ms of the card's clock
ROTATE = 8               # input sets per timed op: >= 112 MB between reuses


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


def kernel_ms(fn, arg_sets, reps: int) -> float:
    """Card time per call of fn(*args), one kernel launch: CUDA events around
    reps calls queued behind a sleep on the card, so that the host's launch
    overhead opens no gaps between them.  The calls take their arguments
    from arg_sets in turn: with ROTATE sets, the other sets' traffic between
    two uses of one set exceeds the 50 MB L2, so each call reads its inputs
    from HBM, as the bound assumes.  (torch.profiler, used before, dropped
    the records of long kernels here: it reported 8.6 ms for a 43 ms
    Poseidon launch.)"""
    import torch

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn):
    """(result, ms) of one call of fn() between CUDA events (host syncs
    inside fn included)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def poseidon_mont_muls(t: int) -> int:
    """Montgomery products of one width-t permutation: x^5 on t lanes in the
    R_F full rounds and on one lane in the R_P partial ones, a t x t mix in
    every round."""
    from zkfl_tpu_torch.poseidon.grain import R_F, partial_rounds

    return R_F * (3 * t + t * t) + partial_rounds(t) * (3 + t * t)


# op -> (32-bit multiply-adds, bytes read + written) per lane
def op_cost(name: str):
    op = name.split(".", 1)[1]
    if name.startswith("fr.poseidon"):
        t = int(name.split("t=")[1])
        return poseidon_mont_muls(t) * MONT, 2 * t * 32
    return {
        "mont_mul": (MONT, 96), "mont_sqr": (MONT, 64), "add": (0, 96), "sub": (0, 96),
        "to_mont": (MONT, 64), "from_mont": (MONT, 64), "mont_mul_const": (MONT, 64),
        "mul_sub_mul_const": (2 * MONT, 128), "butterfly": (MONT, 160),
        "normalize_raw": (2 * MONT, 96), "padd": (14 * MONT, 288), "pdbl": (9 * MONT, 192),
    }[op]


def bound(name: str, lanes: int, sm_mhz: float):
    """(bound_ms, bound_by) of one call over ``lanes`` lanes: the larger of
    the bytes over the memory rate and the multiply-adds over the integer
    rate."""
    madds, nbytes = op_cost(name)
    t_bytes = lanes * nbytes / HBM_BYTES_PER_S
    t_ops = lanes * madds / (SMS * INT32_LANES * sm_mhz * 1e6)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(dev, backend, sm_mhz):
    """Phase 3: each kernel op vs its plain version; returns report rows."""
    import torch

    from zkfl_tpu_torch.field.curve import G1_GEN, g1_add, g1_mul
    from zkfl_tpu_torch.field.limbs import ints_to_limbs
    from zkfl_tpu_torch.ops import point_kernels as pk
    from zkfl_tpu_torch.ops.limb_kernels import FQK, FRK
    from zkfl_tpu_torch.ops.poseidon import PoseidonKernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = {}

    def check(name, kernel_fn, plain_fn, arg_sets, lanes, reps=24):
        """kernel_fn(*arg_sets[0]) == plain_fn(*arg_sets[0]), then the card
        time over all the sets in turn."""
        counter = name.split(" ")[0]
        args = arg_sets[0]
        before = backend.LAUNCHES[counter]
        k_out = kernel_fn(*args)
        launched = backend.LAUNCHES[counter] - before
        p_out, plain_ms = once_ms(lambda: plain_fn(*args))
        err = max_abs_err(k_out, p_out)
        if err != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version (max |diff| {err})")
        if launched != 1:
            raise AssertionError(f"{name}: {launched} launches of {counter}, expected 1")
        b_ms, b_by = bound(name.replace(" ", ""), lanes, sm_mhz)
        row = rows[name] = {"max_abs_err": err, "ms": kernel_ms(kernel_fn, arg_sets, reps),
                            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "check_launches": launched}
        log(f"  {name:22s} equal; card ms kernel {row['ms']:.4f} bound {b_ms:.4f} ({b_by}); "
            f"ms per call kernel {call_ms(lambda: kernel_fn(*args), reps):.4f} plain {plain_ms:.3f}")
        return k_out

    n = FIELD_LANES
    # one small call first, so no timed plain call pays for loading torch's
    # kernels on the card
    FRK.mont_mul_plain(*(rand_elems(gen, 8, dev, FRK.p) for _ in range(2)))
    for F in (FRK, FQK):
        sets = [tuple(rand_elems(gen, n, dev, F.p) for _ in range(3)) for _ in range(ROTATE)]
        k = 0x1234567890ABCDEF1234567890ABCDEF * F.mont_r % F.p
        f = F.name
        check(f"{f}.mont_mul", lambda a, b, c: F.mont_mul(a, b),
              lambda a, b, c: F.mont_mul_plain(a, b), sets, n)
        check(f"{f}.mont_sqr", lambda a, b, c: F.mont_sqr(a),
              lambda a, b, c: F.mont_sqr_plain(a), sets, n)
        check(f"{f}.add", lambda a, b, c: F.add(a, b), lambda a, b, c: F.add_plain(a, b), sets, n)
        check(f"{f}.sub", lambda a, b, c: F.sub(a, b), lambda a, b, c: F.sub_plain(a, b), sets, n)
        check(f"{f}.to_mont", lambda a, b, c: F.to_mont(a),
              lambda a, b, c: F.to_mont_plain(a), sets, n)
        check(f"{f}.from_mont", lambda a, b, c: F.from_mont(a),
              lambda a, b, c: F.from_mont_plain(a), sets, n)
        check(f"{f}.mont_mul_const", lambda a, b, c: F.mont_mul_const(a, k),
              lambda a, b, c: F.mont_mul_const_plain(a, k), sets, n)
        check(f"{f}.mul_sub_mul_const", lambda a, b, c: F.mul_sub_mul_const(a, b, c, k),
              lambda a, b, c: F.mul_sub_mul_const_plain(a, b, c, k), sets, n)
        if F is FRK:
            check("fr.butterfly", F.butterfly, F.butterfly_plain, sets, n)
            col_sets = []
            for _ in range(ROTATE):
                cols = torch.randint(0, 2**40, (8, n), dtype=torch.int64, device=dev, generator=gen)
                cols[:, 0] = 2**63 - 1
                cols[:, 1] = 0
                col_sets.append((cols,))
            check("fr.normalize_raw", F.normalize_raw, F.normalize_raw_plain, col_sets, n)
        del sets

    # Poseidon: random states, then the all-0, all-1 and all-(p-1) states.
    special = torch.from_numpy(ints_to_limbs([0, 1, FRK.p - 1])).to(dev)
    for t in POSEIDON_WIDTHS:
        s = rand_elems(gen, POSEIDON_LANES * t, dev, FRK.p).reshape(8, POSEIDON_LANES, t)
        s[:, :3, :] = special[:, :, None]
        kern = PoseidonKernel(t)
        check(f"fr.poseidon t={t}", kern.permute, kern.permute_plain, [(s,)], POSEIDON_LANES,
              reps=5)

    # G1: random projective points (sums of two affine points, Z != 1), then
    # the identity, P + P and P + (-P) in the first lanes; the timing's other
    # sets are random affine points.
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
    pairs = [(P, Q)] + [
        tuple(bdev[..., torch.randint(0, 64, (POINT_LANES,), device=dev, generator=gen)]
              for _ in range(2))
        for _ in range(ROTATE - 1)]
    out = check("g1.padd", pk.padd, pk.padd_plain, pairs, POINT_LANES, reps=16)
    host_p = [pk.g1_from_device(P[..., i]) for i in range(6)]
    host_q = [pk.g1_from_device(Q[..., i]) for i in range(6)]
    if [pk.g1_from_device(out[..., i]) for i in range(6)] != [g1_add(x, y) for x, y in zip(host_p, host_q)]:
        raise AssertionError("g1.padd: edge lanes disagree with the host curve oracle")
    out = check("g1.pdbl", pk.pdbl, pk.pdbl_plain, [(p,) for p, _ in pairs], POINT_LANES,
                reps=16)
    if [pk.g1_from_device(out[..., i]) for i in range(6)] != [g1_add(x, x) for x in host_p]:
        raise AssertionError("g1.pdbl: edge lanes disagree with the host curve oracle")
    return rows


def phase_micro_parity(dev, artifacts):
    """Phase 4: MICRO_CONFIG balance proof, TorchEngine vs HostEngine."""
    from zkfl_tpu_torch.fl.client import Client, SharedLCG
    from zkfl_tpu_torch.fl.config import MICRO_CONFIG
    from zkfl_tpu_torch.groth16.engine import HostEngine, TorchEngine
    from zkfl_tpu_torch.groth16.prover import groth16_prove
    from zkfl_tpu_torch.groth16.setup import setup_cached
    from zkfl_tpu_torch.groth16.verifier import groth16_verify
    from zkfl_tpu_torch.r1cs.circuits import build_structure

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

    from zkfl_tpu_torch.commit.vector_hash import from_field
    from zkfl_tpu_torch.field.bn254 import FR
    from zkfl_tpu_torch.fl.config import REFERENCE_CONFIG
    from zkfl_tpu_torch.fl.prover import RoundProver
    from zkfl_tpu_torch.fl.simulation import run_round
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


def dataset(gen, n, dev):
    """n samples of PROD_DIM features in [0, 1000) and the label i % 2, made
    on the card: the values int64 [n, 17] and their standard-form Fr limbs
    int32 [8, n, 17]."""
    import torch

    feats = torch.randint(0, 1000, (n, PROD_DIM), dtype=torch.int64, device=dev, generator=gen)
    labels = torch.arange(n, dtype=torch.int64, device=dev) % 2
    vals = torch.cat([feats, labels[:, None]], dim=1)
    limbs = torch.zeros((8, n, PROD_DIM + 1), dtype=torch.int32, device=dev)
    limbs[0] = vals.to(torch.int32)
    return vals, limbs


def commit(limbs, depth):
    """The dataset commitment on the card: leaves VectorHash(features ||
    label) in Montgomery form, then the Merkle tree; (root, levels)."""
    from zkfl_tpu_torch.ops.limb_kernels import FRK
    from zkfl_tpu_torch.ops.poseidon import merkle_root_device, vector_hash_device

    return merkle_root_device(vector_hash_device(FRK.to_mont(limbs)), depth)


class K5Tap:
    """While active, wraps PoseidonKernel.permute: CUDA events around each
    K5 launch, and copies of POSEIDON_LANES consecutive states (all of
    them where there are fewer) of each launch's input and output, from a
    seeded offset.  The copies are made outside the events."""

    def __init__(self, seed):
        import random

        from zkfl_tpu_torch.ops.poseidon import PoseidonKernel

        self.cls = type(PoseidonKernel(2))     # PoseidonKernel is an lru_cache of the class
        self.rng = random.Random(seed)
        self.launches = []                     # (t, states, start, end, input, output)

    def __enter__(self):
        import torch

        permute = self.permute = self.cls.permute

        def tapped(kern, state):
            b = state.shape[1]
            k = min(b, POSEIDON_LANES)
            off = self.rng.randrange(b - k + 1)
            x = state[:, off:off + k].clone()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = permute(kern, state)
            end.record()
            self.launches.append((kern.t, b, start, end, x, out[:, off:off + k].clone()))
            return out

        self.cls.permute = tapped
        return self

    def __exit__(self, *exc):
        self.cls.permute = self.permute


def phase_commitment(dev, backend, sm_mhz):
    """Phase 6: dataset commitment of 2^20 samples; returns (launch counts,
    the fr.poseidon report row at the commitment's shapes)."""
    import torch

    from zkfl_tpu_torch import native
    from zkfl_tpu_torch.commit.merkle import MerkleTree, verify_merkle_path
    from zkfl_tpu_torch.commit.vector_hash import sample_hash, vector_hash_many
    from zkfl_tpu_torch.ops.limb_kernels import FRK
    from zkfl_tpu_torch.ops.poseidon import PoseidonKernel

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    n = 1 << COMMIT_DEPTH
    vals, limbs = dataset(gen, n, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    backend.LAUNCHES.clear()
    with K5Tap(SEED + 6) as tap:
        t0 = time.time()
        (root, levels), wall_ms = once_ms(lambda: commit(limbs, COMMIT_DEPTH))
        wall = time.time() - t0
    launches = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  {n} samples x {PROD_DIM + 1} values, depth {COMMIT_DEPTH}: commitment in {wall:.4f} s "
        f"({wall_ms:.3f} ms between CUDA events); peak device memory {peak / 2**30:.3f} GiB "
        f"({(peak - base_mem) / 2**30:.3f} GiB above the inputs)")
    log(f"  launches {launches}")
    if launches.get("fr.poseidon", 0) == 0 or len(tap.launches) != launches["fr.poseidon"]:
        raise AssertionError(f"fr.poseidon launches {launches.get('fr.poseidon')}, "
                             f"{len(tap.launches)} tapped")

    # Each group of the commitment's K5 launches: card time by the events
    # around them in the run above, bound at their shapes, and the tapped
    # states held exactly against the plain version on the same inputs.
    groups = {}
    for t, states, start, end, x, y in tap.launches:
        key = f"t={t} {'leaves' if states == n else 'tree'}"
        g = groups.setdefault(key, {"t": t, "launches": 0, "states": 0, "ms": 0.0, "bound_ms": 0.0,
                                    "x": [], "y": []})
        g["launches"] += 1
        g["states"] += states
        g["ms"] += start.elapsed_time(end)
        g["bound_ms"] += bound(f"fr.poseidon t={t}", states, sm_mhz)[0]
        g["x"].append(x)
        g["y"].append(y)
    parts, err = [], 0
    for key, g in groups.items():
        kern = PoseidonKernel(g["t"])
        x, y = torch.cat(g.pop("x"), dim=1), torch.cat(g.pop("y"), dim=1)
        plain, plain_ms = once_ms(lambda: kern.permute_plain(x))
        e = max_abs_err(y, plain)
        if e != 0:
            raise AssertionError(f"fr.poseidon {key}: the commitment's K5 output disagrees with "
                                 f"permute_plain on {x.shape[1]} of its states (max |diff| {e})")
        err = max(err, e)
        g.update(check_states=x.shape[1], plain_ms=plain_ms,
                 check_ms=kernel_ms(kern.permute, [(x,)], 3))
        parts.append({"group": key, **g})
        log(f"  K5 {key:10s} {g['launches']:2d} launches, {g['states']:8d} states: card {g['ms']:9.3f} ms, "
            f"bound {g['bound_ms']:8.3f} ms ({g['bound_ms'] / g['ms']:.4f} of it); {x.shape[1]} tapped "
            f"states equal permute_plain (kernel {g['check_ms']:.3f} ms, plain {plain_ms:.1f} ms)")
    busy = sum(g["ms"] for g in parts)
    bound_ms = sum(g["bound_ms"] for g in parts)
    log(f"  K5 busy {busy:.3f} ms of the commitment's {wall_ms:.3f} ms between events "
        f"(share outside K5 {1 - busy / wall_ms:.4f}); integer bound {bound_ms:.3f} ms: K5 runs at "
        f"{bound_ms / busy:.4f} of the derived integer peak")
    k5_row = {"max_abs_err": err, "ms": busy, "plain_ms": sum(g["plain_ms"] for g in parts),
           "bound_ms": bound_ms, "bound_by": "operations", "parts": parts}

    # 32 seeded leaves: device leaf == host sample_hash, device path verifies.
    pick = torch.randint(0, n, (32,), device=dev, generator=gen)
    idx = pick.tolist()
    rows = vals[pick].tolist()
    leaves = FRK.from_mont(levels[0][:, pick])
    sib_idx = torch.stack([(pick >> lvl) ^ 1 for lvl in range(COMMIT_DEPTH)])       # [20, 32]
    sibs = torch.stack([FRK.from_mont(levels[lvl][:, sib_idx[lvl]]) for lvl in range(COMMIT_DEPTH)],
                       dim=1)                                                      # [8, 20, 32]
    leaves = FRK.unpack(leaves, mont=False)
    sibs = FRK.unpack(sibs.reshape(8, -1), mont=False)
    root_int = FRK.unpack(FRK.from_mont(root[:, None]), mont=False)[0]
    for k, (i, row) in enumerate(zip(idx, rows)):
        if sample_hash(row[:PROD_DIM], row[PROD_DIM]) != leaves[k]:
            raise AssertionError(f"leaf {i}: device VectorHash != host sample_hash")
        path = [(i >> lvl) & 1 for lvl in range(COMMIT_DEPTH)]
        siblings = [sibs[lvl * 32 + k] for lvl in range(COMMIT_DEPTH)]
        if not verify_merkle_path(leaves[k], siblings, path, root_int):
            raise AssertionError(f"leaf {i}: device Merkle path does not verify to the device root")
    log(f"  32 seeded leaves equal the host sample_hash; their device paths verify; root {root_int}")

    # Depth 12: the device root against the native host tree.
    if not native.available():
        raise RuntimeError("the native host library (csrc/host/zkfl_host.cpp) did not build")
    vals12, limbs12 = dataset(gen, 1 << CHECK_DEPTH, dev)
    root12, levels12 = commit(limbs12, CHECK_DEPTH)
    host_leaves = vector_hash_many(vals12.tolist())
    if FRK.unpack(FRK.from_mont(levels12[0]), mont=False) != host_leaves:
        raise AssertionError("depth 12: device leaves != native host leaves")
    host_root = MerkleTree(host_leaves, CHECK_DEPTH).root
    if FRK.unpack(FRK.from_mont(root12[:, None]), mont=False)[0] != host_root:
        raise AssertionError("depth 12: device root != native host MerkleTree root")
    log(f"  depth {CHECK_DEPTH}: {1 << CHECK_DEPTH} device leaves and the root equal the native host tree's")
    return launches, k5_row


# kernel op -> (source, the TPU kernel it replaces)
KERNELS = {
    "fr.to_mont": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:374"),
    "fr.mont_mul": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:357"),
    "fr.mont_sqr": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:360"),
    "fr.mont_mul_const": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:571"),
    "fr.mul_sub_mul_const": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:396"),
    "fr.from_mont": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:370"),
    "fr.butterfly": ("ntt_butterfly.cu", "zkfl_tpu/ops/limb_kernels.py:380"),
    "fr.normalize_raw": ("normalize_raw.cu", "zkfl_tpu/ops/limb_kernels.py:387"),
    "fr.poseidon": ("poseidon.cu", "zkfl_tpu/ops/poseidon_pallas.py:85"),
    "fq.to_mont": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:374"),
    "fq.mont_mul": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:357"),
    "fq.mont_sqr": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:360"),
    "fq.add": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:364"),
    "fq.sub": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:367"),
    "g1.padd": ("g1_point.cu", "zkfl_tpu/ops/point_kernels.py:68"),
    "g1.pdbl": ("g1_point.cu", "zkfl_tpu/ops/point_kernels.py:101"),
}
# No path of either package squares a field element, so these two report the
# launches of their check in phase 3.
CHECK_ONLY = ("fr.mont_sqr", "fq.mont_sqr")


def report_row(name, rows, launches):
    """One op of the kernels line.  fr.poseidon's row is phase 6's: card
    time and bound summed over the commitment's launches, plain time over
    the tapped states, each group of launches under "parts"."""
    row = rows[name]
    src, tpu = KERNELS[name]
    out = {"name": name, "route": "cuda", "source": f"zkfl_tpu_torch/csrc/{src}", "replaces": tpu,
           "launches": launches[name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
           "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
           "library_ms": None}
    if "parts" in row:
        out["parts"] = row["parts"]
    return out


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
    sm_mhz = backend.max_sm_clock_mhz()
    if sm_mhz is None:
        raise RuntimeError("nvidia-smi did not report the SM clock")
    log(f"  {json.dumps(info)}; max SM clock {sm_mhz:.0f} MHz: derived integer peak "
        f"{SMS * INT32_LANES * sm_mhz * 1e6 / 1e12:.2f} T multiply-adds/s")

    log("[2] build")
    t0 = time.time()
    lib_path = backend.build()
    backend.lib()
    log(f"  {lib_path} in {time.time() - t0:.1f} s")
    entry, spills, nvcc_s = None, "", {}
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if line.startswith("# nvcc "):
            what, secs = line[len("# nvcc "):].split(": ")
            nvcc_s[what] = float(secs.split()[0])
        elif "Compiling entry function" in line:
            mangled = line.split("'")[1]
            entry = next((k for k in ("field_ew", "butterfly", "normalize_raw", "g1_padd", "g1_pdbl",
                                      "poseidon") if f"{k}_kernel" in mangled), mangled)
            m = re.search(r"IN2zk2(F[rq])ELi(\d)E", mangled)
            entry += f"<{m.group(1)}, op {m.group(2)}>" if m else ""
            m = re.search(r"poseidon_kernelILi(\d+)E", mangled)
            entry += f"<t={m.group(1)}>" if m else ""
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used")[1].split(",")[0].strip()
            log(f"  ptxas {entry}: {regs}; {spills}")
    log(f"  nvcc wall time per process: {nvcc_s}; the sources' compiles add up to "
        f"{sum(v for k, v in nvcc_s.items() if k != 'link'):.1f} s")

    log("[3] kernels vs plain versions")
    t0 = time.time()
    rows = phase_kernels(dev, backend, sm_mhz)
    log(f"  phase 3 in {time.time() - t0:.1f} s")

    log("[4] MICRO_CONFIG balance proof parity")
    t0 = time.time()
    phase_micro_parity(dev, artifacts)
    log(f"  phase 4 in {time.time() - t0:.1f} s")

    log("[5] REFERENCE_CONFIG round")
    t0 = time.time()
    round_launches = phase_round(dev, artifacts, backend)
    log(f"  phase 5 in {time.time() - t0:.1f} s")
    for name in sorted(round_launches):
        log(f"  launches {name:24s} {round_launches[name]}")

    log("[6] dataset commitment on the card")
    t0 = time.time()
    commit_launches, rows["fr.poseidon"] = phase_commitment(dev, backend, sm_mhz)
    log(f"  phase 6 in {time.time() - t0:.1f} s")

    launches = {name: round_launches.get(name, 0) + commit_launches.get(name, 0) for name in KERNELS}
    for name in CHECK_ONLY:
        launches[name] = rows[name]["check_launches"]
    missing = [name for name in KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")

    report = [report_row(name, rows, launches) for name in KERNELS]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
