#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zkfl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and this checkout; imports nothing of JAX and
nothing of zkfl_tpu.  Phases (any failure raises and exits non-zero):
  1. probe: card name, power limit and SM clock, CUDA / nvcc / Triton versions;
  2. build the six CUDA kernels (K1-K6) from zkfl_tpu_torch/csrc; ptxas's
     registers and spills per entry, SASS instructions per field product of
     K1, K4, K5 and K6 and per lane of K3 (cuobjdump);
  3. every kernel op against its plain torch version on the same random
     canonical inputs (exact equality): the field ops at 2^18 lanes, the G1
     ops at 2^17, the G2 ops at 3 x 2^14 (the G2 MSM's widest launch), both
     doublings also 8 at a time, with identity, P + P, P + (-P) and
     projective representatives whose coordinates have the limbs of p - 1
     checked against the host curve too, normalize_raw also on column sums
     whose value is k p and k p - 1 up to the largest k, the Poseidon
     permutation at every width t = 2..17 (2^12 states at t = 2, 3, 6, 17,
     2^8 at the others);
     the card time of each (over input sets larger than the L2) and the
     wall time per call;
  4. MICRO_CONFIG balance setup on the card (the fixed-base batches of
     groth16/device_setup.py: a table gather and five levels of K4 / K6
     padd) == the pure-Python ladder's keys, every affine point of pk and
     vk; its proof on TorchEngine == HostEngine's, bit for bit, under
     deterministic blinding;
  5. one REFERENCE_CONFIG FL round through the port's RoundProver and
     run_round: cold setups on the card (their time, host/card split),
     3 clients batched, 9 proofs verified by the native
     verifier, masks cancel; every kernel of the path launched, and no
     fq.add / fq.sub / fq.mont_mul; each G1 and G2 MSM's wall time, and the
     card time of its point kernels, its launches replayed at their shapes;
     the widest launch of each kernel, the setups' folds apart, held
     against its plain version on 2^12 seeded lanes;
  6. a client's dataset commitment on the card: 2^20 samples of 16 features
     and a label, VectorHash per sample and a depth-20 Poseidon Merkle tree;
     each K5 launch of it timed by CUDA events in that run, and 2^12 of its
     states (a seeded slice of every launch) equal permute_plain's;
     32 seeded leaves equal the host hash and their device paths verify to
     the device root; at depth 12 the root equals the native host tree's;
  7. the production run, fl/prod.py on the card: the balance proof at
     N=128, DIM=16, DEPTH=7 (357,764 constraints, a 2^19 domain) and the
     sgd_step_v5 proof (25,858 constraints), run twice.  First
     instrumented: where build/zkfl_prod_artifacts is empty, it builds
     both structures in Python and sets them up on the card (the host/card
     split printed); the time split of each step, each MSM's wall and its
     point kernels' card time, and the widest launch of each kernel (the
     setups' folds apart) held against its plain version on 2^12 seeded
     lanes.  Then untapped, from those caches, as a user runs it: every
     timing of its result and peak card memory.  Both runs' proofs verify
     natively and bind the same root_D;
  8. formats and sharding, from what phases 5 and 7 left in memory and on
     disk: write_ptau on the card at power 14, read back and held against
     the host curve and the native pairing; REFERENCE_CONFIG's balance key
     through write_zkey / read_zkey, proved with the reloaded key; the
     committed snarkjs-layout zkey (tests/data, odd H basis) proved on the
     card; phase 7's proofs and vkeys through snarkjs JSON; the client batch
     over a 3-shard "clients" mesh against the unsharded batch, then a round
     with that mesh; msm_g1_sharded over 4 shards against pippenger_g1 and
     msm_g1_host (2^16 points of the production balance key); the TP
     prover over 4 shards on the production balance proof (2^19 domain)
     against the unsharded pipeline, bit for bit, and its proof verified.
     The shards are virtual: 3 or 4 shards on the one card, run one after
     another.  LaunchCheck holds each kernel's widest launch;
  9. the port's measuring entry points, called as functions in this
     process: (a) zkfl_tpu_torch.bench's measurements on phase 5's
     RoundProver (headline, round, kernel rates; every extra present and
     positive, the three rate MSMs equal to their repeated-base sums on the
     host curve, a slice of its last K5 launch equal to permute_plain); (b)
     scripts/round8.py's 8-client batched round (masks cancel); (c)
     scripts/scaling.py's points N=8 and N=16 with cold setups on the card.
     Every proof verifies; LaunchCheck holds each kernel's widest launch.
fr.poseidon's row in the kernel report is phase 6's launches; each row's
"paths" splits its launches by phase (setup: the cold setups of phases 5
and 7; prod: phase 7's untapped run; parallel: phase 8; bench, round8 and
scaling: phase 9, their counts set to 0 before each).
The last two lines are the kernel report and the device line, both JSON.
"""

import collections
import json
import os
import sys
import time

from zkfl_tpu_torch.costs import bound, int32_peak

REPO = os.path.dirname(os.path.abspath(__file__))
FIELD_LANES = 1 << 18    # main-path lane counts: matrix terms, NTT stages
POINT_LANES = 1 << 17    # the G1 MSM's serial-scan launches are ~2^17.6 lanes
G2_LANES = 3 << 14       # the G2 MSM's serial-scan launches: 3 clients x 32 windows x 512
LADDER_LANES = {"g1": 12, "g2": 3}  # the Horner ladder's accumulators: 3 clients x 4 / x 1
WBITS = 8                # doublings per window of the ladder
POSEIDON_LANES = 1 << 12
POSEIDON_WIDE_CHECK = (2, 3, 6, 17)  # checked on POSEIDON_LANES states, the other widths on 2^8
COMMIT_DEPTH = 20        # 2^20 samples: a realistic client's dataset
CHECK_DEPTH = 12         # the depth whose root the native host tree checks
PROD_DIM = 16            # features per sample (zkfl_tpu/fl/prod.py:37-40)
SEED = 20261016

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


def extreme_value() -> int:
    """The standard-form Fq value whose Montgomery representative is p - 1."""
    from zkfl_tpu_torch.field.bn254 import FQ
    from zkfl_tpu_torch.ops.limb_kernels import FQK

    return (-pow(FQK.mont_r, -1, FQ)) % FQ


def g1_extreme(pt, coord):
    """Standard-form (X, Y, Z) of affine G1 ``pt``, scaled so that coordinate
    ``coord`` has the Montgomery representative p - 1."""
    from zkfl_tpu_torch.field.bn254 import FQ

    xyz = (pt[0], pt[1], 1)
    lam = extreme_value() * pow(xyz[coord], -1, FQ) % FQ
    return tuple(v * lam % FQ for v in xyz)


def g2_extreme(pt, coord, comp):
    """Standard-form ((x0, x1), (y0, y1), (z0, z1)) of affine G2 ``pt``
    scaled by lambda in Fq2 (mu, or mu u where that coefficient is 0) so
    that coefficient ``comp`` of coordinate ``coord`` has the representative
    p - 1."""
    from zkfl_tpu_torch.field.bn254 import FQ

    xyz = (tuple(pt[0].coeffs), tuple(pt[1].coeffs), (1, 0))
    c = xyz[coord]
    uc = c if c[comp] else ((-c[1]) % FQ, c[0])  # u c = -c1 + c0 u
    mu = extreme_value() * pow(uc[comp], -1, FQ) % FQ
    lam = (mu, 0) if c[comp] else (0, mu)
    return tuple(((lam[0] * v[0] - lam[1] * v[1]) % FQ, (lam[0] * v[1] + lam[1] * v[0]) % FQ)
                 for v in xyz)


T_MAX = sum((2**63 - 1) << (32 * j) for j in range(8))  # the largest value of 8 int64 column sums


def carried_cols(t):
    """Eight column sums in [0, 2^63) whose carried value sum_j c_j 2^(32 j)
    is t, for 0 <= t <= T_MAX: t's words directly below 2^256, else T_MAX's
    columns less the words of T_MAX - t."""
    if t < 2**256:
        return [(t >> (32 * j)) & 0xFFFFFFFF for j in range(7)] + [t >> 224]
    d = T_MAX - t
    return [2**63 - 1 - ((d >> (32 * j)) & 0xFFFFFFFF) for j in range(7)] + [2**63 - 1 - (d >> 224)]


def normalize_edge_cols(p):
    """int64 [8, m] column sums whose carried values are k p and k p - 1 for
    k from 1 to the largest the columns can carry: normalize_raw's results
    0 and p - 1 at the edges of its quotient estimate."""
    import numpy as np

    ks = (1, 2, 5, 6, 2**31, T_MAX // p - 1, T_MAX // p)
    return np.array([carried_cols(t) for k in ks for t in (k * p, k * p - 1)], dtype=np.int64).T


def g1_limbs(projs, fq):
    """Standard-form projective G1 points -> int32 [3, 8, n] Montgomery."""
    import numpy as np

    return np.stack([fq.pack([pr[i] for pr in projs]) for i in range(3)])


def g2_limbs(projs, fq):
    """Standard-form projective G2 points -> int32 [3, 2, 8, n] Montgomery."""
    import numpy as np

    return np.stack([np.stack([fq.pack([pr[i][j] for pr in projs]) for j in range(2)])
                     for i in range(3)])


def g2_key(pts):
    return [None if q is None else tuple(tuple(c.coeffs) for c in q) for q in pts]


def edge_lanes(P, Q, inf, fq):
    """P + O, O + Q, P + P, P + (-P), O + O in lanes 0-4 of a point check."""
    import torch

    P[..., 0], Q[..., 1] = inf, inf            # P + O, O + Q
    Q[..., 2] = P[..., 2]                      # P + P
    Q[..., 3] = P[..., 3]                      # P + (-P): negate Y
    y = P[1, ..., 3:4].movedim(-2, 0)         # limbs first: [8, (2,) 1]
    Q[1, ..., 3] = fq.sub_plain(torch.zeros_like(y), y).movedim(0, -2)[..., 0]
    P[..., 4], Q[..., 4] = inf, inf            # O + O


def ladder(rows, group, pdbl, P):
    """Card time of one launch of the Horner ladder's doubling: WBITS
    doublings of the group's accumulators (LADDER_LANES), into the row of
    its doubling op."""
    x = P[..., : LADDER_LANES[group]].contiguous()
    row = rows[f"{group}.pdbl"]
    row["ladder_lanes"] = LADDER_LANES[group]
    row["ladder_ms"] = kernel_ms(lambda a: pdbl(a, WBITS), [(x,)], 16)
    log(f"  {group}.pdbl times={WBITS} at the ladder's {LADDER_LANES[group]} lanes: "
        f"card ms {row['ladder_ms']:.4f}")


def point_checks(check, rows, dev, gen, group):
    """Phase 3's point ops of one group ("g1" at POINT_LANES, "g2" at
    G2_LANES), each against its plain version: add, double, WBITS doublings
    in one launch.  The first input set holds random projective points
    (sums of two affine points, Z != 1), the edge lanes 0-4 and then
    representatives whose coordinates (G2: each coefficient) have the limbs
    of p - 1, first in P, then in Q; those lanes go to the host curve
    oracle too.  The timing's other sets are random affine points."""
    import torch

    from zkfl_tpu_torch.field import curve
    from zkfl_tpu_torch.ops import point_kernels as pk
    from zkfl_tpu_torch.ops.limb_kernels import FQK

    if group == "g1":
        lanes, mul, add, key = POINT_LANES, curve.g1_mul, curve.g1_add, list
        base = [mul(curve.G1_GEN, 1000003 * i + 7) for i in range(64)]
        to_dev, from_dev, inf = pk.g1_to_device, pk.g1_from_device, pk.inf_point
        padd, padd_plain, pdbl, pdbl_plain = pk.padd, pk.padd_plain, pk.pdbl, pk.pdbl_plain
        ext = g1_limbs([g1_extreme(base[k], k % 3) for k in range(6)], FQK)
    else:
        lanes, mul, add, key = G2_LANES, curve.g2_mul_jac, curve.g2_add, g2_key
        base = [mul(curve.g2_generator(), 1000003 * i + 7) for i in range(64)]
        to_dev, from_dev, inf = pk.g2_to_device, pk.g2_from_device, pk.inf_point_g2
        padd, padd_plain = pk.padd_g2, pk.padd_g2_plain
        pdbl, pdbl_plain = pk.pdbl_g2, pk.pdbl_g2_plain
        ext = g2_limbs([g2_extreme(base[k], k // 2 % 3, k % 2) for k in range(12)], FQK)
    bdev = to_dev(base, dev)
    idx = torch.randint(0, 64, (4, lanes), device=dev, generator=gen)
    P = padd_plain(bdev[..., idx[0]], bdev[..., idx[1]])
    Q = padd_plain(bdev[..., idx[2]], bdev[..., idx[3]])
    edge_lanes(P, Q, inf((1,), dev)[..., 0], FQK)
    k = ext.shape[-1] // 2
    P[..., 5:5 + k] = torch.from_numpy(ext[..., :k]).to(dev)
    Q[..., 5 + k:5 + 2 * k] = torch.from_numpy(ext[..., k:]).to(dev)
    pairs = [(P, Q)] + [
        tuple(bdev[..., torch.randint(0, 64, (lanes,), device=dev, generator=gen)]
              for _ in range(2))
        for _ in range(ROTATE - 1)]
    singles = [(x,) for x, _ in pairs]
    n_host = 5 + 2 * k
    host_p = [from_dev(P[..., i]) for i in range(n_host)]
    host_q = [from_dev(Q[..., i]) for i in range(n_host)]

    def run(name, kernel_fn, plain_fn, sets, reps, want):
        out = check(name, kernel_fn, plain_fn, sets, lanes, reps=reps)
        if key([from_dev(out[..., i]) for i in range(n_host)]) != key(want):
            raise AssertionError(f"{name}: edge lanes disagree with the host curve oracle")

    run(f"{group}.padd", padd, padd_plain, pairs, 16, [add(x, y) for x, y in zip(host_p, host_q)])
    run(f"{group}.pdbl", pdbl, pdbl_plain, singles, 16, [add(x, x) for x in host_p])
    run(f"{group}.pdbl times={WBITS}", lambda x: pdbl(x, WBITS), lambda x: pdbl_plain(x, WBITS),
        singles, 8, [mul(x, 1 << WBITS) if x else None for x in host_p])
    ladder(rows, group, pdbl, P)


def phase_kernels(dev, backend, sm_mhz):
    """Phase 3: each kernel op vs its plain version; returns report rows."""
    import torch

    from zkfl_tpu_torch.field.limbs import ints_to_limbs
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
        b_ms, b_by = bound(name, lanes, sm_mhz)
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
            edge = torch.from_numpy(normalize_edge_cols(F.p)).to(dev)
            for _ in range(ROTATE):
                cols = torch.randint(0, 2**40, (8, n), dtype=torch.int64, device=dev, generator=gen)
                cols[:, 0] = 2**63 - 1
                cols[:, 1] = 0
                cols[:, 2:2 + edge.shape[1]] = edge  # T = k p, k p - 1
                col_sets.append((cols,))
            check("fr.normalize_raw", F.normalize_raw, F.normalize_raw_plain, col_sets, n)
        del sets

    # Poseidon at every width: random states, then the all-0, all-1 and
    # all-(p-1) states.
    special = torch.from_numpy(ints_to_limbs([0, 1, FRK.p - 1])).to(dev)
    for t in range(2, 18):
        lanes = POSEIDON_LANES if t in POSEIDON_WIDE_CHECK else 1 << 8
        s = rand_elems(gen, lanes * t, dev, FRK.p).reshape(8, lanes, t)
        s[:, :3, :] = special[:, :, None]
        kern = PoseidonKernel(t)
        check(f"fr.poseidon t={t}", kern.permute, kern.permute_plain, [(s,)], lanes, reps=5)

    for group in ("g1", "g2"):
        point_checks(check, rows, dev, gen, group)
    return rows


def key_ints(obj):
    """A proving or verifying key as nested tuples of ints (G2 coordinates
    by their Fq2 coefficients)."""
    import dataclasses

    if dataclasses.is_dataclass(obj):
        return tuple((f.name, key_ints(getattr(obj, f.name))) for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return tuple(key_ints(v) for v in obj)
    return tuple(obj.coeffs) if hasattr(obj, "coeffs") else obj


class SetupTap:
    """While active, wraps device_setup._fixed_mul (one chunk of a
    fixed-base batch: the table gather and the five padd levels of
    _fold_sum): the card synchronised before and after each call, its host
    wall time, CUDA events around it, its group, scalar count and launches."""

    def __init__(self, backend):
        from zkfl_tpu_torch.groth16 import device_setup
        from zkfl_tpu_torch.ops import msm

        self.backend, self.mod, self.msm = backend, device_setup, msm
        self.calls = []                        # (group, scalars, wall ms, card ms, launches)

    def __enter__(self):
        import torch

        impl = self.impl = self.mod._fixed_mul

        def tapped(table, idx, ops):
            torch.cuda.synchronize()
            before = collections.Counter(self.backend.LAUNCHES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = impl(table, idx, ops)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            made = collections.Counter(self.backend.LAUNCHES) - before
            group = "g2" if ops is self.msm._G2Ops else "g1"
            self.calls.append((group, idx.shape[1], wall, start.elapsed_time(end), dict(made)))
            return out

        self.mod._fixed_mul = tapped
        return self

    def __exit__(self, *exc):
        self.mod._fixed_mul = self.impl

    def report(self, total_s: float) -> str:
        """The split of ``total_s`` seconds of setups: the fixed-base chunks'
        wall (card synchronised around each) and card time, the rest on the
        host."""
        parts = []
        for group in ("g1", "g2"):
            calls = [c for c in self.calls if c[0] == group]
            made = collections.Counter()
            for c in calls:
                made.update(c[4])
            parts.append(f"{group}: {len(calls)} chunks, {sum(c[1] for c in calls)} scalars, "
                         f"wall {sum(c[2] for c in calls):.1f} ms, card {sum(c[3] for c in calls):.1f} ms, "
                         f"launches {dict(made)}")
        card_wall = sum(c[2] for c in self.calls) / 1e3
        return (f"{total_s:.3f} s of setups: {card_wall:.3f} s in the fixed-base chunks on the card, "
                f"{total_s - card_wall:.3f} s on the host; " + "; ".join(parts))


class WallTap:
    """While active, wraps the given functions ((owner, attribute) pairs: a
    module's function, a class's method or static method): the card
    synchronised before and after each call, the host wall time summed per
    function, nested tapped calls included in their callers' time."""

    def __init__(self, targets):
        self.targets = targets
        self.ms, self.calls = collections.Counter(), collections.Counter()

    def __enter__(self):
        import torch

        sync = torch.cuda.synchronize
        self.saved = []
        for owner, attr in self.targets:
            raw = owner.__dict__[attr]
            fn = getattr(owner, attr)
            label = f"{getattr(owner, '__name__', '?').rsplit('.', 1)[-1]}.{attr}"

            def tapped(*args, _fn=fn, _label=label, **kwargs):
                sync()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                sync()
                self.ms[_label] += (time.perf_counter() - t0) * 1e3
                self.calls[_label] += 1
                return out

            self.saved.append((owner, attr, raw))
            setattr(owner, attr, staticmethod(tapped) if isinstance(raw, staticmethod) else tapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, raw in reversed(self.saved):
            setattr(owner, attr, raw)

    def report(self, what: str) -> None:
        for label, ms in self.ms.items():
            log(f"  {what} split {label:36s} {self.calls[label]:5d} calls {ms:11.1f} ms")


class Record:
    """While active, wraps the function ``owner.attr`` and keeps the
    positional arguments of every call (no synchronisation, no timing)."""

    def __init__(self, owner, attr):
        self.owner, self.attr, self.calls = owner, attr, []

    def __enter__(self):
        raw = self.raw = getattr(self.owner, self.attr)

        def recorded(*args, **kwargs):
            self.calls.append(args)
            return raw(*args, **kwargs)

        setattr(self.owner, self.attr, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.raw)


CHECK_LANES = 1 << 12    # lanes of a tapped launch held against the plain version


def lane_slice(x, lead: int, flat):
    """The lanes ``flat`` (indices into x's batch dims, flattened as the
    wrappers flatten them) of x [*lead, *B]: a copy, [*lead, len(flat)]."""
    idx, rem = [], flat
    for size in reversed(x.shape[lead:]):
        idx.append(rem % size)
        rem = rem // size
    return x[(slice(None),) * lead + tuple(reversed(idx))]


class LaunchCheck:
    """While active, wraps the kernel wrappers of the setup and prove paths
    (TorchField._ew, which launches every K1 op, TorchField.butterfly and
    normalize_raw; the G1 and G2 padd and pdbl of ops/msm.py) and keeps,
    for each op and context ("fold" inside a setup's fixed-base chunk,
    "path" elsewhere), its widest launch on the card: CHECK_LANES
    consecutive lanes (all, where there are fewer) of its inputs from a
    seeded offset, and the same lanes of its output.  Copies are made only
    for a launch wider than the widest so far.  ``verify`` holds each
    against the op's plain version on those inputs, exactly."""

    def __init__(self, seed):
        import random

        self.rng = random.Random(seed)
        self.widest = {}                       # (op, context) -> (lanes, plain, inputs, outputs)
        self.context = "path"

    def keep(self, name, lead, tensors, call, plain):
        """call() (the wrapper), keeping its lanes if it is the widest
        launch of ``name`` in this context so far."""
        import torch

        lanes = 1
        for size in tensors[0].shape[lead:]:
            lanes *= size
        key = (name, self.context)
        if not tensors[0].is_cuda or lanes <= self.widest.get(key, (0,))[0]:
            return call()
        k = min(lanes, CHECK_LANES)
        off = self.rng.randrange(lanes - k + 1)
        flat = torch.arange(off, off + k, device=tensors[0].device)
        xs = [lane_slice(t, lead, flat) for t in tensors]
        out = call()
        ys = tuple(lane_slice(o, lead, flat) for o in (out if isinstance(out, tuple) else (out,)))
        self.widest[key] = (lanes, plain, xs, ys)
        return out

    def __enter__(self):
        from zkfl_tpu_torch.groth16 import device_setup
        from zkfl_tpu_torch.ops import msm
        from zkfl_tpu_torch.ops import point_kernels as pk
        from zkfl_tpu_torch.ops.limb_kernels import TorchField

        ew, bfly, norm = TorchField._ew, TorchField.butterfly, TorchField.normalize_raw
        fixed_mul, keep = device_setup._fixed_mul, self.keep

        def tapped_ew(F, op, a, b=None, c=None, k=None):
            consts = [] if k is None else [k]
            return keep(f"{F.name}.{op}", 1, [t for t in (a, b, c) if t is not None],
                        lambda: ew(F, op, a, b, c, k),
                        lambda *xs: getattr(F, f"{op}_plain")(*xs, *consts))

        def tapped_fixed_mul(table, idx, ops):
            self.context = "fold"
            try:
                return fixed_mul(table, idx, ops)
            finally:
                self.context = "path"

        def point(name, lead, fn, plain):
            if name.endswith("padd"):
                return lambda p, q: keep(name, lead, [p, q], lambda: fn(p, q), plain)
            return lambda p, times=1: keep(name, lead, [p], lambda: fn(p, times),
                                           lambda x: plain(x, times))

        self.saved = [(TorchField, "_ew", ew), (TorchField, "butterfly", bfly),
                      (TorchField, "normalize_raw", norm), (device_setup, "_fixed_mul", fixed_mul)]
        TorchField._ew = tapped_ew
        TorchField.butterfly = lambda F, u, v, tw: keep(
            "fr.butterfly", 1, [u, v, tw], lambda: bfly(F, u, v, tw), F.butterfly_plain)
        TorchField.normalize_raw = lambda F, cols: keep(
            "fr.normalize_raw", 1, [cols], lambda: norm(F, cols), F.normalize_raw_plain)
        device_setup._fixed_mul = tapped_fixed_mul
        for ops, group, lead, plains in ((msm._G1Ops, "g1", 2, (pk.padd_plain, pk.pdbl_plain)),
                                          (msm._G2Ops, "g2", 3, (pk.padd_g2_plain, pk.pdbl_g2_plain))):
            for op, plain in zip(("padd", "pdbl"), plains):
                self.saved.append((ops, op, ops.__dict__[op]))
                setattr(ops, op, staticmethod(point(f"{group}.{op}", lead, getattr(ops, op), plain)))
        return self

    def __exit__(self, *exc):
        for owner, attr, raw in reversed(self.saved):
            setattr(owner, attr, raw)

    def verify(self, what: str) -> None:
        """Hold every kept launch against its plain version."""
        for (name, ctx), (lanes, plain, xs, ys) in sorted(self.widest.items()):
            want = plain(*xs)
            err = max_abs_err(ys, want if isinstance(want, tuple) else (want,))
            if err != 0:
                raise AssertionError(f"{what}: {name}'s widest {ctx} launch ({lanes} lanes) disagrees "
                                     f"with its plain version on {xs[0].shape[-1]} lanes (max |diff| {err})")
            log(f"  {what} {name:22s} widest {ctx} launch {lanes:9d} lanes: {xs[0].shape[-1]} "
                f"seeded lanes equal the plain version")


def setup_targets():
    """The functions of a cold setup, for WallTap: the setup and its cache
    write (setup_cached less groth16_setup is the pickle), the wire
    evaluations, each fixed-base batch and its host parts (digits, unpack,
    G1's batched affine conversion; G2's per-point inversions are the rest
    of batch_fixed_mul_g2)."""
    from zkfl_tpu_torch.groth16 import device_setup, setup
    from zkfl_tpu_torch.ops import limb_kernels

    return [(setup, "setup_cached"), (setup, "groth16_setup"), (setup, "wire_evals"),
            (setup, "lagrange_evals_at"), (device_setup, "batch_fixed_mul_g1"),
            (device_setup, "batch_fixed_mul_g2"), (device_setup, "_digit_indices"),
            (device_setup, "_batch_affine"), (limb_kernels.TorchField, "unpack")]


def prove_targets():
    """The functions of a fused prove, for WallTap: the key upload and COO
    stream (DeviceProver.__init__), the NTT tables, the witness packing, the
    card pipeline, the results' download, the blinding and the assembly."""
    from zkfl_tpu_torch.groth16 import device_prover, prover
    from zkfl_tpu_torch.ops import point_kernels, qap

    return [(device_prover.DeviceProver, "__init__"), (point_kernels, "g1_to_device"),
            (point_kernels, "g2_to_device"), (qap, "_bitrev_idx"), (qap, "_stage_twiddles"),
            (qap, "_coset_powers"), (device_prover.DeviceProver, "pack_witnesses"),
            (device_prover, "_prove_msms_impl"), (device_prover.DeviceProver, "results_from_device"),
            (prover, "default_blinding"), (prover, "_assemble_proof")]


def phase_micro_parity(dev, artifacts, backend):
    """Phase 4: MICRO_CONFIG balance setup, card vs the pure-Python ladder;
    its proof, TorchEngine vs HostEngine."""
    from zkfl_tpu_torch.fl.client import Client, SharedLCG
    from zkfl_tpu_torch.fl.config import MICRO_CONFIG
    from zkfl_tpu_torch.groth16.engine import HostEngine, TorchEngine
    from zkfl_tpu_torch.groth16.prover import groth16_prove
    from zkfl_tpu_torch.groth16.setup import cache_path, groth16_setup, setup_cached
    from zkfl_tpu_torch.groth16.verifier import groth16_verify
    from zkfl_tpu_torch.r1cs.circuits import build_structure

    cs = build_structure(MICRO_CONFIG.balance_params)
    backend.LAUNCHES.clear()
    with SetupTap(backend) as tap:
        t0 = time.time()
        card_keys = groth16_setup(cs, device=dev)
        card_s = time.time() - t0
    launches = dict(backend.LAUNCHES)
    t0 = time.time()
    ladder_keys = groth16_setup(cs, device=None)
    ladder_s = time.time() - t0
    if key_ints(card_keys) != key_ints(ladder_keys):
        raise AssertionError("MICRO balance setup: the card's keys != the pure-Python ladder's")
    if not launches.get("g1.padd") or not launches.get("g2.padd"):
        raise AssertionError(f"the card setup launched no g1.padd or g2.padd: {launches}")
    pk, vk = card_keys
    n_points = sum(len(q) for q in (pk.a_query, pk.b1_query, pk.b2_query, pk.c_query,
                                    pk.h_query, vk.ic)) + 8
    log(f"  {cs.name} setup: card {card_s:.2f} s (tables built and uploaded on first use), "
        f"ladder {ladder_s:.2f} s; all {n_points} affine points of pk and vk equal; "
        f"launches {launches}; {tap.report(card_s)}")
    # One cache file for either device: its name holds no device.
    path = cache_path(cs, artifacts)
    if key_ints(setup_cached(cs, artifacts, device=dev)) != key_ints(ladder_keys) or not path.exists():
        raise AssertionError(f"setup cache {path} does not hold the ladder's keys")

    saved = os.environ.get("ZKFL_DETERMINISTIC_BLINDING")
    os.environ["ZKFL_DETERMINISTIC_BLINDING"] = "1"
    try:
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


POINT_ENTRIES = ("zk_g1_padd", "zk_g1_pdbl", "zk_g2_padd", "zk_g2_pdbl")


class MSMTap:
    """While active, wraps msm._msm_impl (each prove's batched G1 MSM of the
    four families and its G2 MSM): the card synchronised before and after
    each call, its host wall time, the point-kernel launches it made, and
    each of those launches' entry, point count and doubling count."""

    def __init__(self, backend):
        from zkfl_tpu_torch.ops import msm

        self.backend, self.msm = backend, msm
        self.calls = []                        # (group, scalar rows, lanes, ms, launches, shapes)
        self.shapes = None

    def __enter__(self):
        import torch

        impl = self.impl = self.msm._msm_impl
        launch = self.launch = self.backend.launch

        def tapped(points, scalars, ops, *args, **kwargs):
            torch.cuda.synchronize()
            before = collections.Counter(self.backend.LAUNCHES)
            self.shapes = []
            t0 = time.perf_counter()
            out = impl(points, scalars, ops, *args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            made = collections.Counter(self.backend.LAUNCHES) - before
            group = "g2" if ops is self.msm._G2Ops else "g1"
            self.calls.append((group, scalars.shape[0], scalars.shape[-1], ms, dict(made), self.shapes))
            self.shapes = None
            return out

        def tapped_launch(entry, count_as, *args):
            if self.shapes is not None and entry in POINT_ENTRIES:
                padd = entry.endswith("padd")
                self.shapes.append((entry, args[3] if padd else args[2], 1 if padd else args[3]))
            launch(entry, count_as, *args)

        self.msm._msm_impl = tapped
        self.backend.launch = tapped_launch
        return self

    def __exit__(self, *exc):
        self.msm._msm_impl = self.impl
        self.backend.launch = self.launch


def replay_ms(backend, dev, shapes) -> float:
    """Card time of one MSM's point kernels: its launches (entry, points,
    doublings) replayed back to back behind a sleep on the card, on zero
    inputs of the same shapes (the kernels are branchless, so their time
    does not depend on the values).  Called outside the counted runs."""
    import torch

    lib, stream = backend.lib(), backend.stream(dev)
    words = 48 * max(n for _, n, _ in shapes)
    p, q, out = (torch.zeros(words, dtype=torch.int32, device=dev) for _ in range(3))

    def run():
        for entry, n, times in shapes:
            fn = getattr(lib, entry)
            rc = (fn(p.data_ptr(), q.data_ptr(), out.data_ptr(), n, stream) if entry.endswith("padd")
                  else fn(p.data_ptr(), out.data_ptr(), n, times, stream))
            if rc != 0:
                raise RuntimeError(f"{entry}: CUDA error {rc} in the replay")

    return kernel_ms(lambda: run(), [()], 1)


def report_msms(tap, labels, backend, dev) -> None:
    """Each tapped MSM's wall and its point kernels' card time (replayed);
    ``labels`` names the MSMs' proofs in pairs (a G1 then a G2 MSM each)."""
    for k, (group, rows, lanes, ms, made, shapes) in enumerate(tap.calls):
        counted = sum(v for op, v in made.items() if op.startswith(("g1.", "g2.")))
        if len(shapes) != counted:
            raise AssertionError(f"{len(shapes)} point launches tapped, {counted} counted")
        log(f"  {labels[k // 2]:8s} {group} MSM, {rows} scalar rows x {lanes} points: "
            f"{ms:9.3f} ms wall, its point kernels {replay_ms(backend, dev, shapes):7.3f} ms of card "
            f"time (replayed); launches {made}")


def phase_round(dev, artifacts, backend):
    """Phase 5: one REFERENCE_CONFIG round on the port, its cold setups on
    the card, the widest launch of every kernel (the setups' folds
    included) held against its plain version; returns the launch counts of
    the setups and of the round, and the round's RoundProver."""
    import torch

    from zkfl_tpu_torch.fl import prover as fl_prover
    from zkfl_tpu_torch.fl.config import REFERENCE_CONFIG
    from zkfl_tpu_torch.fl.prover import RoundProver
    from zkfl_tpu_torch.fl.simulation import run_round
    from zkfl_tpu_torch.groth16.engine import TorchEngine

    cfg = REFERENCE_CONFIG
    chk = LaunchCheck(SEED + 5)
    backend.LAUNCHES.clear()
    with chk, SetupTap(backend) as tap, WallTap(setup_targets()) as walls:
        t0 = time.time()
        prover = RoundProver(cfg, TorchEngine(dev), cache_dir=artifacts)
        setup_s = time.time() - t0
    setup_launches = dict(backend.LAUNCHES)
    cold = bool(tap.calls)
    log(f"  setups ready in {setup_s:.1f} s ({'cold, on the card' if cold else 'from the cache'}); "
        f"profile {prover.engine.profile}")
    walls.report("setups")
    if cold:
        log(f"  {tap.report(setup_s)}")
        if not all((op, "fold") in chk.widest for op in ("g1.padd", "g2.padd")):
            raise AssertionError(f"the cold setups' folds launched no g1.padd or g2.padd: {setup_launches}")
    for cs in (prover.balance_cs, prover.training_cs, prover.secagg_cs):
        log(f"  {cs.name}: {cs.n_wires} wires, {len(cs.constraints)} constraints")

    backend.LAUNCHES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with chk, MSMTap(backend) as tap, WallTap(prove_targets() + [(fl_prover, "groth16_verify")]) as walls:
        server, timings = run_round(cfg, prover=prover, verbose=False)
    torch.cuda.synchronize()
    launches = dict(backend.LAUNCHES)
    walls.report("round")
    chk.verify("round")

    # The proofs run circuit by circuit, one batched prove each: a G1 then
    # a G2 MSM per circuit.
    circuits = ("balance", "training", "secagg")
    if [c[0] for c in tap.calls] != ["g1", "g2"] * len(circuits):
        raise AssertionError(f"MSM calls {[c[:3] for c in tap.calls]}, expected G1, G2 per circuit")
    report_msms(tap, circuits, backend, dev)
    unfused = {op: launches.get(op, 0) for op in ("fq.add", "fq.sub", "fq.mont_mul")}
    if any(unfused.values()) or not launches.get("g2.padd") or not launches.get("g2.pdbl"):
        raise AssertionError(f"the G2 MSM did not go through K6 alone: {unfused}, "
                             f"g2.padd {launches.get('g2.padd')}, g2.pdbl {launches.get('g2.pdbl')}")

    for name in ("setup", "datasets", "commitments", "balance_proofs", "training_proofs",
                 "secagg_proofs", "aggregate", "total"):
        log(f"  phase {name:16s} {timings[name]:9.3f} s")
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check_round(server, cfg)
    return setup_launches, launches, prover


def check_round(server, cfg) -> None:
    """Every proof of a round verified and the masks cancel in its aggregate."""
    from zkfl_tpu_torch.commit.vector_hash import from_field
    from zkfl_tpu_torch.field.bn254 import FR

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


# The kernels of the production run (phase 7): the fused prove path and
# the setup's fold (fq.to_mont uploads the keys).
PROD_PATH = ("fr.to_mont", "fr.mont_mul", "fr.from_mont", "fr.mul_sub_mul_const",
             "fr.mont_mul_const", "fr.butterfly", "fr.normalize_raw", "fq.to_mont",
             "g1.padd", "g1.pdbl", "g2.padd", "g2.pdbl")
PROD_CONSTRAINTS = {"balance": 357_764, "v5": 25_858}  # zkfl_tpu/fl/prod.py:165, ROADMAP


PROD_CACHE = os.path.join(REPO, "build", "zkfl_prod_artifacts")


def structure_targets():
    """The functions of fl/prod.py's structure step, for WallTap."""
    from zkfl_tpu_torch.fl import prod
    from zkfl_tpu_torch.r1cs import compiled

    return [(prod, "build_structure"), (prod, "compile_and_cache"), (prod, "compiled_cached"),
            (compiled.CompiledCircuit, "from_structure"), (compiled.CompiledCircuit, "save")]


def check_prod(res, what: str) -> None:
    """Both production proofs verify natively, bind one root_D, and their
    circuits have the reference's constraint counts."""
    if not (res["balance_verified"] and res["v5_verified"]):
        raise AssertionError(f"{what}: a production proof does not verify: {res}")
    if not res["binding_ok"]:
        raise AssertionError(f"{what}: the balance and v5 proofs do not bind the same root_D")
    if res["constraints"] != PROD_CONSTRAINTS:
        raise AssertionError(f"{what}: constraints {res['constraints']}, expected {PROD_CONSTRAINTS}")


def phase_prod(dev, backend):
    """Phase 7: fl/prod.py's production run on the card, twice.  First
    instrumented: from an empty PROD_CACHE it builds both structures in
    Python and sets them up on the card (fl/prod.py's cold path); the taps
    split the setups, proofs and MSMs (synchronising the card around every
    tapped function) and hold the widest launch of every kernel, the
    setups' folds included, against its plain version.  Then as a user
    runs it, from those caches and untapped: its timings are the run's
    end-to-end times, its launches the path's.  Returns (the first run's
    setup launches, the second run's launches, the (vk, proof) pairs the
    first run verified)."""
    import torch

    from zkfl_tpu_torch.fl import prod
    from zkfl_tpu_torch.groth16 import device_prover
    from zkfl_tpu_torch.groth16.engine import TorchEngine

    cold = not (os.path.isdir(PROD_CACHE) and os.listdir(PROD_CACHE))
    log(f"  N={prod.PROD_N}, DIM={prod.PROD_DIM}, DEPTH={prod.PROD_DEPTH}, batch {prod.PROD_BATCH}; "
        f"artifacts {PROD_CACHE} ({'empty: cold' if cold else 'present: warm'})")
    log("  [7a] instrumented run (the taps synchronise the card around each tapped function)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    backend.LAUNCHES.clear()
    targets = structure_targets() + [(prod, "setup_cached"), (prod, "generate_dataset"),
                                     (prod, "generate_witness"), (prod, "groth16_verify")]
    with LaunchCheck(SEED + 7) as chk, SetupTap(backend) as stap, MSMTap(backend) as mtap, \
            WallTap(targets + setup_targets() + prove_targets()) as walls, \
            Record(prod, "groth16_verify") as verified:
        res = prod.run_prod_integration(cache_dir=PROD_CACHE, engine=TorchEngine(dev))
    torch.cuda.synchronize()
    log(f"  instrumented launches {dict(backend.LAUNCHES)}; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    unchecked = [name for name in PROD_PATH if (name, "path") not in chk.widest]
    if unchecked:
        raise AssertionError(f"the production run never launched {unchecked}")
    chk.verify("prod")
    check_prod(res, "instrumented run")
    for name, secs in res["timings"].items():
        log(f"  instrumented {name:24s} {secs:9.3f} s")
    walls.report("instrumented prod")
    setup_launches = collections.Counter()
    for call in stap.calls:
        setup_launches.update(call[4])
    if stap.calls:
        log(f"  {stap.report(res['timings']['setups_s'])}")
        if not all((op, "fold") in chk.widest for op in ("g1.padd", "g2.padd")):
            raise AssertionError(f"the production setups' folds launched no g1.padd or g2.padd: "
                                 f"{dict(setup_launches)}")
    labels = ("balance", "v5", "balance", "v5")  # first proves, then steady ones
    if [c[0] for c in mtap.calls] != ["g1", "g2"] * len(labels):
        raise AssertionError(f"MSM calls {[c[:3] for c in mtap.calls]}, expected G1, G2 per proof")
    report_msms(mtap, labels, backend, dev)

    log("  [7b] the same run from the caches, untapped")
    device_prover._prover_cache.clear()      # the first run's keys and COO streams
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    backend.LAUNCHES.clear()
    res = prod.run_prod_integration(cache_dir=PROD_CACHE, engine=TorchEngine(dev))
    torch.cuda.synchronize()
    launches = dict(backend.LAUNCHES)
    check_prod(res, "untapped run")
    for name, secs in res["timings"].items():
        log(f"  {name:24s} {secs:9.3f} s")
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"  launches {launches}")
    log(f"  result {json.dumps({k: v for k, v in res.items() if k != 'timings'})}")
    missing = [name for name in PROD_PATH if not launches.get(name)]
    if missing:
        raise AssertionError(f"the production run never launched {missing}")
    return dict(setup_launches), launches, verified.calls


FORMATS_POWER = 14       # the ptau power of REFERENCE_CONFIG's 16,384 domain
TP_MSM_POINTS = 1 << 16  # phase 8's TP-MSM against the unsharded one
SNARKJS_FIXTURE = os.path.join(REPO, "tests", "data", "snarkjs_layout_toy.zkey")


def toy_circuit():
    """The circuit of the committed snarkjs-layout fixture (out = x^2 y + x
    + 7 at x = 3, y = 5: its seeded keys are tests/data's zkey)."""
    from zkfl_tpu_torch.r1cs.builder import ConstraintSystem

    cs = ConstraintSystem(name="bin_toy")
    out = cs.public_input("out", 3 * 3 * 5 + 3 + 7)
    x = cs.private_input("x", 3)
    y = cs.private_input("y", 5)
    cs.enforce_equal(cs.mul(cs.mul(x, x), y) + x + 7, out)
    return cs


def check_ptau(dev, work, rng):
    """Phase 8 (a): write_ptau on the card at FORMATS_POWER, read back; 16
    seeded indices of each section against the host curve, 4 of them by
    the native pairing."""
    from zkfl_tpu_torch import native
    from zkfl_tpu_torch.field.bn254 import FR
    from zkfl_tpu_torch.field.curve import G1_GEN, g1_mul, g1_neg, g2_generator, g2_mul_jac
    from zkfl_tpu_torch.groth16.binformat import read_ptau, write_ptau

    tau, alpha, beta = (rng.randrange(2, FR) for _ in range(3))
    path = os.path.join(work, "dev.ptau")
    write_ptau(path, FORMATS_POWER, tau, alpha, beta, device=dev)
    p = read_ptau(path)
    n = 1 << FORMATS_POWER
    sizes = [len(p[k]) for k in ("tau_g1", "tau_g2", "alpha_tau_g1", "beta_tau_g1")]
    if (p["power"], sizes) != (FORMATS_POWER, [2 * n - 1, n, n, n]):
        raise AssertionError(f"ptau power {p['power']}, section sizes {sizes}")
    g2 = g2_generator()
    if g2_key([p["beta_g2"]]) != g2_key([g2_mul_jac(g2, beta)]):
        raise AssertionError("ptau beta_g2 != beta * G2")
    for i in rng.sample(range(2 * n - 1), 16):
        if p["tau_g1"][i] != g1_mul(G1_GEN, pow(tau, i, FR)):
            raise AssertionError(f"ptau tau_g1[{i}] != tau^{i} * G1")
    idx = rng.sample(range(n), 16)
    for i in idx:
        t = pow(tau, i, FR)
        if g2_key([p["tau_g2"][i]]) != g2_key([g2_mul_jac(g2, t)]):
            raise AssertionError(f"ptau tau_g2[{i}] != tau^{i} * G2")
        if (p["alpha_tau_g1"][i], p["beta_tau_g1"][i]) != \
                (g1_mul(G1_GEN, alpha * t % FR), g1_mul(G1_GEN, beta * t % FR)):
            raise AssertionError(f"ptau alpha/beta tau_g1[{i}] disagree with the host curve")
    for i in idx[:4]:
        ok = native.pairing_check_native([(g1_neg(p["tau_g1"][i]), g2), (G1_GEN, p["tau_g2"][i])])
        if ok is not True:
            raise AssertionError(f"e(tau_g1[{i}], G2) != e(G1, tau_g2[{i}]) (native check: {ok})")
    return f"power {FORMATS_POWER}, {os.path.getsize(path)} bytes; 16 indices of each section " \
           f"equal the host curve, 4 pairings hold"


def check_zkey(prover, work, witness):
    """Phase 8 (b): REFERENCE_CONFIG's balance key through write_zkey and
    read_zkey; a fused proof on the card with the reloaded key."""
    from zkfl_tpu_torch.groth16.binformat import read_zkey, write_zkey
    from zkfl_tpu_torch.groth16.prover import groth16_prove
    from zkfl_tpu_torch.groth16.verifier import groth16_verify

    pk, vk, cs = prover.balance_pk, prover.balance_vk, prover.balance_cs
    path = os.path.join(work, "balance.zkey")
    write_zkey(path, pk, vk, cs)
    pk2, vk2, meta = read_zkey(path)
    if key_ints((pk2, vk2)) != key_ints((pk, vk)) or meta["n_vars"] != cs.n_wires:
        raise AssertionError("the balance key read back from its zkey differs")
    if not groth16_verify(vk2, groth16_prove(pk2, cs, witness, engine=prover.engine)):
        raise AssertionError("the fused proof with the reloaded balance key does not verify")
    return f"{os.path.getsize(path)} bytes, {len(meta['coeffs'])} coefficients; equal; its proof verifies"


def check_fixture(dev):
    """Phase 8 (c): the committed snarkjs-layout zkey (odd H basis) proved
    on the card through groth16_prove's stage-by-stage branch."""
    from zkfl_tpu_torch.groth16.binformat import read_zkey, structure_from_zkey
    from zkfl_tpu_torch.groth16.engine import TorchEngine
    from zkfl_tpu_torch.groth16.prover import groth16_prove
    from zkfl_tpu_torch.groth16.verifier import groth16_verify

    pk, vk, meta = read_zkey(SNARKJS_FIXTURE)
    if pk.h_basis != "odd_evals":
        raise AssertionError(f"the fixture reads as h_basis {pk.h_basis!r}")
    proof = groth16_prove(pk, structure_from_zkey(pk, meta), toy_circuit().values,
                          engine=TorchEngine(dev))
    if not groth16_verify(vk, proof):
        raise AssertionError("the snarkjs fixture's proof on the card does not verify")
    return f"domain {pk.domain}, odd basis; its proof on the card verifies"


def check_json(verified):
    """Phase 8 (d): phase 7's proofs and vkeys to snarkjs JSON and back."""
    from zkfl_tpu_torch.groth16 import serialize as ser
    from zkfl_tpu_torch.groth16.verifier import groth16_verify

    if len(verified) != 2:
        raise AssertionError(f"phase 7 verified {len(verified)} proofs, expected 2")
    for vk, proof in verified:
        text = json.dumps([ser.proof_to_json(proof), ser.public_to_json(proof.public_signals),
                           ser.vkey_to_json(vk)])
        pj, pub, vj = json.loads(text)
        back = ser.proof_from_json(pj, ser.public_from_json(pub))
        vk2 = ser.vkey_from_json(vj)
        if key_ints((back, vk2)) != key_ints((proof, vk)) or not groth16_verify(vk2, back):
            raise AssertionError("a production proof or vkey changed through JSON")
    return "both production proofs and vkeys equal after JSON and back; both verify"


def check_dp(dev, prover, witnesses):
    """Phase 8 (e): the client batch over a 3-shard "clients" mesh equals
    the unsharded batch; then a whole round with that mesh."""
    from zkfl_tpu_torch.fl.config import REFERENCE_CONFIG
    from zkfl_tpu_torch.fl.simulation import run_round
    from zkfl_tpu_torch.groth16.device_prover import device_prover
    from zkfl_tpu_torch.parallel import Mesh

    eng = prover.engine
    dp = device_prover(prover.balance_pk, prover.balance_cs, eng.device, eng.profile)
    mesh = Mesh([dev] * len(witnesses), "clients")
    want, plain_ms = once_ms(lambda: dp.msm_results_many(witnesses))
    got, mesh_ms = once_ms(lambda: dp.msm_results_many(witnesses, mesh=mesh))
    if got != want:
        raise AssertionError("the client mesh's MSM results differ from the unsharded batch's")
    server, timings = run_round(REFERENCE_CONFIG, prover=prover, verbose=False, mesh=mesh)
    check_round(server, REFERENCE_CONFIG)
    return f"{mesh}: the balance batch's MSMs equal (unsharded {plain_ms:.1f} ms, sharded " \
           f"{mesh_ms:.1f} ms); run_round(mesh=) {timings['total']:.3f} s"


def check_tp_msm(dev, points, rng):
    """Phase 8 (f): msm_g1_sharded over 4 shards against pippenger_g1 on 64
    points and against the unsharded msm_g1_host on TP_MSM_POINTS."""
    from zkfl_tpu_torch.field.bn254 import FR
    from zkfl_tpu_torch.field.curve import G1_GEN, g1_mul
    from zkfl_tpu_torch.groth16.prover import pippenger_g1
    from zkfl_tpu_torch.ops.msm import msm_g1_host
    from zkfl_tpu_torch.parallel import Mesh, msm_g1_sharded

    mesh = Mesh([dev] * 4, "points")
    pts = [g1_mul(G1_GEN, rng.randrange(1, FR)) for _ in range(64)]
    scs = [rng.randrange(FR) for _ in range(64)]
    if msm_g1_sharded(pts, scs, mesh) != pippenger_g1(pts, scs):
        raise AssertionError("the sharded MSM of 64 points != pippenger_g1")
    scs = [rng.randrange(FR) for _ in range(len(points))]
    want, plain_ms = once_ms(lambda: msm_g1_host(points, scs, dev))
    got, tp_ms = once_ms(lambda: msm_g1_sharded(points, scs, mesh))
    if got != want:
        raise AssertionError(f"the sharded MSM of {len(points)} points != msm_g1_host")
    return f"{mesh}: 64 points equal pippenger_g1; {len(points)} points of the production " \
           f"balance key equal msm_g1_host (unsharded {plain_ms:.1f} ms, sharded {tp_ms:.1f} ms)"


def check_tp_prover(dev, dp, witness, vk):
    """Phase 8 (g): the production balance proof through the TP prover over
    a 4-shard "points" mesh: its MSM results equal the unsharded pipeline's
    bit for bit, its proof verifies; each timed twice (the first TP call
    builds the 4-step tables)."""
    from zkfl_tpu_torch.groth16.prover import _assemble_proof, default_blinding
    from zkfl_tpu_torch.groth16.verifier import groth16_verify
    from zkfl_tpu_torch.parallel import Mesh
    from zkfl_tpu_torch.parallel.prover import _factor, msm_results_tp

    mesh = Mesh([dev] * 4, "points")
    r, s = default_blinding(witness)

    def prove(msm_results):
        msms = msm_results()
        return msms, _assemble_proof(dp.pk, witness, msms, r, s)

    times = []
    for _ in range(2):
        (want_msms, want), plain_ms = once_ms(lambda: prove(lambda: dp.msm_results(witness)))
        (msms, proof), tp_ms = once_ms(lambda: prove(lambda: msm_results_tp(dp, [witness], mesh)[0]))
        times.append((plain_ms, tp_ms))
        if msms != want_msms:
            raise AssertionError("the TP prover's MSM results differ from the unsharded pipeline's")
    if (proof.pi_a, proof.pi_b, proof.pi_c) != (want.pi_a, want.pi_b, want.pi_c):
        raise AssertionError("the TP proof differs from the unsharded proof")
    if not groth16_verify(vk, proof):
        raise AssertionError("the TP proof does not verify")
    n1, n2 = _factor(dp.domain, 4)
    return (f"{mesh}, domain {dp.domain} = {n1} x {n2}, n_max {dp.n_max}: MSM results equal the "
            f"unsharded pipeline's, the proof verifies; prove ms (unsharded, TP) first "
            f"{times[0][0]:.1f}, {times[0][1]:.1f}; second {times[1][0]:.1f}, {times[1][1]:.1f}"), times


def phase_parallel(dev, backend, prover, verified):
    """Phase 8: formats and sharding on the card, from what phases 5 and 7
    left in memory and on disk (REFERENCE_CONFIG's RoundProver, phase 7's
    verified proofs, the production caches).  LaunchCheck holds the widest
    launch of every kernel against its plain version.  Returns (launch
    counts, the TP prover's times)."""
    import random

    import torch

    from zkfl_tpu_torch.fl import prod
    from zkfl_tpu_torch.fl.client import Client, SharedLCG
    from zkfl_tpu_torch.fl.config import REFERENCE_CONFIG
    from zkfl_tpu_torch.groth16.device_prover import DeviceProver
    from zkfl_tpu_torch.r1cs.circuits import generate_witness

    rng = random.Random(SEED + 8)
    work = os.path.join(REPO, "build", "phase8")
    os.makedirs(work, exist_ok=True)
    cfg = REFERENCE_CONFIG
    clients = [Client(i, cfg, prover) for i in range(1, cfg.num_clients + 1)]
    lcg = SharedLCG(cfg.seed)
    for c in clients:
        c.generate_private_dataset(lcg)
        c.compute_dataset_commitment()
    witnesses = [c.balance_witness() for c in clients]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    backend.LAUNCHES.clear()
    tp = {}

    def part(name, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        log(f"  [8{name}] {time.time() - t0:8.3f} s  {out}")

    def prod_balance():
        cc, _ = prod._structure(prod.BALANCE_PARAMS, PROD_CACHE, log)
        pk, vk = prod._setup(cc, None, prod.BALANCE_PARAMS, PROD_CACHE, None, dev, log)
        wit = generate_witness(prod.BALANCE_PARAMS, prod.balance_inputs(prod.generate_dataset()))
        tp.update(dp=DeviceProver(pk, cc, dev), vk=vk, witness=wit.witness)
        return f"production balance key, structure and witness from {PROD_CACHE}"

    def tp_prover():
        text, tp["times"] = check_tp_prover(dev, tp["dp"], tp["witness"], tp["vk"])
        return text

    with LaunchCheck(SEED + 8) as chk:
        part("a write_ptau", lambda: check_ptau(dev, work, rng))
        part("b zkey", lambda: check_zkey(prover, work, witnesses[0]))
        part("c snarkjs", lambda: check_fixture(dev))
        part("d json", lambda: check_json(verified))
        part("e DP", lambda: check_dp(dev, prover, witnesses))
        part(" load", prod_balance)
        part("f TP-MSM", lambda: check_tp_msm(dev, tp["dp"].pk.a_query[:TP_MSM_POINTS], rng))
        part("g TP prover", tp_prover)
    torch.cuda.synchronize()
    launches = dict(backend.LAUNCHES)
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"  launches {launches}")
    chk.verify("parallel")
    # the production run's kernels: the DP, TP and odd-basis prove paths,
    # the sharded MSMs, write_ptau's folds
    missing = [name for name in PROD_PATH if not launches.get(name)]
    if missing:
        raise AssertionError(f"phase 8 never launched {missing}")
    return launches, tp["times"]


BENCH_BUDGET = 300.0      # seconds for phase 9 (a), bench's measurements from the headline on
SCALING_POINTS = (8, 16)  # phase 9 (c): N of the scaling sweep, cold setups on the card


def check_bench(b) -> str:
    """Phase 9 (a): every extra of a whole bench run present and positive,
    the headline measured, the three rate MSMs held against their
    repeated-base sums."""
    from zkfl_tpu_torch import bench

    res, extras = b.result, b.extras
    if res["value"] <= 0 or res["vs_baseline"] <= 0:
        raise AssertionError(f"bench: no headline: {res}")
    if "skipped_after" in extras or "full_round_is_warmup" in extras:
        raise AssertionError(f"bench: the budget cut the run: {extras}")
    missing = [k for k in bench.EXTRA_KEYS if k not in extras]
    if missing or set(extras) != set(bench.EXTRA_KEYS):
        raise AssertionError(f"bench: extras {sorted(extras)}, expected {sorted(bench.EXTRA_KEYS)}")
    for key, value in extras.items():
        if key == "gpu":
            ok = isinstance(value, str) and bool(value)
        elif key == "round_phases_s":
            ok = all(v >= 0 for v in value.values()) and value["balance_proofs"] > 0
        else:
            ok = value > 0
        if not ok:
            raise AssertionError(f"bench: extras[{key!r}] = {value!r}")
    if len(b.checked) != 3:
        raise AssertionError(f"bench: {len(b.checked)} rate MSMs checked, expected 3: {b.checked}")
    return f"value {res['value']:.4f} s; {len(extras)} extras present and positive; " \
           f"{', '.join(b.checked)} equal their repeated-base sums"


def phase_entry_points(dev, backend, prover, artifacts):
    """Phase 9: the port's measuring entry points, called as functions in
    this process: (a) bench's measurements on phase 5's RoundProver, (b)
    round8's 8-client round (its setups from phase 5's cache where the
    domain matches), (c) scaling.run_point at SCALING_POINTS with cold
    setups on the card.  LaunchCheck holds the widest launch of every
    kernel, and a K5Tap a slice of bench's last Poseidon launch, against
    the plain versions.  Returns each entry point's launch counts."""
    import shutil

    import torch

    from zkfl_tpu_torch import bench
    from zkfl_tpu_torch.fl.config import FLConfig
    from zkfl_tpu_torch.ops.poseidon import PoseidonKernel
    from zkfl_tpu_torch.scripts import round8, scaling

    work = os.path.join(REPO, "build", "phase9_scaling")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths = {}

    def part(name, fn):
        backend.LAUNCHES.clear()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        paths[name] = dict(backend.LAUNCHES)
        log(f"  [9 {name}] {time.time() - t0:8.3f} s  {out}")
        log(f"  [9 {name}] launches {paths[name]}")

    def run_bench():
        b = bench.Bench(BENCH_BUDGET)
        with K5Tap(SEED + 9) as tap:
            bench.measure(b, prover)
        log(f"  {json.dumps(b.result)}")
        t, states, _, _, x, y = tap.launches[-1]
        if max_abs_err(y, PoseidonKernel(t).permute_plain(x)) != 0:
            raise AssertionError("bench: the last K5 launch disagrees with permute_plain")
        return check_bench(b) + f"; {x.shape[1]} states of its last K5 launch ({states} states) " \
                                "equal permute_plain"

    def run_round8():
        res, server = round8.run(dev, cache_dir=artifacts, log=log)
        log(f"  {json.dumps(res)}")
        check_round(server, FLConfig(num_clients=round8.NUM_CLIENTS))
        return f"round {res['round_s']:.3f} s, {res['prove_per_client_s']:.4f} s of proving a client"

    def run_scaling():
        points = []
        for n in SCALING_POINTS:
            p = scaling.run_point(n, work, dev)
            log(f"  {json.dumps(p)}")
            points.append(f"N={n} prove {p['prove_s']:.3f} s (setups {p['setups_s']:.1f} s)")
        return "; ".join(points) + "; every proof verifies"

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with LaunchCheck(SEED + 9) as chk:
        part("bench", run_bench)
        part("round8", run_round8)
        part("scaling", run_scaling)
    log(f"  peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    chk.verify("entry points")
    for name, launches in paths.items():
        missing = [op for op in PROD_PATH if not launches.get(op)]
        if missing:
            raise AssertionError(f"phase 9 {name} never launched {missing}")
    if not paths["bench"].get("fr.poseidon"):
        raise AssertionError("phase 9 bench launched no fr.poseidon")
    return paths


# kernel op -> (source, the TPU kernel it replaces)
KERNELS = {
    "fr.to_mont": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:374"),
    "fr.mont_mul": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:357"),
    "fr.add": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:364"),
    "fr.sub": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:367"),
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
    "fq.from_mont": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:370"),
    "fq.mont_mul_const": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:571"),
    "fq.mul_sub_mul_const": ("field_ew.cu", "zkfl_tpu/ops/limb_kernels.py:396"),
    "g1.padd": ("g1_point.cu", "zkfl_tpu/ops/point_kernels.py:68"),
    "g1.pdbl": ("g1_point.cu", "zkfl_tpu/ops/point_kernels.py:101"),
    "g2.padd": ("g2_point.cu", "zkfl_tpu/ops/point_kernels.py:284"),
    "g2.pdbl": ("g2_point.cu", "zkfl_tpu/ops/point_kernels.py:321"),
}
# These report the launches of their check in phase 3: no path of either
# package squares a field element or launches an Fr add or sub (K2 adds
# inside the butterfly), the QAP's from_mont and two const ops run over Fr
# only, and since K6 the round launches no Fq add, sub or product (phase 5
# asserts that it made none of those three).
CHECK_ONLY = ("fr.mont_sqr", "fq.mont_sqr", "fr.add", "fr.sub", "fq.add", "fq.sub", "fq.mont_mul",
              "fq.from_mont", "fq.mont_mul_const", "fq.mul_sub_mul_const")


def report_row(name, rows, launches, paths):
    """One op of the kernels line.  fr.poseidon's row is phase 6's: card
    time and bound summed over the commitment's launches, plain time over
    the tapped states, each group of launches under "parts"."""
    row = rows[name]
    src, tpu = KERNELS[name]
    out = {"name": name, "route": "cuda", "source": f"zkfl_tpu_torch/csrc/{src}", "replaces": tpu,
           "launches": launches[name], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
           "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
           "library_ms": None, "paths": paths}
    for extra in ("parts", "ladder_lanes", "ladder_ms"):
        if extra in row:
            out[extra] = row[extra]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from zkfl_tpu_torch import backend, kernel_stats

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
        f"{int32_peak(sm_mhz) / 1e12:.2f} T multiply-adds/s")

    log("[2] build")
    t0 = time.time()
    lib_path = backend.build()
    backend.lib()
    log(f"  {lib_path} in {time.time() - t0:.1f} s")
    nvcc_s = {}
    build_log = (lib_path.parent / "build.log").read_text()
    for line in build_log.splitlines():
        if line.startswith("# nvcc "):
            what, secs = line[len("# nvcc "):].split(": ")
            nvcc_s[what] = float(secs.split()[0])
    for entry, regs, spills in kernel_stats.ptxas_report(build_log):
        log(f"  ptxas {entry}: {regs} registers ({kernel_stats.blocks_per_sm(regs)} blocks of 128 "
            f"threads fit an SM); {spills}")
    for line in kernel_stats.product_sass_lines(lib_path):
        log(f"  sass {line}")
    log(f"  nvcc wall time per process: {nvcc_s}; the sources' compiles add up to "
        f"{sum(v for k, v in nvcc_s.items() if k != 'link'):.1f} s")

    log("[3] kernels vs plain versions")
    t0 = time.time()
    rows = phase_kernels(dev, backend, sm_mhz)
    log(f"  phase 3 in {time.time() - t0:.1f} s")

    log("[4] MICRO_CONFIG balance setup and proof parity")
    t0 = time.time()
    phase_micro_parity(dev, artifacts, backend)
    log(f"  phase 4 in {time.time() - t0:.1f} s")

    log("[5] REFERENCE_CONFIG round")
    t0 = time.time()
    setup_launches, round_launches, round_prover = phase_round(dev, artifacts, backend)
    log(f"  phase 5 in {time.time() - t0:.1f} s")
    for name in sorted(round_launches):
        log(f"  launches {name:24s} {round_launches[name]}")

    log("[6] dataset commitment on the card")
    t0 = time.time()
    commit_launches, rows["fr.poseidon"] = phase_commitment(dev, backend, sm_mhz)
    log(f"  phase 6 in {time.time() - t0:.1f} s")

    log("[7] production run: balance N=128 (2^19 domain) + sgd_step_v5")
    t0 = time.time()
    prod_setup_launches, prod_launches, prod_verified = phase_prod(dev, backend)
    log(f"  phase 7 in {time.time() - t0:.1f} s")

    log("[8] formats and sharding")
    t0 = time.time()
    parallel_launches, _ = phase_parallel(dev, backend, round_prover, prod_verified)
    log(f"  phase 8 in {time.time() - t0:.1f} s")

    log("[9] entry points: bench, round8, scaling")
    t0 = time.time()
    entry_launches = phase_entry_points(dev, backend, round_prover, artifacts)
    log(f"  phase 9 in {time.time() - t0:.1f} s")

    setups = collections.Counter(setup_launches) + collections.Counter(prod_setup_launches)
    by_path = {"setup": setups, "round": round_launches, "commit": commit_launches,
               "prod": prod_launches, "parallel": parallel_launches, **entry_launches}
    paths = {name: {k: v.get(name, 0) for k, v in by_path.items()} for name in KERNELS}
    launches = {name: sum(paths[name].values()) for name in KERNELS}
    for name in CHECK_ONLY:
        launches[name] = rows[name]["check_launches"]
    missing = [name for name in KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")

    report = [report_row(name, rows, launches, paths[name]) for name in KERNELS]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
