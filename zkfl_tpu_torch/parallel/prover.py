"""Tensor-parallel fused prove pipeline: sharded 4-step h(X) + sharded MSMs
(counterpart of zkfl_tpu/parallel/prover.py).

The DP path (DeviceProver.msm_results_many(mesh=...)) shards independent
client proofs over a "clients" axis; THIS module shards the inside of ONE
proof over a "points" axis — the regime of the reference's production
dimensions (2^19 domains, proving keys of ~2M points, ref:Report.pdf
Table 5 / tests/integration_test.mjs:557-697):

  * h(X) by the chain iNTT -> coset shift -> NTT -> pointwise -> iNTT ->
    unshift of ops/qap.py compute_h, each transform a 4-step NTT whose one
    cross-shard exchange is an all_to_all (3 in all); the layout alternates
    between the (n1, n2) and (n2, n1) factor roles, so no other transpose
    crosses shards (parallel/ntt.py's scheme, chained).
  * the five proving MSMs with points + scalars sharded on the lane axis:
    local Pippenger window sums and ONE all_gather + fold per group
    (parallel/msm.py).

The witness, the COO stream and the sparse evaluation are replicated: they
run once, on the mesh's first device; only the lanes are sharded.
Bit-exactness oracle: the unsharded fused pipeline
(device_prover._prove_msms_impl) — tests/test_torch_parallel.py.
"""

from __future__ import annotations

import weakref
from functools import lru_cache
from typing import List, Sequence

import torch

from ..field.bn254 import FR, FR_GENERATOR, fr_inv
from ..field.limbs import N_LIMBS
from ..groth16.device_prover import msm_scalars
from ..ops import msm as mp
from ..ops.limb_kernels import FRK
from ..ops.qap import matrix_evals
from .mesh import Mesh
from .msm import _sharded_msm_local
from .ntt import _ntt4_local, _twiddle_shards


@lru_cache(maxsize=16)
def _coset_tables(n1: int, n2: int):
    """Host tables for the coset shift, laid out to match the 4-step
    chain's storage at the point they are applied (numpy, cached).

    fwd  [8, n2, n1]: g^(k1 + n1*k2) at storage [k2, k1] — applied after
         the first iNTT, whose output holds coefficient k1 + n1*k2 at
         [k1, k2] and is locally transposed to [k2, k1].
    inv  [8, n1, n2]: g^-(k1 + n1*k2) / (g^n - 1) at storage [k1, k2] —
         the final iNTT's output layout; the vanishing-polynomial division
         is folded in (Z = g^n - 1 is constant on the coset).
    """
    n = n1 * n2
    g = FR_GENERATOR
    g_inv = fr_inv(g)
    z_inv = fr_inv((pow(g, n, FR) - 1) % FR)
    pow_g = [1] * n
    for i in range(1, n):
        pow_g[i] = pow_g[i - 1] * g % FR
    fwd = [pow_g[k1 + n1 * k2] for k2 in range(n2) for k1 in range(n1)]
    inv_seq = [1] * n
    for i in range(1, n):
        inv_seq[i] = inv_seq[i - 1] * g_inv % FR
    inv = [
        inv_seq[k1 + n1 * k2] * z_inv % FR
        for k1 in range(n1) for k2 in range(n2)
    ]
    # Montgomery-form constants: mont_mul(x_mont, c_mont) keeps mont form;
    # the final from_mont happens after the inverse-coset multiply.
    fwd_m = FRK.pack(fwd).reshape(N_LIMBS, n2, n1)
    inv_m = FRK.pack(inv).reshape(N_LIMBS, n1, n2)
    return fwd_m, inv_m


@lru_cache(maxsize=16)
def _coset_shards(n1: int, n2: int, mesh: Mesh):
    """The coset tables sharded as the chain stores their operands: fwd on
    its last axis (k1), inv on its middle one (k1); uploaded once."""
    fwd, inv = (torch.from_numpy(t).to(mesh.devices[0]) for t in _coset_tables(n1, n2))
    return mesh.shard(fwd, -1), mesh.shard(inv, 1)


def _factor(n: int, D: int):
    """n = n1 * n2 with both multiples of D (n1 as square as possible)."""
    if n < D * D:
        raise ValueError(
            f"TP prover needs domain >= devices^2: domain {n} < {D}^2 = "
            f"{D * D} (use fewer devices on the points axis or a larger "
            "setup domain)"
        )
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n1 = max(n1, D)
    n2 = n // n1
    if n2 < D:
        n1, n2 = n2, n1
    if n1 % D or n2 % D:
        raise ValueError(
            f"cannot factor domain {n} = {n1} x {n2} into multiples of "
            f"{D} devices (domain and device count must be powers of two)"
        )
    return n1, n2


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of a and b broadcast to a's shape."""
    return FRK.mont_mul(a.reshape(N_LIMBS, -1), b.expand(a.shape).reshape(N_LIMBS, -1)).reshape(a.shape)


def _compute_h_local(evals: Sequence[torch.Tensor], twA, twB, twC, cosF, cosI) -> List[torch.Tensor]:
    """The sharded 4-step h(X) chain.  evals: shards [8, L, n1, n2/D] in
    natural order (index j1*n2 + j2, j2 sharded); the tables: shards as
    parallel/ntt.py and _coset_shards lay them out.  Returns h's
    coefficients in STANDARD form, shards [8, L/3, n1/D, n2] holding
    coefficient k1 + n1*k2 at [k1, k2] (k1 sharded)."""
    # iNTT over (n1, n2): shards [8, L, n1/D, n2] = coeff k1 + n1*k2
    c = _ntt4_local(evals, twA, inverse=True)
    # local transpose -> [k2, k1]: natural order for factor roles (n2, n1)
    shifted = [_mm(ci.transpose(2, 3), cf[:, None]) for ci, cf in zip(c, cosF)]
    # forward NTT over (n2, n1): shards [8, L, n2/D, n1] = eval k1' + n2*k2'
    on_coset = _ntt4_local(shifted, twB, inverse=False)
    h_t = []
    for oc in on_coset:
        # pointwise (A.B - C) on the coset (order-agnostic; lanes are
        # b*3 + which, as compute_h's reshape).  const = R keeps
        # Montgomery form; the vanishing division z_inv is folded into cosI.
        L = oc.shape[1]
        abc = oc.reshape(N_LIMBS, L // 3, 3, -1)
        h_ev = FRK.mul_sub_mul_const(
            abc[:, :, 0].reshape(N_LIMBS, -1),
            abc[:, :, 1].reshape(N_LIMBS, -1),
            abc[:, :, 2].reshape(N_LIMBS, -1),
            FRK.mont_r % FR,
        ).reshape((N_LIMBS, L // 3) + oc.shape[2:])
        # local transpose -> [k2', k1']: natural order for (n1, n2) again
        h_t.append(h_ev.transpose(2, 3))
    # iNTT over (n1, n2): shards [8, B, n1/D, n2] = coeff k1 + n1*k2
    h_c = _ntt4_local(h_t, twC, inverse=True)
    # inverse coset shift + vanishing division (cosI folds z_inv), to std
    return [FRK.from_mont(_mm(h, ci[:, None]).reshape(N_LIMBS, -1)).reshape(h.shape)
            for h, ci in zip(h_c, cosI)]


def make_fused_msms_tp(mesh: Mesh, cfg, n1: int, n2: int, axis: str = "points"):
    """The TP fused pipeline over ``mesh``'s ``axis`` (D devices).

    cfg = (domain, n_max, wc_g1, wc_g2, wbits) as device_prover; n_max must
    be a multiple of D*32 (lane blocks align with the scan).  Takes the
    same tensors as _prove_msms_impl, the g1/b2 point lanes as per-shard
    lists of n_max/D lanes each (shard d on device d), the witness and the
    COO stream on the mesh's first device."""
    domain, n_max, wc_g1, wc_g2, wbits = cfg
    D = mesh.shape[axis]
    assert n_max % (D * 32) == 0, (n_max, D)

    def fn(n_pub, g1_pts, b2_pts, rows, cols, coeffs, w_std):
        twA = _twiddle_shards(n1, n2, True, mesh)
        twB = _twiddle_shards(n2, n1, False, mesh)
        cosF, cosI = _coset_shards(n1, n2, mesh)
        B, _, m = w_std.shape
        w_lm = w_std.permute(1, 0, 2)
        w_mont = FRK.to_mont(w_lm.reshape(N_LIMBS, B * m)).reshape(N_LIMBS, B, m)
        evals = matrix_evals(rows, cols, coeffs, w_mont, domain)
        # natural order [8, 3B, n1, n2] (lane = b*3 + which, exactly
        # compute_h's layout), j2 sharded
        ev = evals.reshape(N_LIMBS, 3 * B, n1, n2)
        h4 = _compute_h_local(mesh.shard(ev, 3), twA, twB, twA, cosF, cosI)
        # coefficient i = k1 + n1*k2 lives at [k1, k2] -> linear order
        h = torch.cat([s.to(w_std.device) for s in h4], dim=2)
        h_std = h.transpose(2, 3).reshape(N_LIMBS, B, domain)
        scalars, fam, g2_scalars = msm_scalars(n_pub, w_lm, h_std, n_max)
        g1_out = _sharded_msm_local(g1_pts, mesh.shard(scalars, -1), mp._G1Ops, wbits,
                                    wc_g1, fam)                    # [3, 8, B*4]
        g2_out = _sharded_msm_local(b2_pts, mesh.shard(g2_scalars, -1), mp._G2Ops, wbits,
                                    wc_g2, torch.zeros(B, dtype=torch.int64))  # [3, 2, 8, B]
        return g1_out.reshape(3, N_LIMBS, B, 4), g2_out

    return fn


# DeviceProver -> {(mesh, n_pad): (g1 lane shards, b2 lane shards)}
_lane_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _lane_shards(dp, mesh: Mesh, n_pad: int):
    """dp's point tensors padded with points at infinity to n_pad lanes and
    split over the mesh (views where a shard's device is dp's; made once)."""
    per_dp = _lane_cache.setdefault(dp, {})
    key = (mesh, n_pad)
    if key not in per_dp:
        g1_pts, b2_pts = dp.g1_pts, dp.b2_pts
        extra = n_pad - g1_pts.shape[-1]
        if extra:
            g1_pts = torch.cat([g1_pts, mp._G1Ops.inf((g1_pts.shape[2], extra), g1_pts.device)], dim=-1)
            b2_pts = torch.cat([b2_pts, mp._G2Ops.inf((b2_pts.shape[3], extra), b2_pts.device)], dim=-1)
        per_dp[key] = (mesh.shard(g1_pts, -1), mesh.shard(b2_pts, -1))
    return per_dp[key]


def msm_results_tp(dp, witnesses, mesh: Mesh, axis: str = "points") -> list:
    """Tensor-parallel counterpart of DeviceProver.msm_results_many: ONE
    proof pipeline (or a small batch) sharded over ``axis`` — sharded-NTT
    h(X) + lane-sharded MSMs.  Returns one a/b1/c/h/b2 dict per witness,
    bit-exact with the unsharded fused pipeline."""
    D = mesh.shape[axis]
    B = len(witnesses)
    domain, n_max, _, _, wbits = dp.cfg
    step = D * 32
    n_pad = -(-n_max // step) * step
    n1, n2 = _factor(domain, D)
    for w in witnesses:
        if len(w) != dp.m_wires:
            raise ValueError(f"witness length {len(w)} != wires {dp.m_wires}")

    g1_sh, b2_sh = _lane_shards(dp, mesh, n_pad)
    dev = mesh.devices[0]
    _, _, rows, cols, coeffs = dp.on(dev)
    w_std = torch.from_numpy(dp.pack_witnesses(witnesses)).to(dev)
    cfg = (domain, n_pad, mp._auto_chunk(4 * B, n_pad, False),
           mp._auto_chunk(B, n_pad, True), wbits)
    g1_out, g2_out = make_fused_msms_tp(mesh, cfg, n1, n2, axis)(
        dp.n_pub, g1_sh, b2_sh, rows, cols, coeffs, w_std)
    return dp.results_from_device(g1_out, g2_out)
