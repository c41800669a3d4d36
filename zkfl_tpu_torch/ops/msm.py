"""Batched Pippenger MSM over G1/G2 (counterpart of zkfl_tpu/ops/msm_pallas.py).

The same sort + prefix-scan bucket accumulation as zkfl_tpu, written as torch
glue around the point ops (G1: the K4 kernel; G2: FQK kernels).  For each
window w of the scalars:

  1. sort lanes by digit, descending;
  2. inclusive prefix sums U_j of the sorted points: 32-lane rows scanned
     serially (n adds in all), row totals by a Hillis-Steele scan;
  3. for every threshold k the set {digit >= k} is a prefix of the sorted
     order, so T_k = U[cnt_k - 1] with cnt_k = #{digit >= k} from a histogram,
     and S_w = sum_d d * B_d = sum_k T_k;
  4. S_w folds the gathered prefixes by a masked-shift reduction.

A Horner ladder sum_w 2^(wbits * w) S_w combines the windows.  The TPU chose
this formulation for want of a scatter; on the card it stays because it
keeps every point op a wide batched launch.  Only the affine results are
contractual (the oracle is groth16/prover.py pippenger_g1 / msm_g2).

Layouts: points [3, (2,), 8, m_pts, n] Montgomery; scalars int32 [m, 8, n]
standard form; ``row_map`` [m] maps scalar rows to point rows.
"""

from __future__ import annotations

import torch

from zkfl_tpu.field.bn254 import FR

from . import point_kernels as pk
from .limb_kernels import FRK

WINDOW_BITS = 8   # default for large MSMs
SMALL_MSM = 2048  # below this, 4-bit windows
SERIAL = 32       # lanes scanned serially per row block
CHUNK_BUDGET = 4 << 30  # bytes of sorted-point working set per window chunk


class _G1Ops:
    coord_dims = 1  # trailing dims per coordinate beyond the limb axis
    padd = staticmethod(pk.padd)
    pdbl = staticmethod(pk.pdbl)
    inf = staticmethod(pk.inf_point)


class _G2Ops:
    coord_dims = 2
    padd = staticmethod(pk.padd_g2)
    pdbl = staticmethod(pk.pdbl_g2)
    inf = staticmethod(pk.inf_point_g2)


def _digits(scalars: torch.Tensor, wbits: int) -> torch.Tensor:
    """int32 [m, 8, n] standard-form limbs -> int64 [m, 256/wbits, n].

    Window i*k + j (k = 32/wbits windows per limb) covers scalar bits
    32i + wbits*j .. 32i + wbits*(j+1) - 1: ascending windows."""
    m, _, n = scalars.shape
    k = 32 // wbits
    x = scalars.to(torch.int64) & 0xFFFFFFFF
    mask = (1 << wbits) - 1
    parts = [(x >> (wbits * j)) & mask for j in range(k)]
    return torch.stack(parts, dim=2).reshape(m, 8 * k, n)


def _fold_sum(pts: torch.Tensor, ops) -> torch.Tensor:
    """Sum points along the last axis (a power of two) by masked shifts."""
    L = pts.shape[-1]
    lane = torch.arange(L, device=pts.device)
    inf = ops.inf(pts.shape[ops.coord_dims + 1 :], pts.device)
    x = pts
    s = 1
    while s < L:
        rolled = torch.roll(x, -s, dims=-1)
        x = ops.padd(x, torch.where(lane + s < L, rolled, inf))
        s *= 2
    return x[..., 0]


def _window_sums(points_flat, digits, ops, nb: int, row_map=None):
    """points_flat [3, (2,), 8, m_pts*n]; digits [m, W, n] in [0, nb), n a
    multiple of SERIAL -> window sums [3, (2,), 8, m, W]."""
    m, W, n = digits.shape
    dev = digits.device
    lead = tuple(points_flat.shape[: ops.coord_dims + 1])
    R = n // SERIAL

    # 1. sort each (msm, window) row by digit, descending
    perm = torch.argsort(digits, dim=-1, descending=True)
    row = torch.arange(m, device=dev) if row_map is None else row_map.to(dev)
    flat_idx = (row[:, None, None] * n + perm).reshape(-1)
    sorted_pts = points_flat.index_select(-1, flat_idx).reshape(lead + (m, W, R, SERIAL))

    # 2a. serial inclusive scan within each 32-lane row
    prev = sorted_pts[..., 0].contiguous()
    scanned = [prev]
    for c in range(1, SERIAL):
        prev = ops.padd(prev, sorted_pts[..., c].contiguous())
        scanned.append(prev)
    within = torch.stack(scanned, dim=-1)  # lead + (m, W, R, SERIAL)
    del sorted_pts, scanned

    # 2b. Hillis-Steele inclusive scan over the R row totals
    t = within[..., SERIAL - 1].contiguous()
    r_lane = torch.arange(R, device=dev)
    r_inf = ops.inf((m, W, R), dev)
    s = 1
    while s < R:
        t = ops.padd(t, torch.where(r_lane >= s, torch.roll(t, s, dims=-1), r_inf))
        s *= 2
    p_excl = torch.cat([ops.inf((m, W, 1), dev), t[..., : R - 1]], dim=-1)

    # 3. histogram -> cnt_k = #{digit >= k}; U[cnt_k - 1] = within + p_excl
    mw = torch.arange(m, device=dev)[:, None, None] * W + torch.arange(W, device=dev)[None, :, None]
    seg = (mw * nb + digits).reshape(-1)
    hist = torch.bincount(seg, minlength=m * W * nb).reshape(m, W, nb)
    cnt = hist.flip(-1).cumsum(-1).flip(-1)  # cnt[d] = #{digit >= d}
    cnt_k = cnt[..., 1:]                      # k = 1 .. nb-1
    pos = (cnt_k - 1).clamp(min=0)
    u_within = within.reshape(lead + (m * W * n,)).index_select(
        -1, (mw * n + pos).reshape(-1)).reshape(lead + (m, W, nb - 1))
    u_rows = p_excl.reshape(lead + (m * W * R,)).index_select(
        -1, (mw * R + pos // SERIAL).reshape(-1)).reshape(lead + (m, W, nb - 1))
    T = ops.padd(u_within, u_rows)
    T = torch.where(cnt_k == 0, ops.inf((m, W, nb - 1), dev), T)

    # 4. S_w = sum_k T_k
    T = torch.cat([T, ops.inf((m, W, 1), dev)], dim=-1)
    return _fold_sum(T, ops)


def _all_window_sums(points, scalars, ops, window_chunk: int, wbits: int, row_map=None):
    """points [3,(2,),8,m_pts,n], scalars [m,8,n] -> [3,(2,),8,m,nw]."""
    m, _, n = scalars.shape
    dev = scalars.device
    m_pts = points.shape[ops.coord_dims + 1]
    nw = 256 // wbits
    lead = tuple(points.shape[: ops.coord_dims + 1])
    if n % SERIAL:
        pad = SERIAL - n % SERIAL
        points = torch.cat([points, ops.inf((m_pts, pad), dev)], dim=-1)
        scalars = torch.nn.functional.pad(scalars, (0, pad))
        n += pad
    points_flat = points.reshape(lead + (m_pts * n,))
    digits = _digits(scalars, wbits)
    C = window_chunk or nw
    sums = [
        _window_sums(points_flat, digits[:, c : c + C].contiguous(), ops, 1 << wbits, row_map)
        for c in range(0, nw, C)
    ]
    return torch.cat(sums, dim=-1)


def _horner(S, ops, wbits: int):
    """Window sums [3,(2,),8,m,nw] -> [3,(2,),8,m]: acc = 2^wbits acc + S_w."""
    nw = S.shape[-1]
    acc = S[..., nw - 1].contiguous()
    for w in range(nw - 2, -1, -1):
        for _ in range(wbits):
            acc = ops.pdbl(acc)
        acc = ops.padd(acc, S[..., w].contiguous())
    return acc


def _msm_impl(points, scalars, ops, window_chunk: int = 0, wbits: int = WINDOW_BITS,
              row_map=None):
    """points [3,(2,),8,m_pts,n], scalars [m,8,n] std-form -> [3,(2,),8,m]."""
    S = _all_window_sums(points, scalars, ops, window_chunk, wbits, row_map)
    return _horner(S, ops, wbits)


def _auto_wbits(n: int) -> int:
    return WINDOW_BITS if n >= SMALL_MSM else 4


def _auto_chunk(m: int, n: int, g2: bool) -> int:
    """Windows per chunk keeping the sorted-point working set in budget."""
    bytes_per_lane = 3 * 8 * 4 * (2 if g2 else 1) * 3  # ~3 live copies
    c = max(1, CHUNK_BUDGET // max(1, m * n * bytes_per_lane))
    for cand in (32, 16, 8, 4, 2, 1):
        if cand <= c:
            return cand
    return 1


def msm_batch_g1(points, scalars, window_chunk: int | None = None, row_map=None):
    """Batched G1 MSM: points [3,8,m_pts,n], scalars [m,8,n] -> [3,8,m]."""
    m, _, n = scalars.shape
    wc = window_chunk or _auto_chunk(m, n, False)
    return _msm_impl(points, scalars, _G1Ops, wc, _auto_wbits(n), row_map)


def msm_batch_g2(points, scalars, window_chunk: int | None = None, row_map=None):
    """Batched G2 MSM: points [3,2,8,m_pts,n], scalars [m,8,n] -> [3,2,8,m]."""
    m, _, n = scalars.shape
    wc = window_chunk or _auto_chunk(m, n, True)
    return _msm_impl(points, scalars, _G2Ops, wc, _auto_wbits(n), row_map)


# ---------------------------------------------------------------------------
# Host-facing wrappers (drop-in for groth16.prover.pippenger_g1 / msm_g2)
# ---------------------------------------------------------------------------


def _scalars(scalars, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(FRK.pack([s % FR for s in scalars], mont=False)).to(device)[None]


def msm_g1_host(points, scalars, device: torch.device):
    """Affine int points + int scalars -> affine int point (or None)."""
    if not points:
        return None
    pts = pk.g1_to_device(points, device)[:, :, None, :]
    acc = msm_batch_g1(pts, _scalars(scalars, device))
    return pk.g1_from_device(acc[..., 0])


def msm_g2_host(points, scalars, device: torch.device):
    if not points:
        return None
    pts = pk.g2_to_device(points, device)[:, :, :, None, :]
    acc = msm_batch_g2(pts, _scalars(scalars, device))
    return pk.g2_from_device(acc[..., 0])
