"""Fixed-base batches of the Groth16 trusted setup on a torch device
(counterpart of zkfl_tpu/groth16/device_setup.py).

The pure-Python windowed ladder (groth16/setup.py FixedBaseG1/FixedBaseG2)
spends up to 32 Python point additions on every scalar, about 1.6 M G1 and
0.36 M G2 scalars at the production dimensions.  Here the per-window
multiples table
T[w][d] = d * 2^(8w) * G (32 windows x 256 entries) is built once on the
host and uploaded once per device, and a batch of scalars becomes one
gather of a table point per window and scalar, then ``ops/msm.py``
``_fold_sum`` over the 32 windows: five levels of ``padd`` (K4 for G1, K6
for G2 on a CUDA device; their plain torch versions on the CPU).

The affine conversion back to the host uses Montgomery's batch-inversion
trick for G1 (one modular inverse per chunk) and one Fq2 inversion per
point for G2, as in zkfl_tpu.  Replaces the snarkjs setup/zkey pipeline's
encryption loops (full_system_simulation.mjs:713-736).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from ..field.bn254 import FQ
from ..field.curve import (
    G2_JAC_INF,
    g1_add_jac,
    g1_double_jac,
    g1_from_jacobian,
    g1_generator,
    g1_to_jacobian,
    g2_add_jac,
    g2_double_jac,
    g2_from_jacobian,
    g2_generator,
    g2_to_jacobian,
)
from ..field.tower import FQ2
from ..ops import point_kernels as pk
from ..ops.limb_kernels import FQK, FRK
from ..ops.msm import _fold_sum, _G1Ops, _G2Ops

WINDOW = 8
N_WINDOWS = 32
TABLE = 1 << WINDOW
G1_CHUNK = 1 << 17
G2_CHUNK = 1 << 16


def _table_rows(generator, to_jac, add_jac, double_jac, from_jac, inf_jac) -> list:
    """Affine entries (w, d) = d * 2^(8w) * G, row w*256 + d (None for d = 0)."""
    rows: List[Optional[tuple]] = []
    cur = to_jac(generator())
    for _ in range(N_WINDOWS):
        acc = inf_jac
        rows.append(None)
        for _ in range(TABLE - 1):
            acc = add_jac(acc, cur)
            rows.append(from_jac(acc))
        for _ in range(WINDOW):
            cur = double_jac(cur)
    return rows


@lru_cache(maxsize=1)
def _g1_rows() -> list:
    return _table_rows(g1_generator, g1_to_jacobian, g1_add_jac, g1_double_jac,
                       g1_from_jacobian, (1, 1, 0))


@lru_cache(maxsize=1)
def _g2_rows() -> list:
    return _table_rows(g2_generator, g2_to_jacobian, g2_add_jac, g2_double_jac,
                       g2_from_jacobian, G2_JAC_INF)


@lru_cache(maxsize=None)
def _g1_table(device: torch.device) -> torch.Tensor:
    """[3, 8, 32*256] Montgomery table on ``device`` (uploaded once)."""
    return pk.g1_to_device(_g1_rows(), device)


@lru_cache(maxsize=None)
def _g2_table(device: torch.device) -> torch.Tensor:
    """[3, 2, 8, 32*256] Montgomery table on ``device`` (uploaded once)."""
    return pk.g2_to_device(_g2_rows(), device)


def _digit_indices(scalars: List[int]) -> np.ndarray:
    """int64 [32, n] gather indices w*256 + digit_w(scalar).

    Window 4i + j is byte j of the port's 32-bit limb i: the same ascending
    order as zkfl_tpu's lo/hi bytes of its 16-bit limbs."""
    limbs = FRK.pack(scalars, mont=False)  # int32 [8, n], standard form
    n = limbs.shape[1]
    digits = limbs.view(np.uint8).reshape(8, n, 4).transpose(0, 2, 1).reshape(N_WINDOWS, n)
    return digits.astype(np.int64) + (np.arange(N_WINDOWS, dtype=np.int64) * TABLE)[:, None]


def _fixed_mul(table: torch.Tensor, idx: torch.Tensor, ops) -> torch.Tensor:
    """Gather indices [32, n] (``_digit_indices``) -> projective s * G for
    each scalar, [3, (2,), 8, n] Montgomery."""
    n = idx.shape[1]
    lead = tuple(table.shape[:-1])
    pts = table.index_select(-1, idx.reshape(-1)).reshape(lead + (N_WINDOWS, n))
    # windows to the last axis, the one _fold_sum reduces
    return _fold_sum(pts.transpose(-1, -2), ops)


def _batch_affine(xs, ys, zs) -> List[Optional[tuple]]:
    """Projective int coords -> affine pairs via one batched inversion."""
    n = len(zs)
    out: List[Optional[tuple]] = [None] * n
    # Montgomery's trick over the nonzero z's
    idxs = [i for i in range(n) if zs[i] != 0]
    if not idxs:
        return out
    prefix = []
    acc = 1
    for i in idxs:
        prefix.append(acc)
        acc = acc * zs[i] % FQ
    inv = pow(acc, -1, FQ)
    for j in range(len(idxs) - 1, -1, -1):
        i = idxs[j]
        zi = inv * prefix[j] % FQ
        inv = inv * zs[i] % FQ
        out[i] = (xs[i] * zi % FQ, ys[i] * zi % FQ)
    return out


def batch_fixed_mul_g1(scalars: List[int], device: torch.device,
                       chunk: int = G1_CHUNK) -> List[Optional[tuple]]:
    """[s * G1 for s in scalars] -> affine host pairs (None for s = 0)."""
    table = _g1_table(torch.device(device))
    out: List[Optional[tuple]] = []
    for c0 in range(0, len(scalars), chunk):
        idx = torch.from_numpy(_digit_indices(scalars[c0 : c0 + chunk])).to(table.device)
        res = _fixed_mul(table, idx, _G1Ops).cpu().numpy()
        out.extend(_batch_affine(FQK.unpack(res[0]), FQK.unpack(res[1]), FQK.unpack(res[2])))
    return out


def batch_fixed_mul_g2(scalars: List[int], device: torch.device, chunk: int = G2_CHUNK) -> list:
    """[s * G2 for s in scalars] -> affine (FQ2, FQ2) pairs (None for 0)."""
    table = _g2_table(torch.device(device))
    out = []
    for c0 in range(0, len(scalars), chunk):
        batch = scalars[c0 : c0 + chunk]
        idx = torch.from_numpy(_digit_indices(batch)).to(table.device)
        res = _fixed_mul(table, idx, _G2Ops).cpu().numpy()
        coords = [[FQK.unpack(res[i, j]) for j in range(2)] for i in range(3)]
        for i in range(len(batch)):
            z = FQ2([coords[2][0][i], coords[2][1][i]])
            if z.is_zero():
                out.append(None)
                continue
            zi = z.inv()
            x = FQ2([coords[0][0][i], coords[0][1][i]]) * zi
            y = FQ2([coords[1][0][i], coords[1][1][i]]) * zi
            out.append((x, y))
    return out
