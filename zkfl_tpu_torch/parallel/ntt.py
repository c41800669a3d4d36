"""NTT over BN254-Fr sharded over a device mesh: the 4-step (Bailey)
decomposition (counterpart of zkfl_tpu/parallel/ntt.py).

Radix-2 stages with per-stage cross-shard exchanges would need log2(D)
collectives; the 4-step scheme needs exactly ONE all_to_all:

    N = n1 * n2, input matrix M[j1, j2] = x[j1*n2 + j2], j2 sharded.
    1. column NTTs (size n1)            — local (each shard owns whole cols)
    2. twiddle by w_N^(k1*j2)           — local (table sharded like M)
    3. transpose via all_to_all         — the one collective
    4. row NTTs (size n2)               — local
    output X[k1 + n1*k2] = Z[k1, k2], un-transposed after the shards.

Each sub-NTT is ops/qap.py's ntt (one K2 butterfly launch a stage), the
twiddle FRK.mont_mul (K1).  Same fr_nth_root convention as groth16/qap.py
(w_N^{n2} = w_{n1}), so the oracle test is direct equality.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from ..field.bn254 import FR, fr_inv, fr_nth_root
from ..field.limbs import N_LIMBS
from ..ops.limb_kernels import FRK
from ..ops.qap import ntt
from .mesh import Mesh, all_to_all


@lru_cache(maxsize=16)
def _twiddle_table(n1: int, n2: int, inverse: bool) -> np.ndarray:
    """int32 [8, n1, n2] Montgomery w_N^(±k1*j2) (numpy, cached)."""
    n = n1 * n2
    w = fr_nth_root(n)
    if inverse:
        w = fr_inv(w)
    rows = []
    for k1 in range(n1):
        wk = pow(w, k1, FR)
        acc = 1
        row = []
        for _ in range(n2):
            row.append(acc)
            acc = acc * wk % FR
        rows.extend(row)
    return FRK.pack(rows).reshape(N_LIMBS, n1, n2)


@lru_cache(maxsize=16)
def _twiddle_shards(n1: int, n2: int, inverse: bool, mesh: Mesh) -> List[torch.Tensor]:
    """_twiddle_table split on its last axis over ``mesh`` (uploaded once)."""
    return mesh.shard(torch.from_numpy(_twiddle_table(n1, n2, inverse)).to(mesh.devices[0]), -1)


def _ntt_axis(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """NTT along the second-to-last axis of [8, B, L, m]."""
    _, B, L, m = x.shape
    xt = x.movedim(2, 3).reshape(N_LIMBS, B * m, L)
    yt = ntt(xt, inverse=inverse)
    return yt.reshape(N_LIMBS, B, m, L).movedim(3, 2)


def _ntt4_local(xs: Sequence[torch.Tensor], tws: Sequence[torch.Tensor],
                inverse: bool) -> List[torch.Tensor]:
    """Shards x [8, B, n1, n2/D] and tw [8, n1, n2/D] -> shards
    [8, B, n1/D, n2] holding X[k1 + n1*k2] at [k1, k2] (k1 sharded)."""
    ys = []
    for x, tw in zip(xs, tws):
        _, B, n1, n2_loc = x.shape
        # 1. column NTTs (size n1), local
        y = _ntt_axis(x, inverse)
        # 2. twiddle w^(k1 * j2)
        ys.append(FRK.mont_mul(
            y.reshape(N_LIMBS, -1),
            tw[:, None].expand(N_LIMBS, B, n1, n2_loc).reshape(N_LIMBS, -1),
        ).reshape(N_LIMBS, B, n1, n2_loc))
    # 3. transpose: the shard moves from j2 to k1 (ONE all_to_all)
    zs = all_to_all(ys, split_dim=2, concat_dim=3)  # each [8, B, n1/D, n2]
    # 4. row NTTs (size n2), local
    out = []
    for z in zs:
        _, B, n1_loc, n2 = z.shape
        out.append(ntt(z.reshape(N_LIMBS, B * n1_loc, n2), inverse=inverse)
                   .reshape(N_LIMBS, B, n1_loc, n2))
    return out


def make_ntt_sharded(mesh: Mesh, n: int, batch: int, axis: str = "tp",
                     inverse: bool = False, n1: int | None = None):
    """Sharded NTT: x [8, B, n] -> [8, B, n] in standard order on the mesh's
    first device.  n = n1*n2 with both multiples of the axis size."""
    D = mesh.shape[axis]
    if n1 is None:
        n1 = 1 << ((n.bit_length() - 1) // 2)
        n1 = max(n1, D)
    n2 = n // n1
    assert n1 % D == 0 and n2 % D == 0, (n1, n2, D)

    def fn(x: torch.Tensor) -> torch.Tensor:
        mat = x.reshape(N_LIMBS, batch, n1, n2)
        zs = _ntt4_local(mesh.shard(mat, 3), _twiddle_shards(n1, n2, inverse, mesh),
                         inverse)
        z = torch.cat([s.to(mesh.devices[0]) for s in zs], dim=2)  # [8, B, n1, n2]
        return z.movedim(2, 3).reshape(N_LIMBS, batch, n)

    return fn


def ntt_sharded(x: torch.Tensor, mesh: Mesh, axis: str = "tp", inverse: bool = False) -> torch.Tensor:
    """Sharded NTT on [8, B, n] Montgomery limb tensors."""
    _, B, n = x.shape
    return make_ntt_sharded(mesh, n, B, axis, inverse)(x)
