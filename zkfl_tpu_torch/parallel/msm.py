"""MSM with the points sharded over a device mesh (intra-proof tensor
parallelism; counterpart of zkfl_tpu/parallel/msm.py).

  * points + scalars are split on the "points" axis; each shard runs the
    sort + prefix-scan Pippenger window sums of ops/msm.py on its local
    slice, producing its window sums S^(d) [3, (2,), 8, m, n_windows] — a
    few KB.
  * ONE all_gather collects them on the mesh's first device; _fold_sum over
    the device axis adds them (point addition is no ring op a reduce could
    take, so gather + fold is the collective).
  * The Horner ladder runs once, on the gathered result: O(254) point ops,
    small next to the O(n / D) local work.

The "clients" axis (data parallelism over independent per-client proofs)
lives in groth16/device_prover.py DeviceProver.msm_results_many(mesh=...).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops import msm
from ..ops import point_kernels as pk
from .mesh import Mesh, all_gather


def _sharded_msm_local(points: Sequence[torch.Tensor], scalars: Sequence[torch.Tensor], ops,
                       wbits: int, window_chunk: int, row_map=None) -> torch.Tensor:
    """Per-shard points [3,(2,),8,m_pts,n_local] and scalars [m,8,n_local]
    (shard d on its device) -> [3,(2,),8,m] on the first shard's device:
    local Pippenger window sums, one all_gather, fold, Horner."""
    S_local = [
        msm._all_window_sums(p, s, ops, window_chunk, wbits,
                             None if row_map is None else row_map.to(s.device))
        for p, s in zip(points, scalars)
    ]
    parts = all_gather(S_local, scalars[0].device)  # [D, 3,(2,),8,m,nw]
    # devices to the last axis; fold with the shared masked-shift reduction
    S = msm._fold_sum(parts.movedim(0, -1), ops)
    return msm._horner(S, ops, wbits)


def make_sharded_msm(mesh: Mesh, axis_name: str = "points", wbits: int = msm.WINDOW_BITS,
                     g2: bool = False):
    """The sharded MSM over ``mesh`` (points on ``axis_name``): a callable
    taking points [3,(2,),8,m_pts,n] and scalars [m,8,n] (n a multiple of
    the axis size), returning [3,(2,),8,m] on the mesh's first device."""
    D = mesh.shape[axis_name]
    ops = msm._G2Ops if g2 else msm._G1Ops

    def fn(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
        n_local = scalars.shape[-1] // D
        chunk = msm._auto_chunk(scalars.shape[0], n_local, g2)
        return _sharded_msm_local(mesh.shard(points, -1), mesh.shard(scalars, -1), ops,
                                  wbits, chunk)

    return fn


def msm_g1_sharded(points, scalars, mesh: Mesh, axis_name: str = "points"):
    """Host-facing sharded G1 MSM: affine int points + int scalars ->
    affine int point.  Pads to a multiple of (axis size * 32) so every shard
    gets an equal slice aligned to the scan block."""
    if not points:
        return None
    ndev = mesh.shape[axis_name]
    n = len(points)
    step = ndev * 32
    m = -(-n // step) * step
    points = list(points) + [None] * (m - n)
    scalars = list(scalars) + [0] * (m - n)
    dev = mesh.devices[0]
    dev_pts = pk.g1_to_device(points, dev)[:, :, None, :]  # [3,8,1,m]
    sc = msm._scalars(scalars, dev)                         # [1,8,m]
    fn = make_sharded_msm(mesh, axis_name, msm._auto_wbits(m // ndev))
    return pk.g1_from_device(fn(dev_pts, sc)[..., 0])
