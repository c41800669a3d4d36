"""G1/G2 point ops on limb-major tensors (counterpart of
zkfl_tpu/ops/point_kernels.py).

Layouts (int32 bit patterns of uint32 limbs, Fq Montgomery form):
  G1 point batch: [3, 8, *B]     (X:Y:Z projective)
  G2 point batch: [3, 2, 8, *B]  (Fq2 coordinates c0 + c1*u)
The identity is (0:1:0).

G1 ``padd``/``pdbl`` run the K4 kernel (csrc/g1_point.cu) on CUDA tensors,
counted as ``g1.padd``/``g1.pdbl``, and their plain torch versions on CPU
tensors.  G2 ops are composed of ``FQK`` ops with Karatsuba lane-stacking,
as in zkfl_tpu (point_kernels.py:237-340): a fused Fq2 kernel is later work.
"""

from __future__ import annotations

import numpy as np
import torch

from zkfl_tpu.field.bn254 import FQ
from zkfl_tpu.field.curve import TWIST_B

from .. import backend
from ..field.limbs import N_LIMBS, limbs_to_ints
from .limb_kernels import FQK, join16, on_cpu, split16

_B3_G1 = 9 * FQK.mont_r % FQ  # 3*b (b = 3), Montgomery form
_B3_G2 = (
    3 * TWIST_B.coeffs[0] % FQ * FQK.mont_r % FQ,
    3 * TWIST_B.coeffs[1] % FQ * FQK.mont_r % FQ,
)


def _flatten(x: torch.Tensor, coord_dims: int):
    """[3, (2,), 8, *B] -> contiguous [3, (2,), 8, M] and the batch shape."""
    lead = tuple(x.shape[: coord_dims + 1])
    batch = tuple(x.shape[coord_dims + 1 :])
    m = int(np.prod(batch, dtype=np.int64))
    return x.contiguous().reshape(lead + (m,)), batch


def _check_g1(*pts: torch.Tensor) -> None:
    for t in pts:
        if t.dtype != torch.int32 or tuple(t.shape[:2]) != (3, N_LIMBS):
            raise ValueError(f"expected int32 [3, 8, ...] G1 points, got {t.dtype} {tuple(t.shape)}")
    if len({tuple(t.shape) for t in pts}) != 1:
        raise ValueError("G1 operands differ in shape")


# ---------------------------------------------------------------------------
# G1 plain versions: RCB15 algorithms 7 and 9 on 16-bit-limb int64 tensors,
# the formula's independent multiplies stacked into one call per stage.
# ---------------------------------------------------------------------------


def _st(*xs):
    return torch.stack(xs, dim=1)


def padd_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    F = FQK.plain
    x1, y1, z1 = (split16(p[i]) for i in range(3))
    x2, y2, z2 = (split16(q[i]) for i in range(3))
    l1 = F.add(_st(x1, y1, x1), _st(y1, z1, z1))  # x1+y1, y1+z1, x1+z1
    l2 = F.add(_st(x2, y2, x2), _st(y2, z2, z2))
    m1 = F.mont_mul(_st(x1, y1, z1, l1[:, 0], l1[:, 1], l1[:, 2]),
                    _st(x2, y2, z2, l2[:, 0], l2[:, 1], l2[:, 2]))
    t0, t1, t2, p3, p4, p5 = (m1[:, i] for i in range(6))
    a2 = F.add(_st(t0, t1, t0, t0), _st(t1, t2, t2, t0))
    s1 = F.sub(_st(p3, p4, p5), a2[:, :3])
    t3, t4, y3 = s1[:, 0], s1[:, 1], s1[:, 2]    # X1Y2+X2Y1, Y1Z2+Y2Z1, X1Z2+X2Z1
    t00 = F.add(a2[:, 3], t0)                    # 3 X1X2
    m2 = F.mont_mul_int(_st(t2, y3), _B3_G1)
    t2b, y3b = m2[:, 0], m2[:, 1]                # b3 Z1Z2, b3 (X1Z2+X2Z1)
    z3a = F.add(t1, t2b)                         # Y1Y2 + b3 Z1Z2
    t1b = F.sub(t1, t2b)                         # Y1Y2 - b3 Z1Z2
    m3 = F.mont_mul(_st(t3, t4, t1b, y3b, z3a, t00), _st(t1b, y3b, z3a, t00, t4, t3))
    x3 = F.sub(m3[:, 0], m3[:, 1])
    yz = F.add(m3[:, 2:6:2], m3[:, 3:6:2])       # y3, z3
    return torch.stack([join16(x3), join16(yz[:, 0]), join16(yz[:, 1])])


def pdbl_plain(p: torch.Tensor) -> torch.Tensor:
    F = FQK.plain
    x, y, z = (split16(p[i]) for i in range(3))
    m1 = F.mont_mul(_st(y, y, z, x), _st(y, z, z, y))
    t0, t1, zz, xy = (m1[:, i] for i in range(4))
    z3 = F.add(t0, t0)
    z3 = F.add(z3, z3)
    z3 = F.add(z3, z3)                           # 8 Y^2
    t2 = F.mont_mul_int(zz, _B3_G1)              # b3 Z^2
    y3 = F.add(t0, t2)
    t2s = F.add(F.add(t2, t2), t2)               # 3 b3 Z^2
    t0s = F.sub(t0, t2s)
    m2 = F.mont_mul(_st(t2, t1, t0s, t0s), _st(z3, z3, y3, xy))
    x3a, z3f, y3a, x3h = (m2[:, i] for i in range(4))
    y3f = F.add(x3a, y3a)
    x3f = F.add(x3h, x3h)
    return torch.stack([join16(x3f), join16(y3f), join16(z3f)])


# ---------------------------------------------------------------------------
# G1 public ops
# ---------------------------------------------------------------------------


def padd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete G1 addition on [3, 8, *B] points."""
    _check_g1(p, q)
    if on_cpu(p, q):
        return padd_plain(p, q)
    pf, batch = _flatten(p, 1)
    qf, _ = _flatten(q, 1)
    out = torch.empty_like(pf)
    backend.launch("zk_g1_padd", "g1.padd", pf.data_ptr(), qf.data_ptr(),
                   out.data_ptr(), pf.shape[-1], backend.stream(pf.device))
    return out.reshape((3, N_LIMBS) + batch)


def pdbl(p: torch.Tensor) -> torch.Tensor:
    """Complete G1 doubling on [3, 8, *B] points."""
    _check_g1(p)
    if on_cpu(p):
        return pdbl_plain(p)
    pf, batch = _flatten(p, 1)
    out = torch.empty_like(pf)
    backend.launch("zk_g1_pdbl", "g1.pdbl", pf.data_ptr(), out.data_ptr(),
                   pf.shape[-1], backend.stream(pf.device))
    return out.reshape((3, N_LIMBS) + batch)


def inf_point(batch, device: torch.device) -> torch.Tensor:
    """Identity (0:1:0) as [3, 8, *batch]."""
    batch = tuple(batch)
    pt = torch.zeros((3, N_LIMBS) + batch, dtype=torch.int32, device=device)
    pt[1] = FQK.one_mont(device).reshape((N_LIMBS,) + (1,) * len(batch))
    return pt


def select(mask: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """mask bool, broadcastable to *B: p where mask else q."""
    return torch.where(mask, p, q)


# ---------------------------------------------------------------------------
# G2 ops — [3, 2, 8, *B], Fq2 arithmetic through lane-stacked FQK ops
# ---------------------------------------------------------------------------


def _fq2_mul_many(pairs):
    """pairs of ([2, 8, L], [2, 8, L]) -> products; Karatsuba over u^2 = -1,
    every pair's three Fq multiplies in ONE FQK.mont_mul call."""
    k = len(pairs)
    a0 = torch.cat([a[0] for a, _ in pairs], -1)
    a1 = torch.cat([a[1] for a, _ in pairs], -1)
    b0 = torch.cat([b[0] for _, b in pairs], -1)
    b1 = torch.cat([b[1] for _, b in pairs], -1)
    sums = FQK.add(torch.cat([a0, b0], -1), torch.cat([a1, b1], -1))
    n = a0.shape[-1]
    prod = FQK.mont_mul(torch.cat([a0, a1, sums[:, :n]], -1), torch.cat([b0, b1, sums[:, n:]], -1))
    t0, t1, t2 = prod[:, :n], prod[:, n : 2 * n], prod[:, 2 * n :]
    c0 = FQK.sub(t0, t1)                   # a0b0 - a1b1
    c1 = FQK.sub(t2, FQK.add(t0, t1))      # (a0+a1)(b0+b1) - a0b0 - a1b1
    L = n // k
    return [torch.stack([c0[:, i * L : (i + 1) * L], c1[:, i * L : (i + 1) * L]]) for i in range(k)]


def _fq2_add(a, b):
    s = FQK.add(torch.cat([a[0], a[1]], -1), torch.cat([b[0], b[1]], -1))
    return s.reshape(N_LIMBS, 2, -1).transpose(0, 1)


def _fq2_sub(a, b):
    s = FQK.sub(torch.cat([a[0], a[1]], -1), torch.cat([b[0], b[1]], -1))
    return s.reshape(N_LIMBS, 2, -1).transpose(0, 1)


def _fq2_b3(L: int, device: torch.device) -> torch.Tensor:
    c = torch.from_numpy(FQK.pack(list(_B3_G2), mont=False)).to(device)  # [8, 2]
    return c.t().reshape(2, N_LIMBS, 1).expand(2, N_LIMBS, L)


def padd_g2(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete G2 addition (RCB15 alg. 7 over Fq2) on [3, 2, 8, *B]."""
    pf, batch = _flatten(p, 2)
    qf, _ = _flatten(q, 2)
    x1, y1, z1 = pf[0], pf[1], pf[2]
    x2, y2, z2 = qf[0], qf[1], qf[2]
    b3 = _fq2_b3(x1.shape[-1], p.device)
    t0, t1, t2, p3, p4, p5 = _fq2_mul_many([
        (x1, x2), (y1, y2), (z1, z2),
        (_fq2_add(x1, y1), _fq2_add(x2, y2)),
        (_fq2_add(y1, z1), _fq2_add(y2, z2)),
        (_fq2_add(x1, z1), _fq2_add(x2, z2)),
    ])
    t3 = _fq2_sub(p3, _fq2_add(t0, t1))
    t4 = _fq2_sub(p4, _fq2_add(t1, t2))
    y3 = _fq2_sub(p5, _fq2_add(t0, t2))
    t00 = _fq2_add(_fq2_add(t0, t0), t0)
    t2b, y3b = _fq2_mul_many([(b3, t2), (b3, y3)])
    z3a = _fq2_add(t1, t2b)
    t1b = _fq2_sub(t1, t2b)
    m3 = _fq2_mul_many([(t3, t1b), (t4, y3b), (t1b, z3a), (t00, y3b), (z3a, t4), (t00, t3)])
    x3 = _fq2_sub(m3[0], m3[1])
    y3f = _fq2_add(m3[2], m3[3])
    z3f = _fq2_add(m3[4], m3[5])
    return torch.stack([x3, y3f, z3f]).reshape((3, 2, N_LIMBS) + batch)


def pdbl_g2(p: torch.Tensor) -> torch.Tensor:
    """Complete G2 doubling (RCB15 alg. 9 over Fq2) on [3, 2, 8, *B]."""
    pf, batch = _flatten(p, 2)
    x, y, z = pf[0], pf[1], pf[2]
    b3 = _fq2_b3(x.shape[-1], p.device)
    t0, t1, zz, xy = _fq2_mul_many([(y, y), (y, z), (z, z), (x, y)])
    z3 = _fq2_add(t0, t0)
    z3 = _fq2_add(z3, z3)
    z3 = _fq2_add(z3, z3)
    (t2,) = _fq2_mul_many([(b3, zz)])
    y3 = _fq2_add(t0, t2)
    t2s = _fq2_add(_fq2_add(t2, t2), t2)
    t0s = _fq2_sub(t0, t2s)
    x3a, z3f, y3a, x3h = _fq2_mul_many([(t2, z3), (t1, z3), (t0s, y3), (t0s, xy)])
    y3f = _fq2_add(x3a, y3a)
    x3f = _fq2_add(x3h, x3h)
    return torch.stack([x3f, y3f, z3f]).reshape((3, 2, N_LIMBS) + batch)


def inf_point_g2(batch, device: torch.device) -> torch.Tensor:
    batch = tuple(batch)
    pt = torch.zeros((3, 2, N_LIMBS) + batch, dtype=torch.int32, device=device)
    pt[1, 0] = FQK.one_mont(device).reshape((N_LIMBS,) + (1,) * len(batch))
    return pt


def select_g2(mask: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, p, q)


# ---------------------------------------------------------------------------
# Host converters
# ---------------------------------------------------------------------------


def g1_to_device(points, device: torch.device) -> torch.Tensor:
    """Affine int pairs (None = identity) -> [3, 8, n] Montgomery limbs.

    The host packs standard-form limbs; the Montgomery conversion runs on
    the device (FQK.to_mont), as in zkfl_tpu."""
    xs = [0 if p is None else p[0] % FQ for p in points]
    ys = [1 if p is None else p[1] % FQ for p in points]
    zs = [0 if p is None else 1 for p in points]
    std = np.concatenate([FQK.pack(v, mont=False) for v in (xs, ys, zs)], axis=1)  # [8, 3n]
    n = len(points)
    mont = FQK.to_mont(torch.from_numpy(std).to(device))
    return mont.reshape(N_LIMBS, 3, n).transpose(0, 1).contiguous()


def g2_to_device(points, device: torch.device) -> torch.Tensor:
    """Affine Fq2 pairs ((x0,x1),(y0,y1)) or None -> [3, 2, 8, n]."""

    def coeffs(p, idx, default):
        if p is None:
            return default
        c = p[idx].coeffs if hasattr(p[idx], "coeffs") else p[idx]
        return (c[0] % FQ, c[1] % FQ)

    xs = [coeffs(p, 0, (0, 0)) for p in points]
    ys = [coeffs(p, 1, (1, 0)) for p in points]
    zs = [(0, 0) if p is None else (1, 0) for p in points]
    parts = [FQK.pack([v[j] for v in cs], mont=False) for cs in (xs, ys, zs) for j in range(2)]
    n = len(points)
    mont = FQK.to_mont(torch.from_numpy(np.concatenate(parts, axis=1)).to(device))  # [8, 6n]
    return mont.reshape(N_LIMBS, 6, n).transpose(0, 1).reshape(3, 2, N_LIMBS, n).contiguous()


def _fq_ints(arr) -> list:
    """[..., 8, k] Montgomery limbs -> standard-form ints."""
    r_inv = pow(FQK.mont_r, -1, FQ)
    return [v * r_inv % FQ for v in limbs_to_ints(arr)]


def g1_from_device(pt) -> tuple | None:
    """[3, 8] (or [3, 8, 1]) projective -> affine int pair (None = identity)."""
    arr = pt.detach().cpu().numpy() if isinstance(pt, torch.Tensor) else np.asarray(pt)
    x, y, z = _fq_ints(arr.reshape(3, N_LIMBS, 1))
    if z == 0:
        return None
    zinv = pow(z, -1, FQ)
    return (x * zinv % FQ, y * zinv % FQ)


def g2_from_device(pt):
    """[3, 2, 8] (or [3, 2, 8, 1]) projective -> affine (FQ2, FQ2) or None."""
    from zkfl_tpu.field.tower import FQ2

    arr = pt.detach().cpu().numpy() if isinstance(pt, torch.Tensor) else np.asarray(pt)
    c = _fq_ints(arr.reshape(3, 2, N_LIMBS, 1))
    x, y, z = (FQ2([c[2 * i], c[2 * i + 1]]) for i in range(3))
    if z.is_zero():
        return None
    zi = z.inv()
    return (x * zi, y * zi)
