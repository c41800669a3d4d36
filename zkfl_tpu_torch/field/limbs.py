"""Limb layout of the port and its host-side packing (numpy only).

An element is 8 x 32-bit little-endian limbs, limb-major ``[..., 8, L]``,
usually in Montgomery form with R = 2^256 — the same representative integer
as zkfl_tpu's 16 x 16-bit layout, so values compare as integers across the
two packages.  Limbs are stored as the bit patterns of ``int32`` (torch has
no usable uint32 arithmetic); kernels read them as ``uint32``.

These converters replace ``PallasField.pack``/``unpack``
(zkfl_tpu/ops/limb_kernels.py:577-596) without importing them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from .bn254 import FQ, FR

N_LIMBS = 8
LIMB_BITS = 32
R = 1 << (N_LIMBS * LIMB_BITS)


@dataclass(frozen=True)
class FieldConsts:
    p: int
    name: str

    @cached_property
    def mont_r(self) -> int:
        return R % self.p

    @cached_property
    def mont_r2(self) -> int:
        return R * R % self.p

    @cached_property
    def n_prime(self) -> int:
        """-p^-1 mod R."""
        return (-pow(self.p, -1, R)) % R


FR_CONSTS = FieldConsts(FR, "fr")
FQ_CONSTS = FieldConsts(FQ, "fq")


def ints_to_limbs(xs) -> np.ndarray:
    """Integers in [0, 2^256) -> int32 [8, n] limb-major bit patterns."""
    xs = list(xs)
    if not xs:
        return np.zeros((N_LIMBS, 0), dtype=np.int32)
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    u32 = np.frombuffer(buf, dtype="<u4").reshape(len(xs), N_LIMBS)
    return u32.T.copy().view(np.int32)  # a copy: torch.from_numpy needs it writable


def limbs_to_ints(arr) -> list:
    """[..., 8, n] limbs -> flat list of ints (leading dims, then lanes)."""
    a = np.ascontiguousarray(np.moveaxis(np.asarray(arr), -2, -1))
    data = a.astype("<u4", copy=False).view(np.uint32).reshape(-1, N_LIMBS).tobytes()
    return [int.from_bytes(data[i : i + 32], "little") for i in range(0, len(data), 32)]


def to_u16_limbs(arr) -> np.ndarray:
    """[..., 8, n] int32 -> zkfl_tpu's uint32 [..., 16, n] of 16-bit limbs."""
    u = np.asarray(arr).view(np.uint32)
    lo, hi = u & 0xFFFF, u >> 16
    out = np.stack([lo, hi], axis=-2)  # [..., 8, 2, n]
    return out.reshape(u.shape[:-2] + (2 * N_LIMBS, u.shape[-1]))


def from_u16_limbs(arr) -> np.ndarray:
    """zkfl_tpu's uint32 [..., 16, n] -> int32 [..., 8, n]."""
    a = np.asarray(arr).astype(np.uint32)
    words = a[..., 0::2, :] | (a[..., 1::2, :] << 16)
    return np.ascontiguousarray(words).view(np.int32)
