"""BN254 Fr/Fq field ops on limb-major ``int32 [8, *batch]`` tensors.

``TorchField`` mirrors the public ops of ``PallasField``
(zkfl_tpu/ops/limb_kernels.py:480-575).  Each op has two versions with the
same signature:

* the kernel (csrc/field_ew.cu, ntt_butterfly.cu, normalize_raw.cu), run for
  CUDA tensors and counted in ``backend.LAUNCHES`` as ``"<field>.<op>"``;
* a plain torch version, ``<op>_plain``, run for CPU tensors and used on the
  card to check the kernel.

A CUDA tensor always goes to the kernel (a failed build or launch raises);
only a CPU tensor takes the plain version.

The plain versions widen to int64 and compute on 16 limbs of 16 bits
(``[16, *batch]``), so every partial product and column sum fits.  Inputs are
canonical (< p) and outputs canonical, so results equal the kernels' and
zkfl_tpu's as integers.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import backend
from ..field.limbs import FQ_CONSTS, FR_CONSTS, N_LIMBS, FieldConsts, ints_to_limbs, limbs_to_ints

M16 = 0xFFFF
_OPS = {
    "mont_mul": 0, "add": 1, "sub": 2, "to_mont": 3, "from_mont": 4,
    "mont_mul_const": 5, "mul_sub_mul_const": 6,
}


# ---------------------------------------------------------------------------
# Plain arithmetic on int64 [n, *batch] tensors of 16-bit limbs
# ---------------------------------------------------------------------------


def split16(a: torch.Tensor) -> torch.Tensor:
    """int32 [8, *B] -> int64 [16, *B] of 16-bit limbs."""
    x = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([x & M16, x >> 16], dim=1).reshape((16,) + tuple(x.shape[1:]))


def join16(x: torch.Tensor) -> torch.Tensor:
    """int64 [16, *B] of 16-bit limbs -> int32 [8, *B] bit patterns."""
    v = x[0::2] | (x[1::2] << 16)
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32)


def _const16(value: int, like: torch.Tensor) -> torch.Tensor:
    """A constant as [16, 1, ...] int64 limbs broadcastable against ``like``."""
    limbs = [(value >> (16 * i)) & M16 for i in range(16)]
    t = torch.tensor(limbs, dtype=torch.int64, device=like.device)
    return t.reshape((16,) + (1,) * (like.dim() - 1))


def _carry(x: torch.Tensor) -> torch.Tensor:
    """Nonnegative raw limbs -> 16-bit limbs of the value mod 2^(16 n).
    Consumes ``x`` (updated in place)."""
    while True:
        hi = x >> 16
        if not bool(hi[:-1].any()):
            return x.bitwise_and_(M16)
        x.bitwise_and_(M16)
        x[1:] += hi[:-1]


def _carry_signed(x: torch.Tensor) -> torch.Tensor:
    """Signed raw limbs -> limbs 0..n-2 in [0, 2^16), the top limb signed.
    Consumes ``x`` (updated in place)."""
    while True:
        hi = x[:-1] >> 16  # floor division, also for negative limbs
        if not bool(hi.any()):
            return x
        x[:-1].bitwise_and_(M16)
        x[1:] += hi


def _mul_cols(a: torch.Tensor, b: torch.Tensor, n_out: int) -> torch.Tensor:
    """Column sums of the schoolbook product a*b, truncated to n_out limbs.

    Each partial product is < 2^32 and a column holds at most 16, so the raw
    columns stay below 2^36."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    out = torch.zeros((n_out,) + tuple(batch), dtype=torch.int64, device=a.device)
    for i in range(min(16, n_out)):
        w = min(16, n_out - i)
        out[i : i + w].addcmul_(a[i : i + 1], b[:w])
    return out


def _zeros_like_limbs(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + tuple(x.shape[1:]), dtype=torch.int64, device=x.device)


class PlainField:
    """Montgomery arithmetic of one modulus on 16-bit-limb int64 tensors."""

    def __init__(self, consts: FieldConsts):
        self.c = consts

    def cond_sub(self, u: torch.Tensor) -> torch.Tensor:
        """u - p when u >= p, else u (u < 2p, canonical limbs)."""
        d = _carry_signed(torch.cat([u - _const16(self.c.p, u), _zeros_like_limbs(u, 1)]))
        return torch.where(d[16] >= 0, d[:16], u)

    def mont_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """t [32, *B] carried, t < p*R -> t * R^-1 mod p, canonical."""
        m = _carry(_mul_cols(t[:16], _const16(self.c.n_prime, t), 16))
        s = _carry(t + _mul_cols(m, _const16(self.c.p, t), 32))  # < 2pR < 2^512
        return self.cond_sub(s[16:])

    def mont_mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.mont_reduce(_carry(_mul_cols(a, b, 32)))

    def mont_mul_int(self, a: torch.Tensor, k: int) -> torch.Tensor:
        return self.mont_reduce(_carry(_mul_cols(a, _const16(k, a), 32)))

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cond_sub(_carry(a + b))  # < 2p < 2^255: no carry out

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d = _carry_signed(torch.cat([a - b, _zeros_like_limbs(a, 1)]))
        return torch.where(d[16] < 0, _carry(d[:16] + _const16(self.c.p, a)), d[:16])

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mont_reduce(torch.cat([a, _zeros_like_limbs(a, 16)]))


# ---------------------------------------------------------------------------
# TorchField: kernel wrappers + plain versions
# ---------------------------------------------------------------------------


def _lanes(x: torch.Tensor):
    """[8, *B] -> contiguous [8, L] and the batch shape."""
    batch = tuple(x.shape[1:])
    return x.contiguous().reshape(x.shape[0], int(np.prod(batch, dtype=np.int64))), batch


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor is on the CPU, False when all are on one CUDA
    device; anything else is an error."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(t: torch.Tensor, dtype=torch.int32, limbs: int = N_LIMBS) -> None:
    if t.dtype != dtype or t.dim() < 1 or t.shape[0] != limbs:
        raise ValueError(f"expected {dtype} [{limbs}, ...], got {t.dtype} {tuple(t.shape)}")


class TorchField:
    """Per-modulus field ops on int32 [8, *batch] limb-major tensors."""

    def __init__(self, consts: FieldConsts, field_id: int):
        self.c = consts
        self.p = consts.p
        self.name = consts.name
        self.mont_r = consts.mont_r
        self.mont_r2 = consts.mont_r2
        self.field_id = field_id  # 0 = Fr, 1 = Fq in csrc/field_ew.cu
        self.plain = PlainField(consts)

    # -- host converters (numpy) -------------------------------------------
    def pack(self, xs, mont: bool = True) -> np.ndarray:
        """list[int] -> int32 [8, n], optionally in Montgomery form."""
        if mont:
            xs = [x % self.p * self.mont_r % self.p for x in xs]
        else:
            xs = [x % self.p for x in xs]
        return ints_to_limbs(xs)

    def unpack(self, a, mont: bool = True) -> list:
        """[..., 8, n] limbs (tensor or array) -> flat list[int]."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        vals = limbs_to_ints(a)
        if mont:
            r_inv = pow(self.mont_r, -1, self.p)
            vals = [v * r_inv % self.p for v in vals]
        return vals

    def tensor(self, xs, device: torch.device, mont: bool = True) -> torch.Tensor:
        return torch.from_numpy(self.pack(xs, mont)).to(device)

    # -- kernel launch -------------------------------------------------------
    def _ew(self, op: str, a, b=None, c=None, k: int | None = None) -> torch.Tensor:
        ops = [t for t in (a, b, c) if t is not None]
        for t in ops:
            _check(t)
        a2, batch = _lanes(a)
        rest = [_lanes(t)[0] for t in ops[1:]]
        for t in rest:
            if t.shape != a2.shape:
                raise ValueError(f"shape mismatch {tuple(t.shape)} vs {tuple(a2.shape)}")
        b2 = rest[0] if len(rest) > 0 else None
        c2 = rest[1] if len(rest) > 1 else None
        out = torch.empty_like(a2)
        kbuf = None
        if k is not None:
            kbuf = (ctypes.c_uint32 * N_LIMBS)(*[(k >> (32 * i)) & 0xFFFFFFFF for i in range(N_LIMBS)])
        backend.launch(
            "zk_field_ew", f"{self.name}.{op}",
            self.field_id, _OPS[op], a2.data_ptr(),
            b2.data_ptr() if b2 is not None else None,
            c2.data_ptr() if c2 is not None else None,
            ctypes.cast(kbuf, ctypes.c_void_p) if kbuf is not None else None,
            out.data_ptr(), a2.shape[1], backend.stream(a2.device),
        )
        return out.reshape((N_LIMBS,) + batch)

    # -- plain versions ------------------------------------------------------
    def mont_mul_plain(self, a, b):
        return join16(self.plain.mont_mul(split16(a), split16(b)))

    def add_plain(self, a, b):
        return join16(self.plain.add(split16(a), split16(b)))

    def sub_plain(self, a, b):
        return join16(self.plain.sub(split16(a), split16(b)))

    def to_mont_plain(self, a):
        return join16(self.plain.mont_mul_int(split16(a), self.mont_r2))

    def from_mont_plain(self, a):
        return join16(self.plain.from_mont(split16(a)))

    def mont_mul_const_plain(self, a, const: int):
        return join16(self.plain.mont_mul_int(split16(a), const))

    def mul_sub_mul_const_plain(self, a, b, c, const: int):
        f = self.plain
        d = f.sub(f.mont_mul(split16(a), split16(b)), split16(c))
        return join16(f.mont_mul_int(d, const))

    def butterfly_plain(self, u, v, tw):
        f = self.plain
        u16 = split16(u)
        t = f.mont_mul(split16(v), split16(tw))
        return join16(f.add(u16, t)), join16(f.sub(u16, t))

    def normalize_raw_plain(self, cols):
        """int64 [8, *B] column sums (each < 2^63) -> canonical Montgomery."""
        x = cols.to(torch.int64)
        t = _zeros_like_limbs(x, 32)
        for j in range(N_LIMBS):
            for q in range(4):
                t[2 * j + q] += (x[j] >> (16 * q)) & M16
        red = self.plain.mont_reduce(_carry(t))  # T < 2^288 < p*R
        return join16(self.plain.mont_mul_int(red, self.mont_r2))

    # -- public ops (kernel for CUDA tensors, plain version for CPU) --------
    def mont_mul(self, a, b):
        return self.mont_mul_plain(a, b) if on_cpu(a, b) else self._ew("mont_mul", a, b)

    def add(self, a, b):
        return self.add_plain(a, b) if on_cpu(a, b) else self._ew("add", a, b)

    def sub(self, a, b):
        return self.sub_plain(a, b) if on_cpu(a, b) else self._ew("sub", a, b)

    def to_mont(self, a):
        return self.to_mont_plain(a) if on_cpu(a) else self._ew("to_mont", a)

    def from_mont(self, a):
        return self.from_mont_plain(a) if on_cpu(a) else self._ew("from_mont", a)

    def mont_mul_const(self, a, const: int):
        """a * const * R^-1 (pass a Montgomery-form const to stay in form)."""
        if on_cpu(a):
            return self.mont_mul_const_plain(a, const)
        return self._ew("mont_mul_const", a, k=const)

    def mul_sub_mul_const(self, a, b, c, const: int):
        """(a*b - c) * const, const a Montgomery-form int."""
        if on_cpu(a, b, c):
            return self.mul_sub_mul_const_plain(a, b, c, const)
        return self._ew("mul_sub_mul_const", a, b, c, k=const)

    def butterfly(self, u, v, tw):
        """(u + v*tw, u - v*tw), Fr only."""
        if self.field_id != 0:
            raise ValueError("butterfly is an Fr kernel")
        if on_cpu(u, v, tw):
            return self.butterfly_plain(u, v, tw)
        for t in (u, v, tw):
            _check(t)
        u2, batch = _lanes(u)
        v2, tw2 = _lanes(v)[0], _lanes(tw)[0]
        if v2.shape != u2.shape or tw2.shape != u2.shape:
            raise ValueError("butterfly operands differ in shape")
        hi, lo = torch.empty_like(u2), torch.empty_like(u2)
        backend.launch(
            "zk_butterfly", "fr.butterfly", u2.data_ptr(), v2.data_ptr(),
            tw2.data_ptr(), hi.data_ptr(), lo.data_ptr(), u2.shape[1],
            backend.stream(u2.device),
        )
        shape = (N_LIMBS,) + batch
        return hi.reshape(shape), lo.reshape(shape)

    def normalize_raw(self, cols):
        """int64 [8, *B] raw column sums of Montgomery terms -> canonical
        Montgomery int32 [8, *B], Fr only."""
        if self.field_id != 0:
            raise ValueError("normalize_raw is an Fr kernel")
        if on_cpu(cols):
            return self.normalize_raw_plain(cols)
        _check(cols, dtype=torch.int64)
        c2, batch = _lanes(cols)
        out = torch.empty(c2.shape, dtype=torch.int32, device=c2.device)
        backend.launch(
            "zk_normalize_raw", "fr.normalize_raw", c2.data_ptr(),
            out.data_ptr(), c2.shape[1], backend.stream(c2.device),
        )
        return out.reshape((N_LIMBS,) + batch)

    def one_mont(self, device: torch.device) -> torch.Tensor:
        """R mod p as int32 [8, 1]."""
        return torch.from_numpy(ints_to_limbs([self.mont_r])).to(device)


FRK = TorchField(FR_CONSTS, 0)
FQK = TorchField(FQ_CONSTS, 1)
