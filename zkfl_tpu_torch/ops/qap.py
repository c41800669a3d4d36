"""QAP stage on the device: limb-major NTT, h(X) on a coset, sparse matrix
evaluation (counterpart of zkfl_tpu/ops/qap_pallas.py).

Each NTT stage is one K2 butterfly launch over all B*n/2 lanes; coset shifts
are FRK.mont_mul, the division by Z is FRK.mul_sub_mul_const, the 1/n scale
FRK.mont_mul_const.  The sparse A.s, B.s, C.s gathers, multiplies by the
coefficients (FRK.mont_mul), sums per row in int64 and closes with the K3
normalize_raw kernel.  Oracle: groth16/qap.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field.bn254 import FR, FR_GENERATOR, fr_inv, fr_nth_root

from ..field.limbs import N_LIMBS, from_u16_limbs
from .limb_kernels import FRK


@lru_cache(maxsize=32)
def _stage_twiddles(n: int, inverse: bool) -> tuple:
    """Per-stage twiddles, each int32 [8, half] Montgomery (numpy)."""
    stages = []
    length = 2
    while length <= n:
        w_len = fr_nth_root(length)
        if inverse:
            w_len = fr_inv(w_len)
        ws, w = [], 1
        for _ in range(length // 2):
            ws.append(w)
            w = w * w_len % FR
        stages.append(FRK.pack(ws))
        length <<= 1
    return tuple(stages)


@lru_cache(maxsize=32)
def _bitrev_idx(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.zeros(n, dtype=np.int64)
    for i in range(n):
        idx[int(format(i, f"0{bits}b")[::-1], 2)] = i
    return idx


@lru_cache(maxsize=32)
def _coset_powers(n: int, inverse: bool) -> np.ndarray:
    s = fr_inv(FR_GENERATOR) if inverse else FR_GENERATOR
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * s % FR
    return FRK.pack(out)  # [8, n] Montgomery


def _dev(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def ntt(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Batched radix-2 NTT, limb-major: x [8, B, n] Montgomery -> same.

    Decimation in time after a bit-reversal gather; one butterfly launch per
    stage over all B*n/2 lanes."""
    _, B, n = x.shape
    dev = x.device
    x = x.index_select(-1, _dev(_bitrev_idx(n), dev))
    for s, tw in enumerate(_stage_twiddles(n, inverse)):
        half = 1 << s
        length = 2 * half
        blocks = x.reshape(N_LIMBS, B, n // length, length)
        u = blocks[..., :half].reshape(N_LIMBS, -1)
        v = blocks[..., half:].reshape(N_LIMBS, -1)
        twb = _dev(tw, dev)[:, None, None, :].expand(N_LIMBS, B, n // length, half)
        hi, lo = FRK.butterfly(u, v, twb.reshape(N_LIMBS, -1))
        x = torch.cat(
            [hi.reshape(N_LIMBS, B, n // length, half), lo.reshape(N_LIMBS, B, n // length, half)],
            dim=-1,
        ).reshape(N_LIMBS, B, n)
    if inverse:
        n_inv_mont = fr_inv(n) * FRK.mont_r % FR
        x = FRK.mont_mul_const(x.reshape(N_LIMBS, -1), n_inv_mont).reshape(N_LIMBS, B, n)
    return x


def compute_h(evals: torch.Tensor) -> torch.Tensor:
    """evals [8, B, 3, n] Montgomery (A.s, B.s, C.s on the domain) -> h(X)
    coefficients [8, B, n] in STANDARD form (ready for MSM digits).

    On the coset g<omega> the vanishing polynomial is the constant g^n - 1,
    so the division is one fused (a*b - c) * z_inv op."""
    _, B, _, n = evals.shape
    dev = evals.device
    coeffs = ntt(evals.reshape(N_LIMBS, 3 * B, n), inverse=True)
    shifted = FRK.mont_mul(
        coeffs.reshape(N_LIMBS, -1), _dev(_coset_powers(n, False), dev).repeat(1, 3 * B)
    ).reshape(N_LIMBS, 3 * B, n)
    on_coset = ntt(shifted).reshape(N_LIMBS, B, 3, n)
    z_inv = fr_inv((pow(FR_GENERATOR, n, FR) - 1) % FR)
    h_s = FRK.mul_sub_mul_const(
        on_coset[:, :, 0].reshape(N_LIMBS, -1),
        on_coset[:, :, 1].reshape(N_LIMBS, -1),
        on_coset[:, :, 2].reshape(N_LIMBS, -1),
        z_inv * FRK.mont_r % FR,
    ).reshape(N_LIMBS, B, n)
    h_c = ntt(h_s, inverse=True)
    h_c = FRK.mont_mul(h_c.reshape(N_LIMBS, -1), _dev(_coset_powers(n, True), dev).repeat(1, B))
    return FRK.from_mont(h_c).reshape(N_LIMBS, B, n)


class DeviceMatrices:
    """Device-resident COO form of the three R1CS matrices (one stream).

    Row ids are offset by which*domain so A, B and C reduce in one pass;
    coefficients are Montgomery limb-major int32 [8, nnz]; zero-coefficient
    padding terms (row 0, wire 0) extend the stream to ``nnz_pad``."""

    def __init__(self, constraints, domain: int, device: torch.device, nnz_pad=None):
        rows, cols, coeffs = [], [], []
        for which in range(3):
            for j, abc in enumerate(constraints):
                for w, coef in abc[which].items():
                    rows.append(which * domain + j)
                    cols.append(w)
                    coeffs.append(coef % FR)
        self._upload(domain, np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                     FRK.pack(coeffs), device, nnz_pad)

    @classmethod
    def from_coo(cls, compiled, domain: int, device: torch.device, nnz_pad=None) -> "DeviceMatrices":
        """From a CompiledCircuit's prepacked COO arrays, in numpy end to end
        (prod-dims circuits have about 10 M terms)."""
        self = cls.__new__(cls)
        self._upload(domain, compiled.which.astype(np.int64) * domain + compiled.row,
                     compiled.col.astype(np.int64), from_u16_limbs(compiled.coeffs), device, nnz_pad)
        return self

    def _upload(self, domain: int, rows: np.ndarray, cols: np.ndarray, coeffs: np.ndarray,
                device: torch.device, nnz_pad) -> None:
        """rows, cols int64 [nnz] and coeffs int32 [8, nnz] -> padded device tensors."""
        nnz = rows.shape[0]
        if nnz_pad is not None:
            if nnz_pad < nnz:
                raise ValueError(f"nnz_pad {nnz_pad} < nnz {nnz}")
            pad = nnz_pad - nnz
            rows = np.concatenate([rows, np.zeros(pad, np.int64)])
            cols = np.concatenate([cols, np.zeros(pad, np.int64)])
            coeffs = np.concatenate([coeffs, np.zeros((N_LIMBS, pad), np.int32)], axis=1)
        self.domain = domain
        self.rows = _dev(rows, device)
        self.cols = _dev(cols, device)
        self.coeffs = _dev(coeffs, device)


def matrix_evals(rows, cols, coeffs, w_mont: torch.Tensor, domain: int) -> torch.Tensor:
    """Sparse (A.s, B.s, C.s): w_mont [8, B, m] -> [8, B, 3, domain]
    Montgomery (B = client/proof batch).

    gather -> FRK.mont_mul -> int64 sums of the 32-bit limbs per row ->
    FRK.normalize_raw.  A row sum stays below nnz_row * 2^32, inside int64
    for rows of fewer than 2^31 terms (the TPU's 16-bit-limb bound
    nnz_row * 2^16 < 2^31 does not carry over to 32-bit limbs)."""
    _, B, m = w_mont.shape
    dev = w_mont.device
    w_flat = w_mont.reshape(N_LIMBS, B * m)
    idx = (torch.arange(B, device=dev)[:, None] * m + cols[None, :]).reshape(-1)
    terms = FRK.mont_mul(w_flat.index_select(-1, idx), coeffs.repeat(1, B))  # [8, B*nnz]
    seg = (torch.arange(B, device=dev)[:, None] * (3 * domain) + rows[None, :]).reshape(-1)
    sums = torch.zeros((N_LIMBS, B * 3 * domain), dtype=torch.int64, device=dev)
    sums.index_add_(1, seg, terms.to(torch.int64) & 0xFFFFFFFF)
    return FRK.normalize_raw(sums).reshape(N_LIMBS, B, 3, domain)
