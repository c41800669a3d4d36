"""Batched Poseidon, VectorHash and Merkle trees over Fr on the card
(counterpart of zkfl_tpu/ops/poseidon.py).

States are int32 ``[8, batch, t]`` limb-major tensors in Montgomery form:
zkfl_tpu's ``[batch, t, 16]`` behind the port's leading limb axis.
``PoseidonKernel(t).permute`` launches K5 (csrc/poseidon.cu, the whole
permutation in one launch, in the optimized form of
zkfl_tpu_torch/poseidon/optimized.py) for a CUDA tensor, counted in
``backend.LAUNCHES`` as ``"fr.poseidon"``, and runs ``permute_plain`` for a
CPU tensor.  The plain version follows zkfl_tpu's XLA path
(ops/poseidon.py:48-78) with the plain field arithmetic only, so it launches
no kernel on the card either: the S-box is two Montgomery squarings and a
product, the mix one broadcast Montgomery product of M against the state
and a tree of modular additions over j.  Outputs equal
zkfl_tpu_torch.poseidon.reference (the same Grain constants) exactly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import backend
from ..field.bn254 import FR
from ..field.limbs import N_LIMBS
from ..poseidon.grain import R_F, partial_rounds, poseidon_params
from ..poseidon.optimized import optimized_params
from .limb_kernels import FRK, _check, join16, on_cpu, split16


def _sum_last_mod(f, x: torch.Tensor) -> torch.Tensor:
    """Sum mod p over the last axis of 16-bit-limb tensors, as a tree of
    modular additions (ceil(log2 n) plain ops)."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        s = f.add(x[..., :half], x[..., half : 2 * half])
        x = torch.cat([s, x[..., 2 * half :]], dim=-1) if x.shape[-1] % 2 else s
    return x[..., 0]


@lru_cache(maxsize=32)
class PoseidonKernel:
    """Width-t Poseidon permutation, batched over the states of a tensor."""

    def __init__(self, t: int):
        if not 2 <= t <= 17:
            raise ValueError(f"Poseidon width must be 2..17, got {t}")
        self.t = t
        self.rp = partial_rounds(t)
        C, M = poseidon_params(t)
        # int32 [8, (R_F + rp) * t] round constants (round-major) and
        # [8, t * t] MDS matrix (row-major), Montgomery form.
        self.C = FRK.pack(C)
        self.M = FRK.pack([v for row in M for v in row])
        self._device_consts = {}

    def consts(self, device: torch.device):
        """K5's constant buffers on ``device``, the optimized form's c and m
        (``OptimizedParams.kernel_buffers``): element-major int32 [n, 8]
        Montgomery elements, built once per device."""
        bufs = self._device_consts.get(device)
        if bufs is None:
            bufs = tuple(torch.from_numpy(np.ascontiguousarray(FRK.pack(x).T)).to(device)
                         for x in optimized_params(self.t).kernel_buffers())
            self._device_consts[device] = bufs
        return bufs

    def _check_state(self, state: torch.Tensor) -> None:
        _check(state)
        if state.dim() != 3 or state.shape[2] != self.t:
            raise ValueError(f"expected int32 [8, batch, {self.t}], got {tuple(state.shape)}")

    def permute_plain(self, state: torch.Tensor) -> torch.Tensor:
        """The permutation of int32 [8, B, t] states in plain torch."""
        self._check_state(state)
        f, t = FRK.plain, self.t
        dev = state.device
        c = split16(torch.from_numpy(self.C).to(dev)).reshape(16, R_F + self.rp, 1, t)
        m = split16(torch.from_numpy(self.M).to(dev)).reshape(16, 1, t, t)
        s = split16(state)

        def sbox(x):
            x4 = f.mont_sqr(f.mont_sqr(x))
            return f.mont_mul(x4, x)

        half = R_F // 2
        for r in range(R_F + self.rp):
            s = f.add(s, c[:, r])
            if r < half or r >= half + self.rp:
                s = sbox(s)
            else:
                s = torch.cat([sbox(s[..., :1]), s[..., 1:]], dim=-1)
            s = _sum_last_mod(f, f.mont_mul(m, s[:, :, None, :]))
        return join16(s)

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        """int32 [8, B, t] Montgomery states -> permuted states."""
        self._check_state(state)
        if on_cpu(state):
            return self.permute_plain(state)
        s = state.contiguous()
        out = torch.empty_like(s)
        c, m = self.consts(s.device)
        backend.launch(
            "zk_poseidon", "fr.poseidon", self.t, s.data_ptr(), out.data_ptr(),
            c.data_ptr(), m.data_ptr(), s.shape[1], backend.stream(s.device),
        )
        return out

    def hash(self, inputs: torch.Tensor) -> torch.Tensor:
        """int32 [8, B, t-1] Montgomery inputs -> [8, B] hashes (state
        [0, inputs...], output lane 0)."""
        zero = torch.zeros((N_LIMBS, inputs.shape[1], 1), dtype=torch.int32, device=inputs.device)
        return self.permute(torch.cat([zero, inputs], dim=2))[:, :, 0]


def poseidon_hash_device(inputs: torch.Tensor) -> torch.Tensor:
    """inputs: int32 [8, batch, arity] Montgomery; arity 1..16 -> [8, batch]."""
    return PoseidonKernel(inputs.shape[2] + 1).hash(inputs)


def poseidon_hash_ints(rows, device=None) -> list:
    """Host convenience: equal-arity int rows -> int hashes, computed on
    ``device`` (default: the first CUDA card)."""
    dev = backend.device("cuda") if device is None else torch.device(device)
    arity = len(rows[0])
    flat = [v % FR for row in rows for v in row]
    limbs = torch.from_numpy(FRK.pack(flat)).reshape(N_LIMBS, len(rows), arity).to(dev)
    return FRK.unpack(poseidon_hash_device(limbs))


def vector_hash_device(values: torch.Tensor, chunk_size: int = 16) -> torch.Tensor:
    """Batched VectorHash: values int32 [8, batch, dim] Montgomery -> [8, batch].

    The chunked 16-ary scheme (vector_hash.circom:46-89): Poseidon of the
    values for dim <= 16, else Poseidon of the per-chunk hashes (the last
    chunk short, unpadded)."""
    dim = values.shape[2]
    if dim <= chunk_size:
        return poseidon_hash_device(values)
    chunks = [poseidon_hash_device(values[:, :, i : i + chunk_size])
              for i in range(0, dim, chunk_size)]
    return poseidon_hash_device(torch.stack(chunks, dim=2))


def merkle_root_device(leaves: torch.Tensor, depth: int):
    """Merkle tree of int32 [8, 2^depth] Montgomery leaves (padded by the
    caller) -> (root [8], levels bottom-up).  One batched Poseidon(2) per
    level, parent i = Poseidon(node 2i, node 2i+1)."""
    if leaves.shape[1] != 1 << depth:
        raise ValueError(f"{leaves.shape[1]} leaves, expected 2^{depth}")
    levels = [leaves]
    cur = leaves
    for _ in range(depth):
        cur = poseidon_hash_device(cur.reshape(N_LIMBS, cur.shape[1] // 2, 2))
        levels.append(cur)
    return cur[:, 0], levels
