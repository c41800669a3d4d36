"""Fused Groth16 prover on the device: proving key resident, O(1) transfers
(counterpart of zkfl_tpu/groth16/device_prover.py).

Per batch of witnesses the host sends the packed standard-form witnesses and
receives five curve points per proof; everything between — Montgomery
conversion, sparse R1CS evaluation, the h(X) NTT pipeline, digit extraction
and the batched Pippenger MSMs — runs on the tensors' device.  Proof assembly
(blinding terms) stays on the host (groth16/prover.py _assemble_proof).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..field.bn254 import domain_size_for
from ..field.limbs import N_LIMBS
from ..ops import msm
from ..ops import point_kernels as pk_ops
from ..ops.limb_kernels import FRK
from ..ops.qap import DeviceMatrices, compute_h, matrix_evals
from ..parallel.mesh import Mesh
from ..r1cs.builder import ConstraintSystem
from ..r1cs.compiled import n_constraints
from .setup import ProvingKey


@dataclass(frozen=True)
class PipelineProfile:
    """Canonical pipeline shape shared by several circuits (same fields and
    ``cover`` as zkfl_tpu's).  Padding every circuit of a round to one
    (wires, domain, nnz) triple lets them share one set of shapes; it needs
    setups built with ``groth16_setup(..., domain=profile.domain)``."""

    m_pad: int    # padded wire count (>= every circuit's n_wires)
    domain: int   # shared NTT/setup domain (power of two)
    nnz_pad: int  # padded COO length of the R1CS matrices

    @staticmethod
    def cover(structures: Sequence[ConstraintSystem]) -> "PipelineProfile":
        """Smallest profile covering every given circuit (structure-mode
        ConstraintSystems and CompiledCircuits alike)."""

        def nnz_of(cs):
            if getattr(cs, "is_compiled", False):
                return cs.nnz
            return sum(len(abc[k]) for abc in cs.constraints for k in range(3))

        m_pad = max(cs.n_wires for cs in structures)
        domain = max(domain_size_for(n_constraints(cs) + 1) for cs in structures)
        nnz = max(nnz_of(cs) for cs in structures)
        return PipelineProfile(m_pad=m_pad, domain=domain, nnz_pad=nnz)


def _prove_msms_impl(cfg, n_pub: int, g1_pts, b2_pts, rows, cols, coeffs, w_std):
    """cfg = (domain, n_max, wc_g1, wc_g2, wbits).

    w_std: int32 [B, 8, m] standard-form witness limbs (B = client batch;
    per-client proofs are independent).
    Returns ([3, 8, B, 4] G1 results A/B1/C/H, [3, 2, 8, B] B2 results)."""
    domain, n_max, wc_g1, wc_g2, wbits = cfg
    B, _, m = w_std.shape
    dev = w_std.device

    w_lm = w_std.permute(1, 0, 2)  # [8, B, m]
    w_mont = FRK.to_mont(w_lm.reshape(N_LIMBS, B * m)).reshape(N_LIMBS, B, m)
    evals = matrix_evals(rows, cols, coeffs, w_mont, domain)
    h_std = compute_h(evals)  # [8, B, domain] standard form

    scalars, fam, g2_scalars = msm_scalars(n_pub, w_lm, h_std, n_max)
    g1_out = msm._msm_impl(g1_pts, scalars, msm._G1Ops, wc_g1, wbits, row_map=fam)
    g2_out = msm._msm_impl(
        b2_pts, g2_scalars, msm._G2Ops, wc_g2, wbits,
        row_map=torch.zeros(B, dtype=torch.int64, device=dev),
    )
    return g1_out.reshape(3, N_LIMBS, B, 4), g2_out


def msm_scalars(n_pub: int, w_lm: torch.Tensor, h_std: torch.Tensor, n_max: int):
    """The five MSMs' scalars from the witness limbs w_lm [8, B, m] and
    h(X)'s coefficients h_std [8, B, domain], both standard form:
    ([B*4, 8, n_max] rows ordered (client, family) A, B1, C, H; the row ->
    point family map [B*4]; the B2 rows [B, 8, n_max])."""
    _, B, m = w_lm.shape
    dev = w_lm.device

    def pad(x):
        return torch.nn.functional.pad(x, (0, n_max - x.shape[-1]))  # [8, B, n_max]

    wit = pad(w_lm)
    # private-wire scalars stay wire-aligned (c_query is uploaded with n_pub+1
    # identity points in front); public positions mask to zero.
    wire = torch.arange(m, device=dev)
    priv = pad(torch.where(wire > n_pub, w_lm, 0))
    h_sc = pad(h_std[:, :, : h_std.shape[-1] - 1])
    scalars = torch.stack([wit, wit, priv, h_sc], dim=2)  # [8, B, 4, n]
    scalars = scalars.permute(1, 2, 0, 3).reshape(B * 4, N_LIMBS, n_max)
    fam = torch.arange(4, device=dev).repeat(B)  # row -> point family
    return scalars, fam, wit.permute(1, 0, 2).contiguous()


class DeviceProver:
    """Per-circuit proving context with the proving key resident on
    ``device``; ``structure`` is a structure-mode ConstraintSystem or a
    CompiledCircuit (r1cs/compiled.py).

    With a ``PipelineProfile`` the point queries, witness and COO matrices
    pad to the profile's shapes (pk.domain must equal profile.domain)."""

    def __init__(self, pk: ProvingKey, structure: ConstraintSystem, device: torch.device,
                 profile: Optional[PipelineProfile] = None):
        compiled = getattr(structure, "is_compiled", False)
        if not compiled and not structure.constraints:
            raise ValueError("DeviceProver needs the structure-mode CS or a CompiledCircuit")
        if profile is not None and pk.domain != profile.domain:
            raise ValueError(
                f"setup domain {pk.domain} != profile domain {profile.domain}"
                " (pass domain=profile.domain to groth16_setup)"
            )
        self.device = device
        self.pk = pk
        self.n_pub = pk.n_pub
        self.m_wires = structure.n_wires
        self.m_pad = profile.m_pad if profile else structure.n_wires
        if self.m_pad < self.m_wires:
            raise ValueError(f"profile m_pad {self.m_pad} < wires {self.m_wires}")
        self.domain = pk.domain
        n_max = max(self.m_pad, self.domain - 1)
        self.n_max = n_max

        def pad_pts(pts, lead=0):
            out = [None] * lead + list(pts)
            return out + [None] * (n_max - len(out))

        self.g1_pts = torch.stack(
            [
                pk_ops.g1_to_device(pad_pts(pk.a_query), device),
                pk_ops.g1_to_device(pad_pts(pk.b1_query), device),
                # wire-aligned: scalar i multiplies the C point of wire i
                pk_ops.g1_to_device(pad_pts(pk.c_query, lead=pk.n_pub + 1), device),
                pk_ops.g1_to_device(pad_pts(pk.h_query), device),
            ],
            dim=2,
        )  # [3, 8, 4, n_max]
        self.b2_pts = pk_ops.g2_to_device(pad_pts(pk.b2_query), device)[:, :, :, None, :]
        nnz_pad = profile.nnz_pad if profile else None
        if compiled:
            dm = DeviceMatrices.from_coo(structure, self.domain, device, nnz_pad=nnz_pad)
        else:
            dm = DeviceMatrices(structure.constraints, self.domain, device, nnz_pad=nnz_pad)
        self.rows, self.cols, self.coeffs = dm.rows, dm.cols, dm.coeffs
        self.cfg = self.cfg_for(1)
        self._copies: Dict[str, tuple] = {}

    def on(self, device: torch.device) -> tuple:
        """(g1_pts, b2_pts, rows, cols, coeffs) on ``device``: the resident
        tensors themselves where they are already there, else copies made
        once and kept."""
        key = str(device)
        if key not in self._copies:
            self._copies[key] = tuple(t.to(device) for t in (
                self.g1_pts, self.b2_pts, self.rows, self.cols, self.coeffs))
        return self._copies[key]

    def cfg_for(self, batch: int):
        """Pipeline cfg for a client batch of ``batch``."""
        return (
            self.domain, self.n_max,
            msm._auto_chunk(4 * batch, self.n_max, False),
            msm._auto_chunk(batch, self.n_max, True),
            msm._auto_wbits(self.n_max),
        )

    def pack_witnesses(self, witnesses: Sequence[Sequence[int]]) -> np.ndarray:
        w_std = np.zeros((len(witnesses), N_LIMBS, self.m_pad), dtype=np.int32)
        for b, w in enumerate(witnesses):
            w_std[b, :, : self.m_wires] = FRK.pack(list(w), mont=False)
        return w_std

    def msm_results_many(self, witnesses: Sequence[Sequence[int]], mesh=None,
                         axis: str = "clients") -> list:
        """Batched fused pipeline over B independent witnesses (client-batch
        data parallelism); one a/b1/c/h/b2 dict of host affine points per
        witness.  With ``mesh`` (parallel/mesh.py) the client batch shards
        over ``axis``: B must be a multiple of the axis size, and each shard
        runs the pipeline over its slice of the witnesses on its device —
        per-client proving is embarrassingly parallel, so no collective is
        needed.  The results come back in client order."""
        for w in witnesses:
            if len(w) != self.m_wires:
                raise ValueError(f"witness length {len(w)} != wires {self.m_wires}")
        B = len(witnesses)
        w_std = torch.from_numpy(self.pack_witnesses(witnesses))
        if mesh is None:
            mesh = Mesh([self.device], axis)
        D = mesh.shape[axis]
        if B % D:
            raise ValueError(f"client batch {B} does not split over the {D} devices of axis {axis!r}")
        cfg = self.cfg_for(B // D)
        outs = [_prove_msms_impl(cfg, self.n_pub, *self.on(dev), w)
                for dev, w in zip(mesh.devices, mesh.shard(w_std, 0))]
        return [r for g1_out, g2_out in outs for r in self.results_from_device(g1_out, g2_out)]

    def msm_results(self, witness: Sequence[int]) -> Dict[str, object]:
        """Single-witness fused pipeline (batch of one)."""
        return self.msm_results_many([witness])[0]

    @staticmethod
    def results_from_device(g1_out, g2_out) -> list:
        g1_np = g1_out.cpu().numpy()  # [3, 8, B, 4]
        g2_np = g2_out.cpu().numpy()  # [3, 2, 8, B]
        return [
            {
                "a": pk_ops.g1_from_device(g1_np[:, :, b, 0]),
                "b1": pk_ops.g1_from_device(g1_np[:, :, b, 1]),
                "c": pk_ops.g1_from_device(g1_np[:, :, b, 2]),
                "h": pk_ops.g1_from_device(g1_np[:, :, b, 3]),
                "b2": pk_ops.g2_from_device(g2_np[:, :, :, b]),
            }
            for b in range(g1_np.shape[2])
        ]


_prover_cache: Dict[tuple, DeviceProver] = {}


def device_prover(pk: ProvingKey, structure: ConstraintSystem, device: torch.device,
                  profile: Optional[PipelineProfile] = None) -> DeviceProver:
    key = (id(pk), id(structure), str(device), profile)
    prover = _prover_cache.get(key)
    if prover is None:
        prover = DeviceProver(pk, structure, device, profile)
        _prover_cache[key] = prover
    return prover
