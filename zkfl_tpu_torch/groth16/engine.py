"""Prover compute engines: HostEngine (pure-Python oracle) and TorchEngine
(counterparts of zkfl_tpu/groth16/engine.py HostEngine and JaxEngine).

An engine supplies the four heavy primitives of ``groth16_prove``
(groth16/prover.py): msm_g1 / msm_g2, matrix_evals and compute_h.
TorchEngine's production path is ``fused_msms``: ``groth16_prove`` sees it
and runs the whole witness -> h(X) -> five-MSM pipeline on ``device``
(groth16/device_prover.py), then assembles the proof on the host.  Its
per-primitive methods remain as standalone entry points for the
stage-by-stage path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.limb_kernels import FRK
from ..ops.msm import msm_g1_host, msm_g2_host
from ..ops.qap import DeviceMatrices, compute_h, matrix_evals
from . import qap
from .prover import msm_g2, pippenger_g1


class HostEngine:
    """Pure-Python primitives (oracle + micro-circuit fallback)."""

    name = "host"

    @staticmethod
    def msm_g1(points, scalars):
        return pippenger_g1(points, scalars)

    @staticmethod
    def msm_g2(points, scalars):
        return msm_g2(points, scalars)

    @staticmethod
    def matrix_evals(constraints, witness, domain):
        return qap.matrix_evals(constraints, witness, domain)

    @staticmethod
    def compute_h(a_evals, b_evals, c_evals):
        return qap.compute_h_coeffs(a_evals, b_evals, c_evals)


class TorchEngine:
    """Device primitives over limb tensors on an explicit ``torch.device``."""

    name = "torch"

    def __init__(self, device: torch.device, profile=None):
        """``profile`` (device_prover.PipelineProfile) pads every circuit
        proved through this engine to one canonical shape; None keeps each
        circuit's own shapes."""
        self.device = torch.device(device)
        self.profile = profile
        self._sparse_cache: Dict[tuple, DeviceMatrices] = {}

    def fused_msms(self, pk, structure, witness):
        from .device_prover import device_prover

        return device_prover(pk, structure, self.device, self.profile).msm_results(witness)

    def msm_g1(self, points, scalars):
        return msm_g1_host(points, scalars, self.device)

    def msm_g2(self, points, scalars):
        return msm_g2_host(points, scalars, self.device)

    def matrix_evals(self, constraints, witness, domain):
        key = (id(constraints), domain)
        dm = self._sparse_cache.get(key)
        if dm is None:
            dm = DeviceMatrices(constraints, domain, self.device)
            self._sparse_cache[key] = dm
        w = FRK.tensor(list(witness), self.device)[:, None, :]  # [8, 1, m]
        evals = matrix_evals(dm.rows, dm.cols, dm.coeffs, w, domain)  # [8, 1, 3, domain]
        return tuple(FRK.unpack(evals[:, 0, i]) for i in range(3))

    def compute_h(self, a_evals, b_evals, c_evals):
        evals = np.stack(
            [FRK.pack(list(a_evals)), FRK.pack(list(b_evals)), FRK.pack(list(c_evals))], axis=1
        )  # [8, 3, n]
        h = compute_h(torch.from_numpy(evals).to(self.device)[:, None])  # [8, 1, n] standard
        return FRK.unpack(h[:, 0], mont=False)
