"""TorchEngine: the prover compute engine of the port (counterpart of
zkfl_tpu/groth16/engine.py JaxEngine).

The production path is ``fused_msms``: the shared ``groth16_prove``
(zkfl_tpu/groth16/prover.py) sees it and runs the whole witness -> h(X) ->
five-MSM pipeline on ``device`` (groth16/device_prover.py), then assembles
the proof on the host.  The per-primitive methods remain as standalone
entry points for the stage-by-stage path.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.limb_kernels import FRK
from ..ops.msm import msm_g1_host, msm_g2_host
from ..ops.qap import DeviceMatrices, compute_h, matrix_evals


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
