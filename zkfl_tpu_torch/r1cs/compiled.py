"""Compact compiled form of a constraint system: COO matrices on disk
(counterpart of zkfl_tpu/r1cs/compiled.py, same ``.coo.npz`` layout).

The Python structure build for the production-dims balance circuit
(128,7,16) takes minutes and 10.5 M constraint-dict entries; the device
prover only needs the COO streams + wire counts, and the trusted setup is
separately disk-cached (groth16/setup.setup_cached).  Caching the COO form
as one .npz makes a warm prod-dims prove start in seconds — the analog of
the reference reusing its compiled .r1cs artifacts
(full_system_simulation.mjs:698-739).

The file layout is zkfl_tpu's, so each package reads the other's files:
``coeffs`` uint32[16, nnz] of 16-bit limbs of the Montgomery form
(R = 2^256), ``which`` uint8, ``row``/``col`` int32, ``meta`` int64
(constraints, wires, public inputs), ``name``.  Files load with
``allow_pickle=False``.

A CompiledCircuit feeds groth16_prove/DeviceProver exactly like a
structure-mode ConstraintSystem (fused TorchEngine path only — the host
stage-by-stage path needs the dict-form constraints).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..field.bn254 import FR
from ..field.limbs import to_u16_limbs
from .builder import ConstraintSystem


@dataclass
class CompiledCircuit:
    """COO view of R1CS matrices A/B/C (which ∈ {0,1,2}) + wire metadata."""

    name: str
    n_constraints: int
    n_wires: int
    n_pub: int
    which: np.ndarray  # uint8[nnz]   matrix id
    row: np.ndarray    # int32[nnz]   constraint index
    col: np.ndarray    # int32[nnz]   wire index
    coeffs: np.ndarray  # uint32[16, nnz] limb-major Montgomery coefficients

    # Marker for groth16_prove / DeviceProver dispatch.
    is_compiled = True

    @property
    def nnz(self) -> int:
        return int(self.which.shape[0])

    @classmethod
    def from_structure(cls, cs: ConstraintSystem) -> "CompiledCircuit":
        from ..ops.limb_kernels import FRK

        if not cs.constraints:
            raise ValueError("need a structure-mode ConstraintSystem")
        which, row, col, coeffs = [], [], [], []
        for w in range(3):
            for j, abc in enumerate(cs.constraints):
                for wire, coef in abc[w].items():
                    which.append(w)
                    row.append(j)
                    col.append(wire)
                    coeffs.append(coef % FR)
        return cls(
            name=cs.name,
            n_constraints=len(cs.constraints),
            n_wires=cs.n_wires,
            n_pub=cs.n_pub,
            which=np.asarray(which, dtype=np.uint8),
            row=np.asarray(row, dtype=np.int32),
            col=np.asarray(col, dtype=np.int32),
            coeffs=to_u16_limbs(FRK.pack(coeffs)),
        )

    def save(self, path: str | os.PathLike) -> None:
        np.savez_compressed(
            path,
            name=np.asarray(self.name),
            meta=np.asarray([self.n_constraints, self.n_wires, self.n_pub], np.int64),
            which=self.which,
            row=self.row,
            col=self.col,
            coeffs=self.coeffs,
        )

    @classmethod
    def load(cls, path: str | os.PathLike) -> "CompiledCircuit":
        with np.load(path, allow_pickle=False) as d:
            meta = d["meta"]
            return cls(
                name=str(d["name"]),
                n_constraints=int(meta[0]),
                n_wires=int(meta[1]),
                n_pub=int(meta[2]),
                which=d["which"],
                row=d["row"],
                col=d["col"],
                coeffs=d["coeffs"],
            )


def n_constraints(cs) -> int:
    """Constraint count of a structure-mode ConstraintSystem or a
    CompiledCircuit."""
    return cs.n_constraints if getattr(cs, "is_compiled", False) else len(cs.constraints)


def compiled_cached(params, cache_dir: str) -> CompiledCircuit | None:
    """Load the cached compiled form for `params`, or None when absent."""
    path = Path(cache_dir) / f"{params.name}.coo.npz"
    if path.exists():
        return CompiledCircuit.load(path)
    return None


def compile_and_cache(cs: ConstraintSystem, cache_dir: str) -> CompiledCircuit:
    cache = Path(cache_dir)
    cache.mkdir(parents=True, exist_ok=True)
    cc = CompiledCircuit.from_structure(cs)
    cc.save(cache / f"{cs.name}.coo.npz")
    return cc
