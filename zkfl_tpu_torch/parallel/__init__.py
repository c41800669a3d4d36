"""Sharding over a list of devices: the mesh, the sharded MSM and the
tensor-parallel prover (counterpart of zkfl_tpu/parallel)."""

from .mesh import Mesh
from .msm import make_sharded_msm, msm_g1_sharded

__all__ = ["Mesh", "make_sharded_msm", "msm_g1_sharded"]
