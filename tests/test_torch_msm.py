"""Port MSM (zkfl_tpu_torch.ops.msm) against zkfl_tpu's msm_pallas and the
pure-Python Pippenger oracles (groth16/prover.py pippenger_g1 / msm_g2).
Affine results compare exactly, G2 coordinates by their Fq2 coefficients
(each package has its own Fq2 class)."""

import numpy as np
import pytest
import torch

from zkfl_tpu.field.bn254 import FR
from zkfl_tpu.field.curve import G1_GEN, g1_mul, g2_generator, g2_mul
from zkfl_tpu.groth16.prover import msm_g2, pippenger_g1
from zkfl_tpu.ops import msm_pallas as jmsm
from zkfl_tpu.ops.limb_kernels import FRK as JFRK
from zkfl_tpu_torch.ops import msm
from zkfl_tpu_torch.ops import point_kernels as pk
from zkfl_tpu_torch.ops.limb_kernels import FRK

CPU = torch.device("cpu")
# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)
rng = np.random.RandomState(21)


def g2_ints(pt):
    """A G2 affine point (None = identity) as a tuple of ints."""
    return None if pt is None else tuple(tuple(c.coeffs) for c in pt)


def _scalars(n):
    s = [int.from_bytes(rng.bytes(32), "little") % FR for _ in range(n)]
    s[0], s[1], s[2] = 0, 1, FR - 1
    return s


@pytest.mark.parametrize("wbits", [4, 8])
def test_digits_match_jax(wbits):
    sc = [_scalars(9), _scalars(9)]
    t = torch.from_numpy(np.stack([FRK.pack(s, mont=False) for s in sc]))  # [2, 8, 9]
    j = np.stack([np.asarray(JFRK.pack(s, mont=False)) for s in sc])      # [2, 16, 9]
    got = msm._digits(t, wbits).numpy()
    want = np.asarray(jmsm._digits(j, wbits))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 256 // wbits, 9)


def test_msm_g1_row_map_vs_oracle_and_jax():
    """m=2 scalar rows over one shared point row (row_map), 40 points."""
    pts = [g1_mul(G1_GEN, 2 + i) for i in range(40)]
    pts[5] = None
    rows = [_scalars(40), _scalars(40)]
    tp = pk.g1_to_device(pts, CPU)[:, :, None, :]                       # [3, 8, 1, 40]
    ts = torch.from_numpy(np.stack([FRK.pack(s, mont=False) for s in rows]))
    out = msm.msm_batch_g1(tp, ts, row_map=torch.zeros(2, dtype=torch.int64))
    got = [pk.g1_from_device(out[..., i]) for i in range(2)]
    assert got == [pippenger_g1(pts, s) for s in rows]
    assert got == [jmsm.msm_g1_host(pts, s) for s in rows]


def test_msm_g1_families_and_window_chunks():
    """Two point families, scalar rows mapped (1, 0); chunked windows give
    the same sums."""
    fam = [[g1_mul(G1_GEN, 7 + 3 * i) for i in range(20)], [g1_mul(G1_GEN, 100 + i) for i in range(20)]]
    rows = [_scalars(20), _scalars(20)]
    tp = torch.stack([pk.g1_to_device(f, CPU) for f in fam], dim=2)       # [3, 8, 2, 20]
    ts = torch.from_numpy(np.stack([FRK.pack(s, mont=False) for s in rows]))
    row_map = torch.tensor([1, 0])
    full = msm.msm_batch_g1(tp, ts, window_chunk=0, row_map=row_map)
    chunked = msm.msm_batch_g1(tp, ts, window_chunk=16, row_map=row_map)
    got = [pk.g1_from_device(full[..., i]) for i in range(2)]
    assert got == [pippenger_g1(fam[1], rows[0]), pippenger_g1(fam[0], rows[1])]
    assert got == [pk.g1_from_device(chunked[..., i]) for i in range(2)]


def test_msm_g2_vs_oracle_and_jax():
    g = g2_generator()
    pts = [g2_mul(g, 2 + i) for i in range(10)]
    pts[3] = None
    sc = _scalars(10)
    got = g2_ints(msm.msm_g2_host(pts, sc, CPU))
    assert got == g2_ints(msm_g2(pts, sc))
    assert got == g2_ints(jmsm.msm_g2_host(pts, sc))


def test_msm_host_wrappers_edge_cases():
    assert msm.msm_g1_host([], [], CPU) is None
    pts = [g1_mul(G1_GEN, 5), None]
    assert msm.msm_g1_host(pts, [0, 7], CPU) is None  # all terms vanish
    assert msm.msm_g1_host(pts, [3, 0], CPU) == g1_mul(G1_GEN, 15)
    assert msm._auto_wbits(2047) == 4 and msm._auto_wbits(2048) == 8
    assert msm._auto_chunk(12, 16384, False) == 32
