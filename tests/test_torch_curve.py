"""Port point ops (zkfl_tpu_torch.ops.point_kernels) against zkfl_tpu's
point_kernels (CPU path: ops/curve.py) and the field/curve.py oracle.

The G1 formulas are the same RCB15 sequence in both packages, so even the
projective outputs agree limb for limb once converted between the 8 x 32
and 16 x 16 layouts; affine results compare as integers (tolerance 0): G2
coordinates by their Fq2 coefficients, since each package has its own Fq2
class.
"""

import numpy as np
import pytest
import torch

from zkfl_tpu.field.curve import G1_GEN, g1_add, g1_mul, g1_neg, g2_add, g2_generator, g2_mul, g2_neg
from zkfl_tpu.ops import point_kernels as jpk
from zkfl_tpu_torch.field.limbs import from_u16_limbs
from zkfl_tpu_torch.ops import point_kernels as pk

CPU = torch.device("cpu")
# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)


def g2_ints(pts):
    """G2 affine points (None = identity) as tuples of ints."""
    return [None if q is None else tuple(tuple(c.coeffs) for c in q) for q in pts]


@pytest.fixture(scope="module")
def g1_pairs():
    pts = [g1_mul(G1_GEN, 3 + 5 * i) for i in range(6)]
    p = [pts[0], None, pts[1], pts[2], pts[3], G1_GEN, None]
    q = [pts[1], pts[2], None, pts[2], g1_neg(pts[3]), pts[4], None]
    return p, q  # incl. P+O, O+Q, P+P, P+(-P), O+O


@pytest.fixture(scope="module")
def g2_pairs():
    g = g2_generator()
    p = [g2_mul(g, 2 + i) for i in range(5)]
    q = [g2_mul(g, 9 + i) for i in range(5)]
    p[1] = None
    q[2] = None
    q[3] = p[3]            # P + P
    q[4] = g2_neg(p[4])    # P + (-P)
    return p, q


def test_g1_device_roundtrip(g1_pairs):
    p, _ = g1_pairs
    t = pk.g1_to_device(p, CPU)
    assert tuple(t.shape) == (3, 8, len(p)) and t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), from_u16_limbs(np.asarray(jpk.g1_to_device(p))))
    assert [pk.g1_from_device(t[:, :, i]) for i in range(len(p))] == p


def test_g1_padd_matches_jax_and_oracle(g1_pairs):
    p, q = g1_pairs
    got = pk.padd(pk.g1_to_device(p, CPU), pk.g1_to_device(q, CPU))
    want = jpk.padd(jpk.g1_to_device(p), jpk.g1_to_device(q))
    np.testing.assert_array_equal(got.numpy(), from_u16_limbs(np.asarray(want)))
    assert [pk.g1_from_device(got[:, :, i]) for i in range(len(p))] == [
        g1_add(a, b) for a, b in zip(p, q)
    ]


def test_g1_pdbl_matches_jax_and_oracle(g1_pairs):
    p, _ = g1_pairs
    got = pk.pdbl(pk.g1_to_device(p, CPU))
    want = jpk.pdbl(jpk.g1_to_device(p))
    np.testing.assert_array_equal(got.numpy(), from_u16_limbs(np.asarray(want)))
    assert [pk.g1_from_device(got[:, :, i]) for i in range(len(p))] == [g1_add(a, a) for a in p]


def test_g1_batch_dims_select_and_identity():
    pts = [g1_mul(G1_GEN, 11 + i) for i in range(6)]
    t = pk.g1_to_device(pts, CPU).reshape(3, 8, 2, 3)
    dbl = pk.pdbl(t)
    assert tuple(dbl.shape) == (3, 8, 2, 3)
    inf = pk.inf_point((2, 3), CPU)
    assert [pk.g1_from_device(inf[:, :, 0, i]) for i in range(3)] == [None] * 3
    np.testing.assert_array_equal(pk.padd(t, inf).numpy(), pk.padd(inf, t).numpy())
    mask = torch.tensor([True, False, True])
    sel = pk.select(mask, dbl, t)
    flat = sel.reshape(3, 8, 6)
    want = [g1_add(x, x) if i % 3 != 1 else x for i, x in enumerate(pts)]
    assert [pk.g1_from_device(flat[:, :, i]) for i in range(6)] == want


def test_g2_device_roundtrip(g2_pairs):
    p, _ = g2_pairs
    t = pk.g2_to_device(p, CPU)
    assert tuple(t.shape) == (3, 2, 8, len(p))
    np.testing.assert_array_equal(t.numpy(), from_u16_limbs(np.asarray(jpk.g2_to_device(p))))
    assert g2_ints(pk.g2_from_device(t[..., i]) for i in range(len(p))) == g2_ints(p)


def test_g2_padd_pdbl_match_jax_and_oracle(g2_pairs):
    p, q = g2_pairs
    tp, tq = pk.g2_to_device(p, CPU), pk.g2_to_device(q, CPU)
    got = pk.padd_g2(tp, tq)
    want = jpk.padd_g2(jpk.g2_to_device(p), jpk.g2_to_device(q))
    np.testing.assert_array_equal(got.numpy(), from_u16_limbs(np.asarray(want)))
    assert g2_ints(pk.g2_from_device(got[..., i]) for i in range(len(p))) == g2_ints(
        g2_add(a, b) for a, b in zip(p, q)
    )
    got = pk.pdbl_g2(tp)
    want = jpk.pdbl_g2(jpk.g2_to_device(p))
    np.testing.assert_array_equal(got.numpy(), from_u16_limbs(np.asarray(want)))
    assert g2_ints(pk.g2_from_device(got[..., i]) for i in range(len(p))) == \
        g2_ints(g2_add(a, a) for a in p)
    inf = pk.inf_point_g2((len(p),), CPU)
    assert [pk.g2_from_device(inf[..., i]) for i in range(len(p))] == [None] * len(p)
    sel = pk.select_g2(torch.tensor([True, False, True, False, True]), tp, inf)
    assert g2_ints(pk.g2_from_device(sel[..., i]) for i in range(len(p))) == g2_ints(
        x if i % 2 == 0 else None for i, x in enumerate(p)
    )
