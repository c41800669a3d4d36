"""Port point ops (zkfl_tpu_torch.ops.point_kernels) against zkfl_tpu's
point_kernels (CPU path: ops/curve.py) and the field/curve.py oracle.

The formulas are the same RCB15 sequence in both packages, so even the
projective outputs agree limb for limb once converted between the 8 x 32
and 16 x 16 layouts; affine results compare as integers (tolerance 0): G2
coordinates by their Fq2 coefficients, since each package has its own Fq2
class.  On the CPU the public ops run the plain versions (the K4 and K6
kernels run only on a card, where chip_smoke.py holds them against these).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfl_tpu.field.bn254 import FQ
from zkfl_tpu.field.curve import (G1_GEN, g1_add, g1_mul, g1_neg, g2_add, g2_generator, g2_mul,
                                  g2_mul_jac, g2_neg)
from zkfl_tpu.ops import point_kernels as jpk
from zkfl_tpu_torch.field.limbs import FQ_CONSTS, from_u16_limbs, limbs_to_ints, to_u16_limbs
from zkfl_tpu_torch.ops import point_kernels as pk
from zkfl_tpu_torch.ops.limb_kernels import FQK

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


# ---------------------------------------------------------------------------
# G2 plain versions, doubling counts, extreme projective representatives
# ---------------------------------------------------------------------------

# The standard-form value whose Montgomery representative is p - 1.
EXTREME = (-pow(FQ_CONSTS.mont_r, -1, FQ)) % FQ


@pytest.fixture(scope="module")
def g2_seeded():
    """numpy-seeded G2 points: 4 random sums, then O+Q, P+O, P+P, P+(-P), O+O."""
    r = np.random.RandomState(41)
    g = g2_generator()
    pts = [g2_mul_jac(g, int(k)) for k in r.randint(1, 2**62, size=8, dtype=np.int64)]
    p = pts[:4] + [None, pts[4], pts[5], pts[6], None]
    q = pts[4:8] + [pts[7], None, pts[5], g2_neg(pts[6]), None]
    return p, q


def test_g2_plain_versions_match_jax_and_oracle(g2_seeded):
    p, q = g2_seeded
    tp, tq = pk.g2_to_device(p, CPU), pk.g2_to_device(q, CPU)
    jp, jq = jpk.g2_to_device(p), jpk.g2_to_device(q)
    got = pk.padd_g2_plain(tp, tq)
    np.testing.assert_array_equal(got.numpy(), from_u16_limbs(np.asarray(jpk.padd_g2(jp, jq))))
    np.testing.assert_array_equal(pk.padd_g2(tp, tq).numpy(), got.numpy())
    assert g2_ints(pk.g2_from_device(got[..., i]) for i in range(len(p))) == g2_ints(
        g2_add(a, b) for a, b in zip(p, q))
    got = pk.pdbl_g2_plain(tp)
    np.testing.assert_array_equal(got.numpy(), from_u16_limbs(np.asarray(jpk.pdbl_g2(jp))))
    assert g2_ints(pk.g2_from_device(got[..., i]) for i in range(len(p))) == g2_ints(
        g2_add(a, a) for a in p)


def _jax_doublings(jp, dbl, upto=8):
    """zkfl_tpu's CPU path doubled 1..upto times, in the port's layout."""
    out = {}
    for k in range(1, upto + 1):
        jp = dbl(jp)
        out[k] = from_u16_limbs(np.asarray(jp))
    return out


@pytest.fixture(scope="module")
def g1_doublings(g1_pairs):
    return _jax_doublings(jpk.g1_to_device(g1_pairs[0]), jpk.pdbl)


@pytest.fixture(scope="module")
def g2_doublings(g2_seeded):
    return _jax_doublings(jpk.g2_to_device(g2_seeded[0]), jpk.pdbl_g2)


@pytest.mark.parametrize("times", [1, 3, 8])
def test_g1_pdbl_times_matches_repeated_jax_and_oracle(g1_pairs, g1_doublings, times):
    p, _ = g1_pairs
    got = pk.pdbl(pk.g1_to_device(p, CPU), times=times)
    np.testing.assert_array_equal(got.numpy(), g1_doublings[times])
    assert [pk.g1_from_device(got[:, :, i]) for i in range(len(p))] == [
        None if a is None else g1_mul(a, 1 << times) for a in p]


@pytest.mark.parametrize("times", [1, 3, 8])
def test_g2_pdbl_times_matches_repeated_jax_and_oracle(g2_seeded, g2_doublings, times):
    p, _ = g2_seeded
    got = pk.pdbl_g2(pk.g2_to_device(p, CPU), times=times)
    np.testing.assert_array_equal(got.numpy(), g2_doublings[times])
    assert g2_ints(pk.g2_from_device(got[..., i]) for i in range(len(p))) == g2_ints(
        None if a is None else g2_mul_jac(a, 1 << times) for a in p)


def test_bad_doubling_counts_and_shapes_raise():
    g1 = pk.g1_to_device([G1_GEN], CPU)
    g2 = pk.g2_to_device([g2_generator()], CPU)
    for bad in (0, -1, 2.5):
        with pytest.raises(ValueError):
            pk.pdbl(g1, times=bad)
        with pytest.raises(ValueError):
            pk.pdbl_g2(g2, times=bad)
    with pytest.raises(ValueError):
        pk.padd_g2(g1, g1)
    with pytest.raises(ValueError):
        pk.pdbl(g2)


def _mul2(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % FQ, (a[0] * b[1] + a[1] * b[0]) % FQ)


def g1_extreme(pt, coord):
    """(X:Y:Z) of affine pt scaled so that coordinate ``coord`` has the
    Montgomery representative p - 1."""
    xyz = (pt[0], pt[1], 1)
    lam = EXTREME * pow(xyz[coord], -1, FQ) % FQ
    return tuple(v * lam % FQ for v in xyz)


def g2_extreme(pt, coord, comp):
    """(X:Y:Z) of affine G2 pt scaled by some lambda in Fq2 so that
    component ``comp`` of coordinate ``coord`` has the representative p - 1."""
    xyz = (tuple(pt[0].coeffs), tuple(pt[1].coeffs), (1, 0))
    c = xyz[coord]
    if c[comp]:
        lam = (EXTREME * pow(c[comp], -1, FQ) % FQ, 0)
    else:  # lambda = mu u: component k of mu u c is mu (-c1, c0)[k]
        uc = ((-c[1]) % FQ, c[0])
        lam = (0, EXTREME * pow(uc[comp], -1, FQ) % FQ)
    return tuple(_mul2(lam, v) for v in xyz)


def g1_proj_tensor(projs):
    """Standard-form projective (X, Y, Z) -> [3, 8, n] Montgomery limbs."""
    return torch.from_numpy(np.stack([FQK.pack([pr[i] for pr in projs]) for i in range(3)]))


def g2_proj_tensor(projs):
    return torch.from_numpy(np.stack([
        np.stack([FQK.pack([pr[i][j] for pr in projs]) for j in range(2)]) for i in range(3)]))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_extreme_representatives_match_jax_and_oracle(group):
    """Representatives with a coordinate limb vector equal to p - 1 drive
    the products through their extreme limbs."""
    if group == "g1":
        pts = [g1_mul(G1_GEN, 5 + 11 * i) for i in range(6)]
        projs = [g1_extreme(pts[i], i % 3) for i in range(6)]
        t = g1_proj_tensor(projs)
        ops = (pk.padd, pk.pdbl, jpk.padd, jpk.pdbl, pk.g1_from_device, g1_add, lambda x: x)
    else:
        g = g2_generator()
        pts = [g2_mul_jac(g, 5 + 11 * i) for i in range(6)]
        projs = [g2_extreme(pts[i], i // 2, i % 2) for i in range(6)]
        t = g2_proj_tensor(projs)
        ops = (pk.padd_g2, pk.pdbl_g2, jpk.padd_g2, jpk.pdbl_g2, pk.g2_from_device, g2_add,
               lambda xs: g2_ints(xs))
    padd, pdbl, jpadd, jpdbl, from_dev, add, norm = ops
    limbs = t.numpy()
    target = [limbs[i % 3, :, i] if group == "g1" else limbs[i // 2, i % 2, :, i] for i in range(6)]
    assert limbs_to_ints(np.stack(target, axis=-1)) == [FQ - 1] * 6
    q = torch.roll(t, 1, dims=-1)
    jt, jq = jnp.asarray(to_u16_limbs(limbs)), jnp.asarray(to_u16_limbs(q.numpy()))
    got = padd(t, q)
    np.testing.assert_array_equal(got.numpy(), from_u16_limbs(np.asarray(jpadd(jt, jq))))
    q_pts = pts[-1:] + pts[:-1]
    assert norm([from_dev(got[..., i]) for i in range(6)]) == norm(
        [add(a, b) for a, b in zip(pts, q_pts)])
    got = pdbl(t, times=2)
    np.testing.assert_array_equal(got.numpy(), from_u16_limbs(np.asarray(jpdbl(jpdbl(jt)))))
    assert norm([from_dev(got[..., i]) for i in range(6)]) == norm([add(add(a, a), add(a, a)) for a in pts])
