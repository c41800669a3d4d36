"""The optimized form of the Poseidon permutation
(zkfl_tpu_torch/poseidon/optimized.py), whose constants K5 runs, held against
zkfl_tpu's reference permutation, and the counts that chip_smoke.py and
kernel_stats.py derive for K5."""

import numpy as np
import pytest
import torch

import chip_smoke
from zkfl_tpu.ops.poseidon_pallas import _n_subs
from zkfl_tpu.poseidon.reference import poseidon_permutation
from zkfl_tpu_torch import kernel_stats
from zkfl_tpu_torch.field.bn254 import FR
from zkfl_tpu_torch.ops.limb_kernels import FRK
from zkfl_tpu_torch.ops.poseidon import PoseidonKernel
from zkfl_tpu_torch.poseidon.grain import R_F, partial_rounds
from zkfl_tpu_torch.poseidon.optimized import optimized_params, permute_optimized

torch.set_num_threads(1)

# circomlibjs poseidon([1]) and poseidon([1, 2]) (the pins of
# tests/test_poseidon.py and tests/test_torch_standalone.py)
POSEIDON_1 = 18586133768512220936620570745912940619677854269274689475585506675881198879027
POSEIDON_1_2 = 7853200120776062878684798364095072458815029376092732009249414926327459813530


@pytest.mark.parametrize("t", range(2, 18))
def test_permute_optimized_matches_reference(t):
    rng = np.random.RandomState(100 + t)
    states = [[int.from_bytes(rng.bytes(32), "little") % FR for _ in range(t)] for _ in range(3)]
    states += [[0] * t, [1] * t, [FR - 1] * t]
    for st in states:
        assert permute_optimized(st) == poseidon_permutation(st)


def test_optimized_hashes_match_circomlibjs_pins():
    assert permute_optimized([0, 1])[0] == POSEIDON_1
    assert permute_optimized([0, 1, 2])[0] == POSEIDON_1_2


@pytest.mark.parametrize("t", [2, 3, 17])
def test_kernel_buffers_layout(t):
    """c = c0, R_F/2 first-half d, R_P scalars, R_F/2 - 1 second-half d;
    m = M, P, a row of t and a column of t - 1 per partial round: no
    partial round carries a t x t matrix.  The device buffers are the
    Montgomery forms, element-major."""
    o = optimized_params(t)
    rp, h = partial_rounds(t), R_F // 2
    c, m = o.kernel_buffers()
    assert len(c) == R_F * t + rp
    assert len(m) == 2 * t * t + rp * (2 * t - 1)
    assert all(len(row) == t and len(col) == t - 1 for _, row, col in o.partial)
    assert len(o.first) == h and len(o.last) == h - 1
    dc, dm = PoseidonKernel(t).consts(torch.device("cpu"))
    assert dc.shape == (len(c), 8) and dm.shape == (len(m), 8)
    assert FRK.unpack(dc.T.contiguous()) == c and FRK.unpack(dm.T.contiguous()) == m


def test_poseidon_subs_match_zkfl_tpu():
    """poseidon.cuh's poseidon_subs(t) formula (its top-word bound on
    ceil(t p / R)) gives _n_subs(t) of zkfl_tpu's Pallas kernel."""
    for t in range(2, 18):
        assert (t * 0x30644E73 + 0xFFFFFFFF) >> 32 == _n_subs(t)
    assert FR >> 224 == 0x30644E72


def test_poseidon_bound_is_the_fewest_operations():
    """28.612 / 2.969 / 4.100 ms at t = 17 / 2 / 3, 2^20 states, 1980 MHz."""
    got = {t: chip_smoke.bound(f"fr.poseidon t={t}", 1 << 20, 1980.0) for t in (17, 2, 3)}
    assert chip_smoke.poseidon_madds(17) == 456416
    assert {t: round(ms, 3) for t, (ms, _) in got.items()} == {17: 28.612, 2: 2.969, 3: 4.100}
    assert all(by == "operations" for _, by in got.values())


def test_kernel_stats_products():
    reg_max = kernel_stats.poseidon_reg_max_t()
    assert 1 <= reg_max <= 17
    # rolled widths: the two inlined full rounds (3 S-box products, a wide
    # product and a reduction each) and the partial round (3 + 1 products,
    # a wide product, a reduction)
    assert kernel_stats.poseidon_products(17, reg_max) == pytest.approx(13.0)
    assert kernel_stats.products_of("field_ew<Fr, op 6>", reg_max) == (2, "Fr")
    assert kernel_stats.products_of("field_ew<Fq, op 1>", reg_max) is None
    assert kernel_stats.products_of("g1_padd", reg_max) == (14, "Fq")
    assert kernel_stats.products_of("poseidon<t=17>", reg_max) == (pytest.approx(13.0), "Fr")
