"""Port QAP stage (zkfl_tpu_torch.ops.qap) against zkfl_tpu's qap_pallas and
the pure-Python oracle groth16/qap.py, domains 8-16, exact integers."""

import numpy as np
import pytest
import torch

from zkfl_tpu.field.bn254 import FR
from zkfl_tpu.groth16 import qap as oracle
from zkfl_tpu.ops import qap_pallas as jqap
from zkfl_tpu.ops.limb_kernels import FRK as JFRK
from zkfl_tpu_torch.field.limbs import from_u16_limbs
from zkfl_tpu_torch.ops import qap
from zkfl_tpu_torch.ops.limb_kernels import FRK

CPU = torch.device("cpu")
# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)
rng = np.random.RandomState(17)


def _from_jax(arr) -> np.ndarray:
    """zkfl_tpu limb-major uint32 [16, *B] -> the port's int32 [8, *B]."""
    return np.moveaxis(from_u16_limbs(np.moveaxis(np.asarray(arr), 0, -2)), -2, 0)


def _rand(n):
    return [int.from_bytes(rng.bytes(32), "little") % FR for _ in range(n)]


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_matches_jax_and_oracle(inverse):
    n, B = 16, 2
    rows = [_rand(n) for _ in range(B)]
    x = torch.from_numpy(np.stack([FRK.pack(r) for r in rows], axis=1))       # [8, B, n]
    jx = np.stack([np.asarray(JFRK.pack(r)) for r in rows], axis=1)         # [16, B, n]
    got = qap.ntt(x, inverse=inverse)
    want = jqap.ntt_lm(jx, inverse=inverse)
    np.testing.assert_array_equal(got.numpy(), _from_jax(want))
    for b in range(B):
        assert FRK.unpack(got[:, b]) == oracle.ntt(rows[b], inverse=inverse)


def test_compute_h_matches_jax_and_oracle():
    n, B = 8, 2
    cases = []
    for b in range(B):
        a, bb = _rand(n), _rand(n)
        # b = 0: an honest QAP (c = a*b on the domain); b = 1: random c
        c = [x * y % FR for x, y in zip(a, bb)] if b == 0 else _rand(n)
        cases.append((a, bb, c))
    ev = torch.from_numpy(np.stack(
        [np.stack([FRK.pack(v) for v in case], axis=1) for case in cases], axis=1))  # [8, B, 3, n]
    jev = np.stack(
        [np.stack([np.asarray(JFRK.pack(v)) for v in case], axis=1) for case in cases], axis=1)
    got = qap.compute_h(ev)
    want = jqap.compute_h_lm(jev)
    np.testing.assert_array_equal(got.numpy(), _from_jax(want))
    for b, (a, bb, c) in enumerate(cases):
        assert FRK.unpack(got[:, b], mont=False) == oracle.compute_h_coeffs(a, bb, c)


def _constraints(n_cons, n_wires):
    out = []
    for _ in range(n_cons):
        out.append(tuple(
            {int(rng.randint(0, n_wires)): int(rng.randint(1, 1 << 30)) for _ in range(3)}
            for _ in range(3)
        ))
    return out


def test_matrix_evals_matches_jax_and_oracle():
    domain, n_wires = 16, 6
    cons = _constraints(11, n_wires)
    nnz = sum(len(abc[k]) for abc in cons for k in range(3))
    dm = qap.DeviceMatrices(cons, domain, CPU, nnz_pad=nnz + 5)
    jdm = jqap.DeviceMatrices(cons, domain, nnz_pad=nnz + 5)
    assert dm.rows.tolist() == np.asarray(jdm.rows).tolist()
    assert dm.cols.tolist() == np.asarray(jdm.cols).tolist()
    np.testing.assert_array_equal(dm.coeffs.numpy(), _from_jax(jdm.coeffs))
    wits = [_rand(n_wires), _rand(n_wires)]
    w = torch.from_numpy(np.stack([FRK.pack(x) for x in wits], axis=1))       # [8, B, m]
    jw = np.stack([np.asarray(JFRK.pack(x)) for x in wits], axis=1)
    got = qap.matrix_evals(dm.rows, dm.cols, dm.coeffs, w, domain)            # [8, B, 3, domain]
    want = jqap.matrix_evals_lm(jdm.rows, jdm.cols, jdm.coeffs, jw, domain)
    np.testing.assert_array_equal(got.numpy(), _from_jax(want))
    for b, wit in enumerate(wits):
        ref = oracle.matrix_evals(cons, wit, domain)
        for i in range(3):
            assert FRK.unpack(got[:, b, i]) == ref[i]
    with pytest.raises(ValueError):
        qap.DeviceMatrices(cons, domain, CPU, nnz_pad=nnz - 1)
