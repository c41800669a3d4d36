"""The port's fixed-base setup batches (zkfl_tpu_torch/groth16/device_setup.py)
on the CPU, where ``padd`` runs its plain torch version: the batches equal
the pure-Python ladders, their gather indices equal zkfl_tpu's, and
``groth16_setup(device=cpu)`` keys equal the port's ladder keys and
zkfl_tpu's ``device=False`` keys exactly (so the setup cache, whose file
name does not depend on the device, stays valid)."""

import numpy as np
import pytest
import torch

from zkfl_tpu.field.bn254 import FR
from zkfl_tpu.groth16.device_setup import _digit_indices as zk_digit_indices
from zkfl_tpu.groth16.setup import groth16_setup as zk_setup
from zkfl_tpu.r1cs.builder import ConstraintSystem as ZkCS
from zkfl_tpu_torch.field.curve import FixedBaseG2
from zkfl_tpu_torch.groth16 import device_setup
from zkfl_tpu_torch.groth16.setup import FixedBaseG1, cache_path, groth16_setup, setup_cached
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem
from zkfl_tpu_torch.r1cs.compiled import CompiledCircuit

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

CPU = torch.device("cpu")
ALL_FF = int.from_bytes(b"\xff" * 31 + b"\x2f", "little")  # every byte 0xFF but the top, < FR


def _scalars(n: int, seed: int) -> list:
    """0, 1, FR - 1, FR - 2, a scalar with every byte 0xFF below FR, and n
    seeded random scalars."""
    rng = np.random.RandomState(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % FR for _ in range(n)]
    return [0, 1, FR - 1, FR - 2, ALL_FF] + rand


def _g2_key(pts):
    return [None if q is None else tuple(tuple(c.coeffs) for c in q) for q in pts]


def test_digit_indices_match_zkfl_tpu():
    sc = _scalars(61, 1)
    ours = device_setup._digit_indices(sc)
    assert ours.shape == (32, len(sc)) and ours.dtype == np.int64
    assert np.array_equal(ours, np.asarray(zk_digit_indices(sc)))


def test_batch_fixed_mul_g1_matches_ladder():
    assert ALL_FF < FR and all(b == 0xFF for b in ALL_FF.to_bytes(32, "little")[:31])
    sc = _scalars(27, 2)
    fb = FixedBaseG1()
    want = [fb.mul(s) if s % FR else None for s in sc]
    assert device_setup.batch_fixed_mul_g1(sc, CPU) == want
    # chunks of 5 scalars: the same points
    assert device_setup.batch_fixed_mul_g1(sc[:12], CPU, chunk=5) == want[:12]


def test_batch_fixed_mul_g2_matches_ladder():
    sc = _scalars(3, 3)
    fb = FixedBaseG2()
    want = [fb.mul(s) if s % FR else None for s in sc]
    assert _g2_key(device_setup.batch_fixed_mul_g2(sc, CPU, chunk=4)) == _g2_key(want)


def _toy(cls, x, y):
    """out = x^2 * y + x + 7 (public out), built with either package."""
    cs = cls(name="toy_setup")
    out = cs.public_input("out", (x * x % FR * y + x + 7) % FR)
    xin = cs.private_input("x", x)
    yin = cs.private_input("y", y)
    cs.enforce_equal(cs.mul(cs.mul(xin, xin), yin) + xin + 7, out)
    return cs


def key_ints(obj):
    """A key as nested tuples of ints (G2 coordinates by their coefficients)."""
    if hasattr(obj, "__dataclass_fields__"):
        return tuple((f, key_ints(getattr(obj, f))) for f in obj.__dataclass_fields__)
    if isinstance(obj, (list, tuple)):
        return tuple(key_ints(v) for v in obj)
    return tuple(obj.coeffs) if hasattr(obj, "coeffs") else obj


def test_device_setup_keys_equal_ladder_and_zkfl_tpu():
    cs = _toy(ConstraintSystem, 3, 5)
    on_cpu = key_ints(groth16_setup(cs, seed="device-setup", domain=8, device=CPU))
    assert on_cpu == key_ints(groth16_setup(cs, seed="device-setup", domain=8, device=None))
    assert on_cpu == key_ints(zk_setup(_toy(ZkCS, 3, 5), seed="device-setup", device=False, domain=8))


def test_setup_cache_by_device_and_compiled_form(tmp_path):
    cs = _toy(ConstraintSystem, 4, 9)
    cc = CompiledCircuit.from_structure(cs)
    # one file name for either form of the circuit
    assert cache_path(cc, str(tmp_path), domain=8) == cache_path(cs, str(tmp_path), domain=8)
    with pytest.raises(ValueError, match="compiled COO form"):
        setup_cached(cc, str(tmp_path), domain=8, device=CPU)
    keys = setup_cached(cs, str(tmp_path), domain=8, device=CPU)
    assert cache_path(cs, str(tmp_path), domain=8).exists()
    # a warm cache serves the compiled form, whatever device is named
    assert key_ints(setup_cached(cc, str(tmp_path), domain=8, device=None)) == key_ints(keys)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        groth16_setup(_toy(ConstraintSystem, 3, 5), seed="no-card")
