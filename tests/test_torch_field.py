"""Port field layer (zkfl_tpu_torch.field.limbs, ops.limb_kernels, backend)
against zkfl_tpu's FRK/FQK on the same inputs.

On the CPU both sides run their plain versions: zkfl_tpu's PallasField ops
return the XLA limb-layer result off the TPU, the port's wrappers take their
plain torch versions for CPU tensors.  Finite-field results compare as
integers, exactly (tolerance 0).
"""

import re

import numpy as np
import pytest
import torch

from zkfl_tpu.field.bn254 import FQ, FR
from zkfl_tpu.ops.limb_kernels import FQK as JFQK
from zkfl_tpu.ops.limb_kernels import FRK as JFRK
from zkfl_tpu_torch import backend
from zkfl_tpu_torch.field.limbs import (
    FQ_CONSTS,
    FR_CONSTS,
    from_u16_limbs,
    ints_to_limbs,
    limbs_to_ints,
    to_u16_limbs,
)
from zkfl_tpu_torch.ops.limb_kernels import FQK, FRK, on_cpu

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

FIELDS = {"fr": (FRK, JFRK, FR), "fq": (FQK, JFQK, FQ)}
N = 12


def _rand(rng, p, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n - 3)]
    return vals + [0, 1, p - 1]


def _inputs(name, seed=5):
    """Three canonical operand lists (with 0, 1, p-1) and a Montgomery const."""
    _, _, p = FIELDS[name]
    rng = np.random.RandomState(seed)
    a, b, c = _rand(rng, p, N), _rand(rng, p, N)[::-1], _rand(rng, p, N)
    k = 987654321 * pow(2, 256, p) % p
    return a, b, c, k


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def test_constants_match_cuda_header():
    """The moduli, n' and R^2 baked into csrc/bn254.cuh are the field's."""
    src = (backend.CSRC_DIR / "bn254.cuh").read_text()

    def words(x):
        return [f"0x{(x >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(8)]

    for consts, struct in ((FR_CONSTS, "Fr"), (FQ_CONSTS, "Fq")):
        body = src[src.index(f"struct {struct} {{"):]
        body = body[: body.index("\n};")]
        assert f"NP0 = 0x{consts.n_prime & 0xFFFFFFFF:08x}u" in body
        assert ", ".join(words(consts.p)[:4]) in body
        assert ", ".join(words(consts.p)[4:]) in body
        assert ", ".join(words(consts.mont_r2)[:4]) in body
        assert ", ".join(words(consts.mont_r2)[4:]) in body
    b3 = 9 * FQ_CONSTS.mont_r % FQ
    assert ", ".join(words(b3)[:4]) in src and ", ".join(words(b3)[4:]) in src


def test_c_signatures_match_sources():
    """Every ctypes signature names an extern "C" entry with as many args."""
    decls = {}
    for src in backend.CSRC_DIR.glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            decls[name] = len([a for a in args.split(",") if a.strip()])
    assert set(backend._SIGNATURES) <= set(decls)
    for name, argtypes in backend._SIGNATURES.items():
        assert len(argtypes) == decls[name], name
    assert "arch=compute_90a,code=sm_90a" in backend.NVCC_FLAGS


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_pack_roundtrips(name):
    F, JF, p = FIELDS[name]
    a, _, _, _ = _inputs(name)
    for mont in (True, False):
        packed = F.pack(a, mont=mont)
        assert packed.dtype == np.int32 and packed.shape == (8, N)
        assert F.unpack(packed, mont=mont) == a
        assert F.unpack(_t(packed), mont=mont) == a
        # 8 x 32-bit <-> zkfl_tpu's 16 x 16-bit layout, same integers
        np.testing.assert_array_equal(to_u16_limbs(packed), np.asarray(JF.pack(a, mont=mont)))
        np.testing.assert_array_equal(from_u16_limbs(JF.pack(a, mont=mont)), packed)
    big = [0, 1, 2**255 + 12345, 2**256 - 1]
    assert limbs_to_ints(ints_to_limbs(big)) == big
    batched = np.stack([ints_to_limbs(big), ints_to_limbs(big[::-1])])  # [2, 8, 4]
    assert limbs_to_ints(batched) == big + big[::-1]


OPS = ["mont_mul", "add", "sub", "to_mont", "from_mont", "mont_mul_const", "mul_sub_mul_const"]


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("op", OPS)
def test_field_op_matches_jax(name, op):
    F, JF, p = FIELDS[name]
    a, b, c, k = _inputs(name)
    std = op == "to_mont"  # to_mont takes standard-form input
    ta, tb, tc = (_t(F.pack(x, mont=not std)) for x in (a, b, c))
    ja, jb, jc = (JF.pack(x, mont=not std) for x in (a, b, c))
    args = {"mont_mul": ((ta, tb), (ja, jb)), "add": ((ta, tb), (ja, jb)),
            "sub": ((ta, tb), (ja, jb)), "to_mont": ((ta,), (ja,)),
            "from_mont": ((ta,), (ja,)), "mont_mul_const": ((ta, k), (ja, k)),
            "mul_sub_mul_const": ((ta, tb, tc, k), (ja, jb, jc, k))}[op]
    got = getattr(F, op)(*args[0])
    want = getattr(JF, op)(*args[1])
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, N)
    assert limbs_to_ints(got.numpy()) == limbs_to_ints(from_u16_limbs(np.asarray(want)))
    # and the integers themselves
    r_inv = pow(F.mont_r, -1, p)
    expect = {
        "mont_mul": [x * y % p for x, y in zip(a, b)],
        "add": [(x + y) % p for x, y in zip(a, b)],
        "sub": [(x - y) % p for x, y in zip(a, b)],
        "to_mont": a,
        "from_mont": a,
        "mont_mul_const": [x * k * r_inv % p for x in a],
        "mul_sub_mul_const": [(x * y - z) * k * r_inv % p for x, y, z in zip(a, b, c)],
    }[op]
    assert F.unpack(got, mont=op != "from_mont") == expect


def test_butterfly_matches_jax():
    a, b, c, _ = _inputs("fr", seed=9)
    hi, lo = FRK.butterfly(*(_t(FRK.pack(x)) for x in (a, b, c)))
    jhi, jlo = JFRK.butterfly(*(JFRK.pack(x) for x in (a, b, c)))
    assert FRK.unpack(hi) == JFRK.unpack(jhi) == [(x + y * z) % FR for x, y, z in zip(a, b, c)]
    assert FRK.unpack(lo) == JFRK.unpack(jlo) == [(x - y * z) % FR for x, y, z in zip(a, b, c)]


def test_normalize_raw_matches_jax():
    """Column sums of the same Montgomery terms in both limb layouts."""
    rng = np.random.RandomState(13)
    n_terms, lanes = 40, N
    terms = [_rand(rng, FR, lanes) for _ in range(n_terms)]
    cols32 = sum(ints_to_limbs(t).view(np.uint32).astype(np.int64) for t in terms)
    cols16 = sum(np.asarray(JFRK.pack(t, mont=False)).astype(np.int64) for t in terms)
    got = FRK.normalize_raw(_t(cols32))
    want = JFRK.normalize_raw(cols16.astype(np.uint32))  # each < 40 * 2^16 < 2^31
    assert FRK.unpack(got, mont=False) == JFRK.unpack(want, mont=False)
    assert FRK.unpack(got, mont=False) == [sum(col) % FR for col in zip(*terms)]
    # the int64 bound of the port: sums up to 2^63 - 1 per column
    extreme = np.full((8, 2), 2**63 - 1, dtype=np.int64)
    extreme[:, 1] = 0
    value = sum((2**63 - 1) << (32 * j) for j in range(8))
    assert FRK.unpack(FRK.normalize_raw(_t(extreme)), mont=False) == [value % FR, 0]


def test_batch_dims_and_device_checks():
    a, b, _, _ = _inputs("fq")
    ta = _t(FQK.pack(a)).reshape(8, 3, 4)
    tb = _t(FQK.pack(b)).reshape(8, 3, 4)
    out = FQK.mont_mul(ta, tb)
    assert tuple(out.shape) == (8, 3, 4)
    assert FQK.unpack(out.reshape(8, -1)) == [x * y % FQ for x, y in zip(a, b)]
    assert on_cpu(ta, tb)
    meta = torch.empty((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        on_cpu(meta)
    with pytest.raises(ValueError):
        FQK.mont_mul(ta, meta.reshape(8, 1, 4))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; chip_smoke.py checks the kernels there")
    with pytest.raises(RuntimeError):
        backend.device("cuda")
    assert backend.device("cpu") == torch.device("cpu")
