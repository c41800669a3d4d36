"""ctypes bridge to the native host libraries (csrc/host/).

``zkfl_host.cpp`` is the host side of Poseidon/VectorHash/Merkle (the role
circomlibjs WASM plays for the reference) and of the Poseidon gadget's
witness (``poseidon_witness``: every S-box wire of one in-circuit hash);
``zkfl_pairing.cpp`` is the BN254 multi-pairing behind the Groth16 verifier
and the G1/G2 scalar multiplications of proof assembly and of the
verifier's vk_x.  Each is compiled with g++ at first use into
``build/zkfl_tpu_torch/host/<source hash>/`` beside the package: under a
temporary name, then renamed, so that several processes may build at once.

The libraries are part of the port, as its CUDA kernels are: a call that
needs one builds it or raises ``RuntimeError`` with g++'s message, and
every function here returns its value.  The port keeps no Python copy of
these paths.  The one ``None`` is ``pairing_check_native``'s answer to a
degenerate step, which the verifier sends to the Python oracle
(zkfl_tpu_torch.field.pairing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from itertools import repeat
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .field.bn254 import FR
from .poseidon.grain import R_F, partial_rounds
from .poseidon.optimized import optimized_params

PKG_DIR = Path(__file__).resolve().parent
HOST_SRC = PKG_DIR / "csrc" / "host"
BUILD_ROOT = PKG_DIR.parent / "build" / "zkfl_tpu_torch" / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
STDERR_CHARS = 4000  # of g++'s message in a failed build's error: its first errors


def build(source: str, headers: Sequence[str] = ()) -> Path:
    """g++ build of csrc/host/<source> (once per hash of the source, its
    headers and the flags); the library's path.  Raises RuntimeError,
    naming the source and carrying g++'s message, when g++ is missing or
    the build fails."""
    files = [HOST_SRC / source, *(HOST_SRC / h for h in headers)]
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for f in files:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / f"lib{Path(source).stem}.so"
    if lib_path.exists():
        return lib_path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"cannot build {files[0]}: g++ is not on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib_path.name}.{os.getpid()}"
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(files[0])],
                       check=True, capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        why = e.stderr if isinstance(e, subprocess.CalledProcessError) else str(e)
        raise RuntimeError(f"g++ failed to build {files[0]}:\n{why[:STDERR_CHARS]}") from e
    os.replace(tmp, lib_path)
    return lib_path


_U64P = ctypes.POINTER(ctypes.c_uint64)
_BUF, _OUT = ctypes.c_char_p, ctypes.c_void_p
_INT, _LONG = ctypes.c_int, ctypes.c_long

# Each export's argtypes and restype.
_SIGNATURES = {
    "zkfl_host.cpp": {
        "poseidon_hash_batch": ([_INT, _LONG, _U64P, _U64P], None),
        "vector_hash_batch": ([_INT, _LONG, _U64P, _U64P], None),
        "merkle_build": ([_LONG, _U64P, _U64P], None),
        "poseidon_witness": ([_INT, _OUT, _OUT, _BUF, _OUT, _OUT], None),
    },
    "zkfl_pairing.cpp": {
        "bn254_pairing_check": ([_LONG, _U64P, _U64P], _INT),
        "bn254_g1_mul": ([_BUF, _INT, _BUF, _OUT], _INT),
        "bn254_g2_mul": ([_BUF, _INT, _BUF, _OUT], _INT),
        "bn254_groth16_assemble": ([_BUF, _BUF, _BUF, _BUF, _BUF, _OUT], _INT),
        "bn254_g1_lincomb": ([_LONG, _BUF, _BUF, _BUF, _OUT], _INT),
        "bn254_group_op_counts": ([_OUT], None),
        "bn254_miller": ([_LONG, _BUF, _BUF, _OUT], _INT),
        "bn254_final_exp": ([_BUF, _OUT], None),
        "bn254_final_exp_plain": ([_BUF, _OUT], None),
    },
}


@lru_cache(maxsize=None)
def _load(source: str, headers: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """csrc/host/<source> built and loaded, its exports typed; once a
    process."""
    lib = ctypes.CDLL(str(build(source, headers)))
    for name, (argtypes, restype) in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def get_lib() -> ctypes.CDLL:
    return _load("zkfl_host.cpp", ("poseidon_constants.h",))


def get_pairing_lib() -> ctypes.CDLL:
    return _load("zkfl_pairing.cpp")


def _to_limbs(vals: Sequence[int]) -> np.ndarray:
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype=np.uint64).reshape(len(vals), 4).copy()


def _from_limbs(arr: np.ndarray) -> List[int]:
    # numpy's S32 strings drop trailing NUL bytes: little-endian high zeros,
    # so the value stays the same.
    rows = np.ascontiguousarray(arr).reshape(-1, 4).view("S32").ravel().tolist()
    return list(map(int.from_bytes, rows, repeat("little")))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def poseidon_batch(rows: Sequence[Sequence[int]]) -> List[int]:
    """Hash n equal-arity rows; returns n field elements."""
    lib = get_lib()
    arity = len(rows[0])
    flat = _to_limbs([v for row in rows for v in row])
    out = np.empty((len(rows), 4), dtype=np.uint64)
    lib.poseidon_hash_batch(arity, len(rows), _ptr(flat), _ptr(out))
    return _from_limbs(out)


@lru_cache(maxsize=32)
def _witness_consts(t: int) -> Tuple[np.ndarray, np.ndarray]:
    """K5's constant buffers c and m for width t
    (``OptimizedParams.kernel_buffers``) as Montgomery-form limbs."""
    return tuple(_to_limbs([(v << 256) % FR for v in buf])
                 for buf in optimized_params(t).kernel_buffers())


def poseidon_witness(inputs: Sequence[int]) -> Tuple[List[int], int]:
    """One in-circuit Poseidon hash of 1..16 field elements: the S-box wires
    in the gadget's order (x^2, x^4, x^5 of t S-boxes a full round and one a
    partial round, t = len(inputs) + 1) and the hash."""
    t = len(inputs) + 1
    if not 2 <= t <= 17:
        raise ValueError(f"Poseidon takes 1..16 inputs, got {len(inputs)}")
    lib = get_lib()
    c, m = _witness_consts(t)
    x = b"".join([v.to_bytes(32, "little") for v in inputs])
    n_wires = 3 * (R_F * t + partial_rounds(t))
    buf = np.empty((n_wires + 1, 4), dtype=np.uint64)
    addr = buf.ctypes.data
    lib.poseidon_witness(len(inputs), c.ctypes.data, m.ctypes.data, x, addr, addr + 32 * n_wires)
    wires = _from_limbs(buf)
    return wires, wires.pop()


def vector_hash_batch(rows: Sequence[Sequence[int]]) -> List[int]:
    lib = get_lib()
    dim = len(rows[0])
    flat = _to_limbs([v for row in rows for v in row])
    out = np.empty((len(rows), 4), dtype=np.uint64)
    lib.vector_hash_batch(dim, len(rows), _ptr(flat), _ptr(out))
    return _from_limbs(out)


def merkle_levels(leaves: Sequence[int]) -> List[List[int]]:
    """All tree levels bottom-up for 2^k pre-hashed leaves."""
    lib = get_lib()
    n = len(leaves)
    nodes = np.zeros((2 * n - 1, 4), dtype=np.uint64)
    lv = _to_limbs(list(leaves))
    lib.merkle_build(n, _ptr(lv), _ptr(nodes))
    flat = _from_limbs(nodes)
    levels, off, width = [], 0, n
    while width >= 1:
        levels.append(flat[off : off + width])
        off += width
        if width == 1:
            break
        width //= 2
    return levels


# ---------------------------------------------------------------------------
# BN254 pairing library (csrc/host/zkfl_pairing.cpp) — Groth16 verification
# ---------------------------------------------------------------------------


def pairing_check_native(pairs) -> Optional[bool]:
    """Native 4-limb pairing-product check: True/False (False for a point
    off its curve), or None when the loop meets a degenerate step (the
    caller asks the Python oracle, zkfl_tpu_torch.field.pairing).

    pairs: [(P, Q)] with P an affine int pair (or None = identity) and Q an
    affine G2 pair of FQ2 coords (or None)."""
    g1_vals: List[int] = []
    g2_vals: List[int] = []
    for P, Q in pairs:
        if P is None or Q is None:
            # identity factor contributes 1; encode as (0,0) which the C
            # side skips
            g1_vals += [0, 0]
            g2_vals += [0, 0, 0, 0]
            continue
        g1_vals += [P[0], P[1]]
        x, y = Q
        xc = x.coeffs if hasattr(x, "coeffs") else x
        yc = y.coeffs if hasattr(y, "coeffs") else y
        g2_vals += [xc[0], xc[1], yc[0], yc[1]]
    g1_arr = _to_limbs(g1_vals)
    g2_arr = _to_limbs(g2_vals)
    rc = get_pairing_lib().bn254_pairing_check(len(pairs), _ptr(g1_arr), _ptr(g2_arr))
    if rc < 0:
        return None
    return bool(rc)


# -- G1/G2 scalar multiplication (the same library) ---------------------------
#
# Points cross as affine standard-form coordinates, 32 little-endian bytes
# each (G2: x.c0, x.c1, y.c0, y.c1, as bn254_pairing_check reads them), the
# identity as a flag.  Each function returns the product as a Jacobian triple
# with Z = 1, or the identity (1, 1, 0) (G2: over FQ2), as
# groth16/prover.py's ``mul_g1`` returns it.

_G1_INF = (1, 1, 0)


def _bytes(vals) -> bytes:
    return b"".join([v.to_bytes(32, "little") for v in vals])


def _g1_coords(p) -> bytes:
    return _bytes((0, 0) if p is None else p)


def _g2_coords(p) -> bytes:
    if p is None:
        return bytes(128)
    x, y = (c.coeffs if hasattr(c, "coeffs") else c for c in p)
    return _bytes((*x, *y))


def _fq2_class(p):
    """The FQ2 class of p's coordinates, so that results compare equal to
    points made by the same code as p (the port's FQ2 otherwise)."""
    from .field.tower import FQ2

    return type(p[0]) if p is not None and hasattr(p[0], "coeffs") else FQ2


def _ints(raw: bytes) -> List[int]:
    return [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]


def g1_mul_native(p, k: int):
    """k p over G1 in constant time in k (p affine, None = the identity)."""
    lib = get_pairing_lib()
    out = ctypes.create_string_buffer(64)
    if lib.bn254_g1_mul(_g1_coords(p), p is None, _bytes((k % FR,)), out):
        return _G1_INF
    return (*_ints(out.raw), 1)


def g2_mul_native(p, k: int):
    """k p over G2 in constant time in k (p affine over FQ2, None = the
    identity); the coordinates in p's own FQ2 class."""
    from .field.curve import G2_JAC_INF

    lib = get_pairing_lib()
    out = ctypes.create_string_buffer(128)
    if lib.bn254_g2_mul(_g2_coords(p), p is None, _bytes((k % FR,)), out):
        return G2_JAC_INF
    fq2 = _fq2_class(p)
    x0, x1, y0, y1 = _ints(out.raw)
    return fq2([x0, x1]), fq2([y0, y1]), fq2.one()


def groth16_assemble_native(pk, msms: dict, r: int, s: int):
    """(pi_A, pi_B, pi_C) of one Groth16 proof (affine, None = the identity)
    from ``pk``'s alpha1, beta1, delta1, beta2, delta2, the five MSM results
    ``msms`` (a, b1, c, h over G1, b2 over G2) and the blinding r, s, in one
    call, every product constant time in r and s."""
    lib = get_pairing_lib()
    g1 = [pk.alpha1, pk.beta1, pk.delta1, msms["a"], msms["b1"], msms["c"], msms["h"]]
    g2 = [pk.beta2, pk.delta2, msms["b2"]]
    out = ctypes.create_string_buffer(256)
    inf = lib.bn254_groth16_assemble(
        b"".join(map(_g1_coords, g1)), bytes(p is None for p in g1),
        b"".join(map(_g2_coords, g2)), bytes(p is None for p in g2),
        _bytes((r % FR, s % FR, -r * s % FR)), out)
    v = _ints(out.raw)
    fq2 = _fq2_class(pk.beta2)
    return (None if inf & 1 else (v[0], v[1]),
            None if inf & 2 else (fq2(v[2:4]), fq2(v[4:6])),
            None if inf & 4 else (v[6], v[7]))


def g1_lincomb_native(points: Sequence, scalars: Sequence[int]):
    """points[0] + sum_i scalars[i] points[i + 1] over G1, for public
    scalars (the verifier's vk_x; not constant time)."""
    if len(points) != len(scalars) + 1:
        raise ValueError(f"{len(points)} points for {len(scalars)} scalars")
    lib = get_pairing_lib()
    out = ctypes.create_string_buffer(64)
    flags = bytes(p is None for p in points)
    coords = b"".join(map(_g1_coords, points))
    if lib.bn254_g1_lincomb(len(scalars), coords, flags, _bytes(s % FR for s in scalars), out):
        return _G1_INF
    return (*_ints(out.raw), 1)


def group_op_counts() -> Tuple[int, int, int]:
    """This thread's doublings, additions and table entries read by the
    library's G1/G2 code since the last call (the counts restart)."""
    out = (ctypes.c_uint64 * 3)()
    get_pairing_lib().bn254_group_op_counts(out)
    return tuple(out)
