"""ctypes bridge to the native host libraries (csrc/host/).

``zkfl_host.cpp`` is the host-side fast path for Poseidon/VectorHash/Merkle
(the role circomlibjs WASM plays for the reference) and for the Poseidon
gadget's witness (``poseidon_witness``: every S-box wire of one in-circuit
hash); ``zkfl_pairing.cpp`` is the BN254 multi-pairing behind the Groth16
verifier and the G1/G2 scalar multiplications of proof assembly and of the
verifier's vk_x.  Each is compiled with g++ at first use into
``build/zkfl_tpu_torch/host/<source hash>/`` beside the package: under a
temporary name, then renamed, so that several processes may build at once.
Without g++ (or when the build fails) the callers fall back to the
pure-Python oracles (zkfl_tpu_torch.poseidon.reference,
zkfl_tpu_torch.field.pairing, the gadget's Python branch, the prover's
double-and-add).
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


def build(source: str, headers: Sequence[str] = ()) -> Optional[Path]:
    """g++ build of csrc/host/<source> (once per hash of the source, its
    headers and the flags); the library's path, or None without g++."""
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
        return None
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib_path.name}.{os.getpid()}"
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(files[0])],
                       check=True, capture_output=True, timeout=600)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib_path)
    return lib_path


_lib = None
_tried = False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build("zkfl_host.cpp", ["poseidon_constants.h"])
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.poseidon_hash_batch.argtypes = [ctypes.c_int, ctypes.c_long, u64p, u64p]
        lib.vector_hash_batch.argtypes = [ctypes.c_int, ctypes.c_long, u64p, u64p]
        lib.merkle_build.argtypes = [ctypes.c_long, u64p, u64p]
        vp = ctypes.c_void_p
        lib.poseidon_witness.argtypes = [ctypes.c_int, vp, vp, ctypes.c_char_p, vp, vp]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return get_lib() is not None


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

_pairing_lib = None
_pairing_tried = False


def get_pairing_lib() -> Optional[ctypes.CDLL]:
    global _pairing_lib, _pairing_tried
    if _pairing_lib is not None or _pairing_tried:
        return _pairing_lib
    _pairing_tried = True
    path = build("zkfl_pairing.cpp")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.bn254_pairing_check.argtypes = [ctypes.c_long, u64p, u64p]
        lib.bn254_pairing_check.restype = ctypes.c_int
        buf, out = ctypes.c_char_p, ctypes.c_void_p
        for name in ("bn254_g1_mul", "bn254_g2_mul"):
            getattr(lib, name).argtypes = [buf, ctypes.c_int, buf, out]
            getattr(lib, name).restype = ctypes.c_int
        lib.bn254_groth16_assemble.argtypes = [buf, buf, buf, buf, buf, out]
        lib.bn254_groth16_assemble.restype = ctypes.c_int
        lib.bn254_g1_lincomb.argtypes = [ctypes.c_long, buf, buf, buf, out]
        lib.bn254_g1_lincomb.restype = ctypes.c_int
        lib.bn254_group_op_counts.argtypes = [out]
        lib.bn254_group_op_counts.restype = None
        lib.bn254_miller.argtypes = [ctypes.c_long, buf, buf, out]
        lib.bn254_miller.restype = ctypes.c_int
        for name in ("bn254_final_exp", "bn254_final_exp_plain"):
            getattr(lib, name).argtypes = [buf, out]
            getattr(lib, name).restype = None
        _pairing_lib = lib
    except OSError:
        _pairing_lib = None
    return _pairing_lib


def pairing_available() -> bool:
    return get_pairing_lib() is not None


def pairing_check_native(pairs) -> Optional[bool]:
    """Native 4-limb pairing-product check: True/False (False for a point
    off its curve), or None when the library is unavailable or the native
    loop meets a degenerate step (caller falls back to the Python oracle,
    zkfl_tpu_torch.field.pairing).

    pairs: [(P, Q)] with P an affine int pair (or None = identity) and Q an
    affine G2 pair of FQ2 coords (or None)."""
    lib = get_pairing_lib()
    if lib is None:
        return None
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
    rc = lib.bn254_pairing_check(len(pairs), _ptr(g1_arr), _ptr(g2_arr))
    if rc < 0:
        return None
    return bool(rc)


# -- G1/G2 scalar multiplication (the same library) ---------------------------
#
# Points cross as affine standard-form coordinates, 32 little-endian bytes
# each (G2: x.c0, x.c1, y.c0, y.c1, as bn254_pairing_check reads them), the
# identity as a flag.  Each function returns None without the library, else
# the product as a Jacobian triple with Z = 1, or the identity (1, 1, 0)
# (G2: over FQ2), as groth16/prover.py's ``mul_g1`` returns it.

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
    if lib is None:
        return None
    out = ctypes.create_string_buffer(64)
    if lib.bn254_g1_mul(_g1_coords(p), p is None, _bytes((k % FR,)), out):
        return _G1_INF
    return (*_ints(out.raw), 1)


def g2_mul_native(p, k: int):
    """k p over G2 in constant time in k (p affine over FQ2, None = the
    identity); the coordinates in p's own FQ2 class."""
    from .field.curve import G2_JAC_INF

    lib = get_pairing_lib()
    if lib is None:
        return None
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
    call, every product constant time in r and s; None without the
    library."""
    lib = get_pairing_lib()
    if lib is None:
        return None
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
    if lib is None:
        return None
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
