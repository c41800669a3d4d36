"""ctypes bridge to the native host libraries (csrc/host/).

``zkfl_host.cpp`` is the host-side fast path for Poseidon/VectorHash/Merkle
(the role circomlibjs WASM plays for the reference); ``zkfl_pairing.cpp`` is
the BN254 multi-pairing behind the Groth16 verifier.  Each is compiled with
g++ at first use into ``build/zkfl_tpu_torch/host/<source hash>/`` beside
the package: under a temporary name, then renamed, so that several processes
may build at once.  Without g++ (or when the build fails) the callers fall
back to the pure-Python oracles (zkfl_tpu_torch.poseidon.reference,
zkfl_tpu_torch.field.pairing).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

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
    data = arr.reshape(-1, 4).tobytes()
    return [
        int.from_bytes(data[i : i + 32], "little") for i in range(0, len(data), 32)
    ]


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
# BN254 pairing library (csrc/host/zkfl_pairing.cpp) — fast Groth16 verification
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
        _pairing_lib = lib
    except OSError:
        _pairing_lib = None
    return _pairing_lib


def pairing_available() -> bool:
    return get_pairing_lib() is not None


def pairing_check_native(pairs) -> Optional[bool]:
    """Native 4-limb pairing-product check: True/False, or None when the
    library is unavailable or an input is degenerate (caller falls back to
    the Python oracle, zkfl_tpu_torch.field.pairing).

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
