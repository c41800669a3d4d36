"""Device selection, toolchain probe, kernel build and launch bookkeeping.

The CUDA sources under ``csrc/`` are compiled by ``nvcc`` into one shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The build happens at first use, into
``build/zkfl_tpu_torch/<hash of the sources and flags>/`` beside the
package, so a fresh checkout builds everything on its first kernel launch.

Every C entry point returns ``cudaGetLastError()``; ``launch`` raises when it
is not 0.  ``LAUNCHES`` counts kernel launches by op name: the wrappers in
``ops/`` add one where they launch a kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "zkfl_tpu_torch"
LIB_NAME = "libzkfl_cuda.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

# C entry points: name -> argtypes (pointers and the stream as c_void_p).
_P = ctypes.c_void_p
_N = ctypes.c_longlong
_SIGNATURES = {
    "zk_field_ew": [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _N, _P],
    "zk_butterfly": [_P, _P, _P, _P, _P, _N, _P],
    "zk_normalize_raw": [_P, _P, _N, _P],
    "zk_g1_padd": [_P, _P, _P, _N, _P],
    "zk_g1_pdbl": [_P, _P, _N, _P],
}

_lib = None


def device(name: str) -> torch.device:
    """torch.device for ``name``; a CUDA device must exist when asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch sees no CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


def _run(cmd) -> str | None:
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip() if res.returncode == 0 else None


def nvcc_path() -> str | None:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    return shutil.which("nvcc")


def gpu_name_and_power_limit() -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, or None."""
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    return out.splitlines()[0].strip() if out else None


def probe() -> dict:
    """Toolchain and card facts, for logs and reports."""
    nvcc = nvcc_path()
    nvcc_ver = _run([nvcc, "--version"]) if nvcc else None
    try:
        import triton

        triton_ver = triton.__version__
    except ImportError:
        triton_ver = None
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "nvcc": nvcc_ver.splitlines()[-1] if nvcc_ver else None,
        "triton": triton_ver,
        "gpu": gpu_name_and_power_limit(),
    }


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library (once per source hash);
    nvcc's output, with ptxas's register and spill report, goes to
    build.log beside it."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in sorted(CSRC_DIR.glob("*.cu")))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.zk_error_string.argtypes = [ctypes.c_int]
        handle.zk_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch(entry: str, count_as: str, *args) -> None:
    """Call C entry point ``entry``; raise on a CUDA error; count the launch."""
    handle = lib()
    rc = getattr(handle, entry)(*args)
    if rc != 0:
        msg = handle.zk_error_string(rc).decode()
        raise RuntimeError(f"{entry} ({count_as}) failed: CUDA error {rc}: {msg}")
    LAUNCHES[count_as] += 1
