"""K6's launch-bounds hints, swept on the card.

    python -m zkfl_tpu_torch.launch_bounds 2:3 3:3 2:4 3:4

builds csrc/g2_point.cu once per PADD:PDBL pair of minimum-blocks hints
(the literals of its two __launch_bounds__), prints ptxas's registers and
spills per entry, checks each build's padd, pdbl and 8 doublings against
the plain versions, then prints the card times of padd, pdbl and 8 doublings
at the G2 MSM's widest launch (3 x 2^14 points) and of 8 doublings at the
Horner ladder's 3 lanes, every build timed twice, in turns forward and back.
Needs one CUDA card and nvcc; the builds go under build/launch_bounds/.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import backend, kernel_stats
from .field import curve
from .ops import point_kernels as pk

LANES, LADDER, WBITS, SETS = 3 << 14, 3, 8, 8


def with_hints(src: str, hints: tuple) -> str:
    """g2_point.cu's source with minimum-blocks hints (padd, pdbl)."""
    for kernel, blocks in zip(("g2_padd_kernel", "g2_pdbl_kernel"), hints):
        src, n = re.subn(r"__launch_bounds__\(THREADS, \d+\)(\s+" + kernel + ")",
                         rf"__launch_bounds__(THREADS, {blocks})\1", src)
        if n != 1:
            raise ValueError(f"{kernel}: {n} __launch_bounds__ found, expected 1")
    return src


def build(hints: tuple) -> tuple:
    """(shared library, ptxas report) of g2_point.cu with these hints."""
    src = with_hints((backend.CSRC_DIR / "g2_point.cu").read_text(), hints)
    out = backend.BUILD_ROOT.parent / "launch_bounds" / "_".join(map(str, hints))
    out.mkdir(parents=True, exist_ok=True)
    (out / "g2_point.cu").write_text(src)
    lib = out / "libg2.so"
    res = subprocess.run([backend.nvcc_path(), *backend.NVCC_FLAGS, "-shared", f"-I{backend.CSRC_DIR}",
                          "-o", str(lib), str(out / "g2_point.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    return lib, kernel_stats.ptxas_report(res.stdout + res.stderr)


def _ok(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: CUDA error {rc}")


def card_ms(fn, arg_sets, reps: int) -> float:
    """Card time per call, the calls queued behind a sleep on the card."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10**8)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pairs", nargs="+", help="PADD:PDBL minimum blocks per SM")
    pairs = [tuple(int(x) for x in p.split(":")) for p in ap.parse_args(argv).pairs]
    dev = backend.device("cuda:0")
    with ThreadPoolExecutor(len(pairs)) as pool:
        built = list(pool.map(build, pairs))
    stream = backend.stream(dev)
    runs = {}
    for hints, (path, report) in zip(pairs, built):
        lib = ctypes.CDLL(str(path))
        for name in ("zk_g2_padd", "zk_g2_pdbl"):
            getattr(lib, name).argtypes = backend._SIGNATURES[name]
        for entry, regs, spills in report:
            print(f"hints {hints}: {entry} {regs} registers ({kernel_stats.blocks_per_sm(regs)} blocks of "
                  f"128 fit an SM); {spills}")

        def padd(p, q, lib=lib):
            out = torch.empty_like(p)
            _ok(lib.zk_g2_padd(p.data_ptr(), q.data_ptr(), out.data_ptr(), p.shape[-1], stream))
            return out

        def pdbl(p, times, lib=lib):
            out = torch.empty_like(p)
            _ok(lib.zk_g2_pdbl(p.data_ptr(), out.data_ptr(), p.shape[-1], times, stream))
            return out

        runs[hints] = (padd, pdbl)

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    base = pk.g2_to_device([curve.g2_mul_jac(curve.g2_generator(), 1000003 * i + 7) for i in range(64)],
                           dev)

    def pick():
        return base[..., torch.randint(0, 64, (LANES,), device=dev, generator=gen)]

    pairs_in = [(pk.padd_g2_plain(pick(), pick()), pk.padd_g2_plain(pick(), pick())) for _ in range(SETS)]
    singles = [(p,) for p, _ in pairs_in]
    ladder = [(pairs_in[0][0][..., :LADDER].contiguous(),)]
    want = (pk.padd_g2_plain(*pairs_in[0]), pk.pdbl_g2_plain(singles[0][0]),
            pk.pdbl_g2_plain(singles[0][0], WBITS))
    for hints, (padd, pdbl) in runs.items():
        got = (padd(*pairs_in[0]), pdbl(singles[0][0], 1), pdbl(singles[0][0], WBITS))
        if not all(bool((g == w).all()) for g, w in zip(got, want)):
            raise AssertionError(f"hints {hints}: K6 disagrees with the plain versions")
    print(f"every build equal to padd_g2_plain / pdbl_g2_plain on {LANES} points")
    print("card ms: padd, pdbl, pdbl times=8 at 3 x 2^14 points; pdbl times=8 at 3 lanes")
    for hints in list(runs) + list(runs)[::-1]:
        padd, pdbl = runs[hints]
        ms = (card_ms(padd, pairs_in, 16), card_ms(lambda p: pdbl(p, 1), singles, 16),
              card_ms(lambda p: pdbl(p, WBITS), singles, 8), card_ms(lambda p: pdbl(p, WBITS), ladder, 16))
        print(f"hints {hints}: " + "  ".join(f"{x:.4f}" for x in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
