"""Static facts of the built CUDA kernels: ptxas's registers and spills per
entry function, and SASS instruction counts from cuobjdump.

    python -m zkfl_tpu_torch.kernel_stats [LIB]

prints ptxas's report (from the build.log beside LIB) and the SASS counts of
the product kernels in LIB, per field product: the point kernels (K4, K6)
per Fq product, K1 per Fr or Fq product, K5 per Fr product, K3 per lane
(default LIB: this checkout's build, built first if needed).  Needs the
CUDA toolkit (nvcc, cuobjdump); no card.  chip_smoke.py prints the same
report in its build phase.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

from . import backend

# Multiply-adds of a product left unreduced (a 512-bit product, or a
# product's rows in a sum reduced once) and of a reduction, in products (136
# multiply-adds): K5 and K6 inline both, and together they make one.
WIDE, REDC = 64 / 136, 72 / 136
# entry name -> Fq products per thread in the kernel body (pdbl's body is
# one doubling of its loop).  K4: one point a thread, every product
# reduced.  K6: one Fq2 coefficient a thread (bn254.cuh Fq2Lane); padd's 6
# lazy products (2 unreduced products and a reduction each) and 3 sums of
# two (4 and 1), and 2 products by b3; pdbl's 4 lazy products and 1 sum of
# two, 2 squarings and 1 product by b3.
PRODUCTS = {"g1_padd": 14, "g1_pdbl": 9,
            "g2_padd": 24 * WIDE + 9 * REDC + 2, "g2_pdbl": 12 * WIDE + 5 * REDC + 3}
# K1 op (csrc/field_ew.cu enum Op) -> products a thread; from_mont's
# reduction counts as one.  add (1) and sub (2) have none.
FIELD_PRODUCTS = {0: 1, 3: 1, 4: 1, 5: 1, 6: 2, 7: 1}
ENTRIES = ("field_ew", "butterfly", "normalize_raw", "g1_padd", "g1_pdbl", "g2_padd", "g2_pdbl",
           "poseidon")
REGS_PER_SM = 65536
THREADS = 128  # the point kernels' block size


def entry_name(mangled: str) -> str:
    """A readable name for a mangled kernel symbol: its entry, then the field
    and op (K1) or the width (K5)."""
    name = next((k for k in ENTRIES if f"{k}_kernel" in mangled), mangled)
    m = re.search(r"IN2zk2(F[rq])ELi(\d)E", mangled)
    name += f"<{m.group(1)}, op {m.group(2)}>" if m else ""
    m = re.search(r"poseidon_kernelILi(\d+)E", mangled)
    return name + (f"<t={m.group(1)}>" if m else "")


def ptxas_report(log: str) -> list:
    """[(entry, registers, spill line)] from nvcc -Xptxas -v output."""
    out, entry, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = entry_name(line.split("'")[1])
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and entry:
            out.append((entry, int(line.split("Used")[1].split()[0]), spills))
    return out


def blocks_per_sm(registers: int, threads: int = THREADS) -> int:
    """Blocks of ``threads`` that the SM's register file holds (registers
    allocated in units of 8 a thread)."""
    return REGS_PER_SM // (threads * -(-registers // 8) * 8)


def sass_counts(binary: Path) -> dict:
    """{entry: Counter of SASS opcode classes} for every kernel in a built
    library: "all", "imad" (IMAD* multiply-adds, not the IMAD.MOV /
    IMAD.SHL / IMAD.IADD forms ptxas uses as moves and shifts), "iadd3",
    "shfl"."""
    nvcc = backend.nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    res = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "--dump-sass", str(binary)],
                         capture_output=True, text=True, check=True)
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            name = entry_name(mangled)
            if name in counts:  # another function of the same entry: keep it apart
                name = f"{name} [{mangled}]"
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is None or m is None:
            continue
        op = m.group(2)
        c = counts[name]
        c["all"] += 1
        if op.startswith("IMAD") and not op.startswith(("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")):
            c["imad"] += 1
        elif op.startswith("IADD3"):
            c["iadd3"] += 1
        elif op.startswith("SHFL"):
            c["shfl"] += 1
    return counts


def poseidon_reg_max_t() -> int:
    """poseidon.cuh's POSEIDON_REG_MAX_T: the widest K5 state kept in
    registers with its lane loops unrolled."""
    src = (backend.CSRC_DIR / "poseidon.cuh").read_text()
    return int(re.search(r"POSEIDON_REG_MAX_T = (\d+);", src).group(1))


def poseidon_products(t: int, reg_max: int) -> float:
    """Products in K5's code for width t (each inlined copy once): the two
    inlined full rounds (t S-boxes of 3 products, t^2 wide products, t
    reductions; with the lane loops rolled, one of each) and the partial
    round (an S-box, t wide products and a reduction for lane 0, t - 1
    products for the others; rolled, one of each)."""
    lanes = t if t <= reg_max else 1
    full = 3 * lanes + lanes * lanes * WIDE + lanes * REDC
    partial = 3 + lanes * WIDE + REDC + (t - 1 if t <= reg_max else 1)
    return 2 * full + partial


def products_of(name: str, reg_max: int):
    """(products a thread, field) of a kernel entry, or None."""
    base = name.split(" [")[0]
    if base in PRODUCTS:
        return PRODUCTS[base], "Fq"
    m = re.fullmatch(r"field_ew<(F[rq]), op (\d)>", base)
    if m and int(m.group(2)) in FIELD_PRODUCTS:
        return FIELD_PRODUCTS[int(m.group(2))], m.group(1)
    m = re.fullmatch(r"poseidon<t=(\d+)>", base)
    if m:
        return poseidon_products(int(m.group(1)), reg_max), "Fr"
    return None


def product_sass_lines(binary: Path) -> list:
    """One line per kernel entry with field products (K1, K4, K5, K6): SASS
    instructions in all and per product; and K3's, whose loop body is one
    lane (no product: a fold and a quotient step)."""
    lines, reg_max = [], poseidon_reg_max_t()
    for name, c in sorted(sass_counts(binary).items()):
        if name == "normalize_raw":
            lines.append(f"{name}: {c['all']} SASS instructions, {c['imad']} IMAD, "
                         f"{c['iadd3']} IADD3 (one lane per loop iteration)")
        got = products_of(name, reg_max)
        if got:
            k, field = got
            lines.append(f"{name}: {c['all']} SASS instructions, {c['imad']} IMAD, "
                         f"{c['iadd3']} IADD3, {c['shfl']} SHFL; per {field} product "
                         f"{c['all'] / k:.1f} instructions, {c['imad'] / k:.1f} IMAD "
                         f"({k:g} products a thread)")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lib", nargs="?", help="shared library to dump (default: this checkout's build)")
    lib = Path(ap.parse_args(argv).lib or backend.build())
    lines = [f"{entry}: {regs} registers ({blocks_per_sm(regs)} blocks of {THREADS} fit an SM); "
             f"{spills}" for entry, regs, spills in ptxas_report((lib.parent / "build.log").read_text())]
    print("\n".join(lines + product_sass_lines(lib)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
