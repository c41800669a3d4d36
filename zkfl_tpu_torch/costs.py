"""The port's cost model: the fewest 32-bit multiply-adds and bytes of each
kernel op, and the least time one NVIDIA H100 could take for them.

The bound of a call is the larger of its bytes over the memory rate (H100
SXM, NVIDIA's data sheet) and its multiply-adds over the integer rate.  The
integer rate is derived, not a data-sheet figure: 132 SMs x 64 INT32 lanes
x the SM clock, one 32-bit multiply-add per lane a cycle (16.73 T/s at the
1980 MHz maximum).  How many wide multiply-adds the card starts a cycle has
not been measured, so a bound "by operations" may be off by up to 2x.
"""

from __future__ import annotations

from .poseidon.grain import R_F, partial_rounds

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES = 132, 64
MONT = 2 * 8 * 8 + 8     # 32-bit multiply-adds of one CIOS Montgomery product
SQR = 8 * 9 // 2 + 8 * 8 + 8  # of a Montgomery squaring (each cross product once)
REDC = 8 * 8 + 8         # of a Montgomery reduction alone (a product by 1)
WIDE = 8 * 8             # of a 512-bit product left unreduced
NORMALIZE = 8 + 4 + 8    # of normalize_raw: fold top (R mod p), the 64-bit quotient, q p


def int32_peak(sm_mhz: float) -> float:
    """The derived integer rate, 32-bit multiply-adds a second, at an SM
    clock of ``sm_mhz``."""
    return SMS * INT32_LANES * sm_mhz * 1e6


def poseidon_madds(t: int) -> int:
    """32-bit multiply-adds of one width-t permutation, the fewest of a
    correct design (the optimized form, zkfl_tpu_torch/poseidon/optimized.py):
    x^5 (two squarings and a product) on t lanes in the R_F full rounds, then
    a mix of t^2 wide products (WIDE each) and one reduction per lane; x^5 on
    one lane in the R_P partial ones, then a t-term sparse row (t wide
    products and a reduction) and t - 1 products for the column."""
    sbox = 2 * SQR + MONT
    full = t * sbox + t * t * WIDE + t * REDC
    partial = sbox + t * WIDE + REDC + (t - 1) * MONT
    return R_F * full + partial_rounds(t) * partial


# Point op -> (32-bit multiply-adds, bytes read + written) per point: the
# fewest of a correct design of RCB15 alg. 7 (add: 12 products and 2 by b3)
# and 9 (double: 6 products, 2 squarings and 1 by b3).  G1: b3 = 9 takes
# additions.  G2, with lazy reduction: an Fq2 product is 3 products left
# unreduced and 2 reductions (Karatsuba), a sum of two Fq2 products 6 and 2,
# a squaring 2 Fq products, a product by b3 = (9/82)(9 - u) additions and 2
# Fq products.  G2 add: 6 products, 3 sums of two (X3, Y3, Z3) and 2 by
# b3 = 4,144; double: 4 products, 2 squarings, 1 sum of two (Y3) and 1 by
# b3 = 2,688.
FQ2_MUL, FQ2_MUL_ADD = 3 * WIDE + 2 * REDC, 6 * WIDE + 2 * REDC
POINT_COST = {"g1.padd": (12 * MONT, 288), "g1.pdbl": (6 * MONT + 2 * SQR, 192),
              "g2.padd": (6 * FQ2_MUL + 3 * FQ2_MUL_ADD + 2 * 2 * MONT, 576),
              "g2.pdbl": (4 * FQ2_MUL + 2 * 2 * MONT + FQ2_MUL_ADD + 2 * MONT, 384)}


def op_cost(name: str):
    """(32-bit multiply-adds, bytes read + written) per lane of op ``name``:
    "<field>.<op>", then " t=<width>" or " times=<doublings>"."""
    base, _, arg = name.partition(" ")
    if base == "fr.poseidon":
        t = int(arg.split("t=")[1])
        return poseidon_madds(t), 2 * t * 32
    if base in POINT_COST:
        madds, nbytes = POINT_COST[base]
        times = int(arg.split("times=")[1]) if arg else 1
        return madds * times, nbytes
    return {
        "mont_mul": (MONT, 96), "mont_sqr": (SQR, 64), "add": (0, 96), "sub": (0, 96),
        "to_mont": (MONT, 64), "from_mont": (REDC, 64), "mont_mul_const": (MONT, 64),
        "mul_sub_mul_const": (2 * MONT, 128), "butterfly": (MONT, 160),
        "normalize_raw": (NORMALIZE, 96),
    }[base.split(".", 1)[1]]


def bound(name: str, lanes: int, sm_mhz: float):
    """(bound_ms, bound_by) of one call over ``lanes`` lanes: the larger of
    the bytes over the memory rate and the multiply-adds over the integer
    rate."""
    madds, nbytes = op_cost(name)
    t_bytes = lanes * nbytes / HBM_BYTES_PER_S
    t_ops = lanes * madds / int32_peak(sm_mhz)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
