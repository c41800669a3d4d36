"""BN254 (alt_bn128) curve and field parameters.

This is the scalar (pure-Python ``int``) layer of the field stack.  Batched
device kernels live in :mod:`zkfl_tpu_torch.field.limbs` and
:mod:`zkfl_tpu_torch.ops`; this module is the bit-exact reference oracle they are tested against, and it also
backs the host-side protocol code where throughput does not matter.

Parameter parity with the reference stack (circom/snarkjs over BN254):
  * ``FR`` is the scalar field modulus used everywhere in the reference
    (``tests/full_system_simulation.mjs:65`` FIELD_PRIME).
  * ``FQ`` is the base field of the curve the Groth16 proof lives on.
"""

from __future__ import annotations

# Scalar field (a.k.a. r, the group order; circuits are arithmetised over FR).
FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# Base field (a.k.a. p or q; G1/G2 coordinates live here).
FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# BN parameter x with p(x), r(x) the standard BN polynomials.
BN_X = 4965661367192848881
# Optimal-ate Miller loop count: 6x + 2.
ATE_LOOP_COUNT = 6 * BN_X + 2  # = 29793968203157093288
# The Miller loop starts from R = Q (accounting for the top bit), so
# iteration begins one bit below the MSB.
LOG_ATE_LOOP_COUNT = ATE_LOOP_COUNT.bit_length() - 2  # 63

# Curve: y^2 = x^3 + 3 over FQ.
CURVE_B = 3

# G1 generator.
G1_GEN = (1, 2)

# G2 generator over Fq2 = Fq[u]/(u^2 + 1); pairs are (c0, c1) for c0 + c1*u.
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# Two-adicity of FR - 1: FR - 1 = 2^28 * ODD.  NTT domains up to 2^28.
FR_TWO_ADICITY = 28
# Generator of the multiplicative group of FR (smallest, as used by snarkjs/ffjavascript).
FR_GENERATOR = 5
# 2^28-th primitive root of unity in FR: 5^((FR-1) / 2^28).
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR - 1) >> FR_TWO_ADICITY, FR)


def fr(x: int) -> int:
    """Canonical representative of x in FR."""
    return x % FR


def fq(x: int) -> int:
    return x % FQ


def fr_inv(x: int) -> int:
    if x % FR == 0:
        raise ZeroDivisionError("inverse of 0 in FR")
    return pow(x, FR - 2, FR)


def fq_inv(x: int) -> int:
    if x % FQ == 0:
        raise ZeroDivisionError("inverse of 0 in FQ")
    return pow(x, FQ - 2, FQ)


def fr_batch_inv(xs):
    """Montgomery batch inversion over FR: one inversion + 3(n-1) muls."""
    n = len(xs)
    if n == 0:
        return []
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        if x % FR == 0:
            raise ZeroDivisionError("inverse of 0 in FR (batch)")
        prefix[i + 1] = prefix[i] * x % FR
    inv_all = fr_inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % FR
        inv_all = inv_all * xs[i] % FR
    return out


def domain_size_for(n_constraints: int) -> int:
    """Smallest power-of-two FFT domain holding n_constraints rows."""
    size = 1
    while size < n_constraints:
        size <<= 1
    return size


def fr_nth_root(n: int) -> int:
    """Primitive n-th root of unity in FR (n a power of two <= 2^28)."""
    assert n & (n - 1) == 0 and n <= (1 << FR_TWO_ADICITY)
    root = FR_ROOT_OF_UNITY
    order = 1 << FR_TWO_ADICITY
    while order > n:
        root = root * root % FR
        order >>= 1
    return root
