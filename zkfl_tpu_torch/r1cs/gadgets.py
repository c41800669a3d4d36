"""Reusable constraint gadgets: bit decomposition, comparators, Poseidon,
Merkle membership, vector hashing.

Semantics replicate the circomlib templates the reference circuits include
(comparators.circom, bitify.circom) and the project's own templates
(src/circuits/lib/{poseidon,merkle}.circom,
src/circuits/training/vector_hash.circom).  Exact LessThan bit-widths matter:
regenerated witnesses must satisfy the same constraint shapes the reference
uses (64/80/128-bit comparisons at sgd_verified.circom:144,
sgd_step_v5.circom:70,138-152, secure_masked_update.circom:65,114,176).
"""

from __future__ import annotations

from typing import List, Sequence

from ..field.bn254 import FR
from ..poseidon.grain import R_F, partial_rounds, poseidon_params
from .builder import ConstraintSystem, LinComb


def num2bits(cs: ConstraintSystem, v: LinComb, n: int) -> List[LinComb]:
    """circomlib Num2Bits: n bit wires, booleanity + recomposition."""
    val = v.value
    if cs.witness_only:
        # fast path: same wire-allocation order, no symbolic bookkeeping
        vals = cs.values
        bits = []
        for i in range(n):
            b = (val >> i) & 1
            vals.append(b)
            bits.append(LinComb(cs, None, b))
        return bits
    bits = []
    acc = cs.zero()
    for i in range(n):
        b = cs.witness_wire((val >> i) & 1)
        cs.enforce_bool(b)
        bits.append(b)
        acc = acc + b * (1 << i)
    cs.enforce_equal(acc, v)
    return bits


def less_than(cs: ConstraintSystem, a: LinComb, b: LinComb, n: int) -> LinComb:
    """circomlib LessThan(n): out = 1 iff a < b (both assumed < 2^n)."""
    shifted = a + (1 << n) - b
    bits = num2bits(cs, shifted, n + 1)
    return cs.one() - bits[n]


def less_eq_than(cs: ConstraintSystem, a: LinComb, b: LinComb, n: int) -> LinComb:
    """circomlib LessEqThan(n): a <= b  ==  a < b + 1."""
    return less_than(cs, a, b + 1, n)


def poseidon_gadget(cs: ConstraintSystem, inputs: Sequence[LinComb]) -> LinComb:
    """In-circuit Poseidon hash of 1..16 LinCombs; returns the output LinComb.

    Only S-box multiplications allocate constraints (3 per x^5); the ARK and
    MDS layers stay symbolic, matching circom's post-optimisation cost of
    ~150-250 constraints per hash (src/circuits/lib/poseidon.circom:26).
    """
    t = len(inputs) + 1
    C, M = poseidon_params(t)
    rp = partial_rounds(t)
    rf_half = R_F // 2

    if cs.witness_only:
        # Fast path: the whole permutation as plain int arithmetic with the
        # EXACT wire-allocation order of the symbolic branch (x^2, x^4, x^5
        # per S-box; full rounds touch all t elements, partial rounds only
        # element 0).  ~6x faster than LinComb bookkeeping — the witness
        # hot loop (SURVEY §7.4; reference WASM calculator does 45 ms for
        # balance(8,3,4), this path brings us under it).
        vals = cs.values
        state_v = [0] + [x.value for x in inputs]
        idx = 0
        for r in range(R_F + rp):
            state_v = [(x + C[idx + i]) % FR for i, x in enumerate(state_v)]
            idx += t
            sbox_range = range(t) if (r < rf_half or r >= rf_half + rp) else (0,)
            for i in sbox_range:
                x = state_v[i]
                x2 = x * x % FR
                x4 = x2 * x2 % FR
                x5 = x4 * x % FR
                vals.append(x2)
                vals.append(x4)
                vals.append(x5)
                state_v[i] = x5
            state_v = [
                sum(state_v[j] * M[i][j] for j in range(t)) % FR
                for i in range(t)
            ]
        return LinComb(cs, None, state_v[0])

    state: List[LinComb] = [cs.zero()] + list(inputs)
    idx = 0

    def sbox(x: LinComb) -> LinComb:
        x2 = cs.square(x)
        x4 = cs.square(x2)
        return cs.mul(x4, x)

    for r in range(R_F + rp):
        state = [x + C[idx + i] for i, x in enumerate(state)]
        idx += t
        if r < rf_half or r >= rf_half + rp:
            state = [sbox(x) for x in state]
        else:
            state[0] = sbox(state[0])
        state = [sum((state[j] * M[i][j] for j in range(t)), cs.zero()) for i in range(t)]
    return state[0]


def vector_hash_gadget(cs: ConstraintSystem, values: Sequence[LinComb], chunk_size: int = 16) -> LinComb:
    """VectorHash template: direct hash up to 16 values, else 16-ary chunked
    hash-of-hashes with UNPADDED final chunk (vector_hash.circom:46-89)."""
    if len(values) <= chunk_size:
        return poseidon_gadget(cs, values)
    chunk_hashes = [
        poseidon_gadget(cs, values[i : i + chunk_size]) for i in range(0, len(values), chunk_size)
    ]
    return poseidon_gadget(cs, chunk_hashes)


def merkle_proof_gadget(
    cs: ConstraintSystem,
    leaf: LinComb,
    siblings: Sequence[LinComb],
    path_indices: Sequence[LinComb],
    root: LinComb,
):
    """MerkleProofVerifier(DEPTH) (merkle.circom:34-88): walk up with
    bit-selected ordering, final equality against the public root."""
    cur = leaf
    for sib, bit in zip(siblings, path_indices):
        cs.enforce_bool(bit)
        # left = cur + bit*(sib-cur); right = sib + bit*(cur-sib)
        left = cur + bit * (sib - cur)
        right = sib + bit * (cur - sib)
        cur = poseidon_gadget(cs, [left, right])
    cs.enforce_equal(root, cur)


def gradient_commitment_gadget(
    cs: ConstraintSystem, gradient: Sequence[LinComb], client_id: LinComb, round_num: LinComb
) -> LinComb:
    """GradientCommitment (vector_hash.circom:195-218):
    Poseidon(VectorHash(g), Poseidon(client_id, round))."""
    grad_hash = vector_hash_gadget(cs, gradient)
    meta_hash = poseidon_gadget(cs, [client_id, round_num])
    return poseidon_gadget(cs, [grad_hash, meta_hash])
