"""The port's batched Poseidon, VectorHash and Merkle tree
(zkfl_tpu_torch.ops.poseidon) and its mont_sqr, held against zkfl_tpu on the
same numpy-seeded inputs.

On the CPU both sides run their plain versions: zkfl_tpu's PoseidonKernel
takes its XLA path off the TPU, the port's wrappers their plain torch
versions for CPU tensors.  Results compare as integers, exactly (tolerance
0).  The JAX side compiles only the widths and batch sizes that
tests/test_ops.py compiles already.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfl_tpu.commit.merkle import MerkleTree
from zkfl_tpu.commit.vector_hash import vector_hash
from zkfl_tpu.field.bn254 import FQ, FR
from zkfl_tpu.field.limbs import FR_FIELD
from zkfl_tpu.ops import poseidon as jax_poseidon
from zkfl_tpu.ops.limb_kernels import FQK as JFQK
from zkfl_tpu.ops.limb_kernels import FRK as JFRK
from zkfl_tpu.poseidon.grain import poseidon_params as jax_poseidon_params
from zkfl_tpu.poseidon.reference import poseidon, poseidon_permutation
from zkfl_tpu_torch.field.limbs import from_u16_limbs, to_u16_limbs
from zkfl_tpu_torch.ops.limb_kernels import FQK, FRK
from zkfl_tpu_torch.ops.poseidon import (
    PoseidonKernel,
    merkle_root_device,
    poseidon_hash_ints,
    vector_hash_device,
)
from zkfl_tpu_torch.poseidon.grain import poseidon_params

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

CPU = torch.device("cpu")
BATCH = 9  # tests/test_ops.py hashes batches of 9, so JAX reuses its compiles


def _rand(seed, p, n):
    rng = np.random.RandomState(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


def _states(t, seed):
    """BATCH states of width t, flat: all p-1, all 0, then random."""
    return [FR - 1] * t + [0] * t + _rand(seed, FR, (BATCH - 2) * t)


@pytest.mark.parametrize("t", [2, 3, 6, 17])
def test_permute_plain_matches_jax_and_reference(t):
    vals = _states(t, 100 + t)
    got = PoseidonKernel(t).permute(torch.from_numpy(FRK.pack(vals)).reshape(8, BATCH, t))
    got = FRK.unpack(got.reshape(8, BATCH * t))
    jax_out = jax_poseidon.PoseidonKernel(t).permute(
        jnp.asarray(FR_FIELD.to_mont(vals).reshape(BATCH, t, 16)))
    assert got == FR_FIELD.from_mont_host(np.asarray(jax_out).reshape(BATCH * t, 16))
    assert got == [v for i in range(BATCH) for v in poseidon_permutation(vals[i * t : (i + 1) * t])]


@pytest.mark.parametrize("arity", [1, 2, 3, 5, 16])
def test_poseidon_hash_ints_matches_jax_and_reference(arity):
    flat = _rand(200 + arity, FR, BATCH * arity)
    rows = [flat[i * arity : (i + 1) * arity] for i in range(BATCH)]
    got = poseidon_hash_ints(rows, device=CPU)
    assert got == jax_poseidon.poseidon_hash_ints(rows)
    assert got == [poseidon(row) for row in rows]


@pytest.mark.parametrize("dim", [4, 16, 17, 20, 33])
def test_vector_hash_device_matches_host(dim):
    # dim > 16: per-chunk hashes, then a hash of the hashes (last chunk short)
    flat = _rand(300 + dim, FR, 5 * dim)
    values = torch.from_numpy(FRK.pack(flat)).reshape(8, 5, dim)
    got = FRK.unpack(vector_hash_device(values))
    assert got == [vector_hash(flat[i * dim : (i + 1) * dim]) for i in range(5)]


def test_merkle_root_device_depth_4():
    depth = 4
    leaves = _rand(400, FR, 1 << depth)
    tree = MerkleTree(leaves, depth)
    root, levels = merkle_root_device(torch.from_numpy(FRK.pack(leaves)), depth)
    assert FRK.unpack(root[:, None]) == [tree.root]
    assert [FRK.unpack(lv) for lv in levels] == tree.levels
    with pytest.raises(ValueError):
        merkle_root_device(torch.from_numpy(FRK.pack(leaves[:15])), depth)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_sqr_matches_jax(name):
    ours, theirs, p = {"fr": (FRK, JFRK, FR), "fq": (FQK, JFQK, FQ)}[name]
    vals = _rand(500, p, BATCH) + [0, 1, p - 1]
    a = ours.pack(vals)
    got = ours.mont_sqr(torch.from_numpy(a))
    want = from_u16_limbs(np.asarray(theirs.mont_sqr(jnp.asarray(to_u16_limbs(a)))))
    assert np.array_equal(got.numpy(), want)
    assert ours.unpack(got) == [v * v % p for v in vals]


@pytest.mark.parametrize("t", range(2, 18))
def test_poseidon_params_match_jax(t):
    assert poseidon_params(t) == jax_poseidon_params(t)


def test_poseidon_kernel_cached_and_checks_width():
    assert PoseidonKernel(3) is PoseidonKernel(3)
    with pytest.raises(ValueError):
        PoseidonKernel(18)
    with pytest.raises(ValueError):
        PoseidonKernel(3).permute(torch.zeros((8, 2, 4), dtype=torch.int32))
