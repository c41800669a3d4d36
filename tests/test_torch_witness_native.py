"""The Poseidon gadget's witness (csrc/host ``poseidon_witness``) against
the reference package's Python: the same S-box wires and hash as
``zkfl_tpu``'s gadget at every width, the same whole witness as
``zkfl_tpu``'s for every circuit of the port, each witness satisfying its
structure-mode R1CS, and the ``r1cs.poseidon`` counter."""

import random
from functools import lru_cache
from importlib import import_module
from types import SimpleNamespace

import pytest
import torch

from zkfl_tpu.r1cs.builder import ConstraintSystem as RefCS
from zkfl_tpu.r1cs.gadgets import poseidon_gadget as ref_poseidon_gadget
from zkfl_tpu_torch import native, trace
from zkfl_tpu_torch.commit.vector_hash import poseidon
from zkfl_tpu_torch.field.bn254 import FR
from zkfl_tpu_torch.poseidon.grain import R_F, partial_rounds
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem
from zkfl_tpu_torch.r1cs.circuits import build_structure
from zkfl_tpu_torch.r1cs.gadgets import poseidon_gadget

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)

PORT, REF = "zkfl_tpu_torch", "zkfl_tpu"


@lru_cache(maxsize=None)
def _pkg(name: str) -> SimpleNamespace:
    """What the cases build inputs and witnesses with, from the port or
    from the reference package (the same relative paths in both)."""
    names = {
        "fl.client": ["Client", "SharedLCG"],
        "fl.config": ["REFERENCE_CONFIG"],
        "fl.simulation": ["simulate_key_exchange"],
        "commit.merkle": ["MerkleTree"],
        "commit.vector_hash": ["gradient_commitment", "poseidon", "sample_hash", "vector_hash"],
        "r1cs.balance": ["BalanceParams"],
        "r1cs.circuits": ["generate_witness"],
        "r1cs.secagg": ["SecaggLegacyParams", "derive_legacy_mask"],
        "r1cs.tiny": ["TinyParams"],
        "r1cs.training": ["TrainingParams"],
    }
    return SimpleNamespace(**{n: getattr(import_module(f"{name}.{mod}"), n)
                              for mod, ns in names.items() for n in ns})


def _gadget(cs, gadget, values):
    out = gadget(cs, cs.private_inputs("x", values))
    return cs.values, out.value


@pytest.mark.parametrize("kind", ["random", "zeros", "p_minus_1"])
@pytest.mark.parametrize("t", range(2, 18))
def test_gadget_wires_equal_the_python_branch(t, kind):
    """The native wires against zkfl_tpu's gadget, the Python loop."""
    values = {
        "random": [random.Random(1000 * t + 7).randrange(FR) for _ in range(t - 1)],
        "zeros": [0] * (t - 1),
        "p_minus_1": [FR - 1] * (t - 1),
    }[kind]
    ours, out = _gadget(ConstraintSystem(witness_only=True), poseidon_gadget, values)
    theirs, out_ref = _gadget(RefCS(witness_only=True), ref_poseidon_gadget, values)
    assert len(ours) == len(theirs) == 1 + (t - 1) + 3 * (R_F * t + partial_rounds(t))
    assert ours == theirs
    assert out == out_ref == poseidon(values)


@pytest.mark.parametrize("n_inputs", [0, 17])
def test_native_witness_rejects_a_width_outside_2_to_17(n_inputs):
    with pytest.raises(ValueError):
        native.poseidon_witness([1] * n_inputs)


def _balance(m, n, depth, dim, seed):
    rng = random.Random(seed)
    feats = [[rng.randrange(1000) for _ in range(dim)] for _ in range(n)]
    labels = [i % 2 for i in range(n)]
    tree = m.MerkleTree([m.sample_hash(feats[i], labels[i]) for i in range(n)], depth)
    paths = [tree.prove(i) for i in range(n)]
    return m.BalanceParams(n=n, depth=depth, model_dim=dim), {
        "client_id": 1, "root": tree.root, "N_public": n,
        "c0": n - sum(labels), "c1": sum(labels),
        "features": feats, "labels": labels,
        "siblings": [p[0] for p in paths], "pathIndices": [p[1] for p in paths],
    }


def _reference_client(m):
    client = m.Client(1, m.REFERENCE_CONFIG, None)
    client.generate_private_dataset(m.SharedLCG(m.REFERENCE_CONFIG.seed))
    client.compute_dataset_commitment()
    return client


def _verified(m):
    client = _reference_client(m)
    model = [3, -2, 5, 1]
    return m.REFERENCE_CONFIG.training_params, lambda: client.training_witness(model)


def _v5(m):
    cfg, client = m.REFERENCE_CONFIG, _reference_client(m)
    grad = [17, -250, 0, 4096]
    grad_pos = [g if g > 0 else 0 for g in grad]
    grad_neg = [-g if g < 0 else 0 for g in grad]
    sib, idx = client._merkle_paths(cfg.batch_size)
    params = m.TrainingParams(batch_size=cfg.batch_size, model_dim=cfg.model_dim, depth=cfg.depth,
                              precision=cfg.precision, variant="v5")
    return params, {
        "client_id": 1, "round": 1, "root_D": client.root_d,
        "root_G": m.gradient_commitment([g % FR for g in grad], 1, 1),
        "tauSquared": sum(g * g for g in grad) + 1,
        "gradPos": grad_pos, "gradNeg": grad_neg,
        "features": client.features[:cfg.batch_size], "labels": client.labels[:cfg.batch_size],
        "siblings": sib, "pathIndices": idx,
    }


def _secagg(m):
    cfg, client = m.REFERENCE_CONFIG, _reference_client(m)
    client.training_witness([0] * cfg.model_dim)
    keys = m.simulate_key_exchange(cfg.num_clients)
    return cfg.secagg_params, lambda: client.secagg_witness(keys)


def _secagg_legacy(m):
    params, prf_seed, client_id = m.SecaggLegacyParams(dim=8), 424242, 1
    gradient = [(i * 7 + 3) % 100 for i in range(params.dim)]
    mask = m.derive_legacy_mask(prf_seed, client_id, params.dim)
    return params, {
        "client_id": client_id, "shared_key_hash": m.poseidon([prf_seed]),
        "root_G": m.vector_hash(gradient), "tauSquared": 10**8,
        "masked_update": [(g + k) % FR for g, k in zip(gradient, mask)],
        "gradient": gradient, "mask": mask, "prf_seed": prf_seed,
    }


def _tiny(m, simple):
    params = m.TinyParams(simple=simple)
    B, D, depth = params.batch_size, params.model_dim, params.depth
    n_leaves = 1 << depth
    feats = [[(i * D + j + 1) * 10 for j in range(D)] for i in range(n_leaves)]
    labels = [i % 2 for i in range(n_leaves)]
    leaves = [m.poseidon([labels[i]]) if simple else m.vector_hash(feats[i] + [labels[i]])
              for i in range(n_leaves)]
    tree = m.MerkleTree(leaves, depth)
    paths = [tree.prove(i) for i in range(B)]
    gradient = [sum(feats[i][j] for i in range(B)) % FR for j in range(D)]
    return params, {
        "client_id": 1, "root_D": tree.root,
        "root_G": m.poseidon(gradient) if simple else m.vector_hash(gradient),
        "alpha": 10, "tau": 1000, "weights_old": [0] * D,
        "features": feats[:B], "labels": labels[:B],
        "siblings": [p[0] for p in paths], "pathIndices": [p[1] for p in paths],
    }


# Each case, given a package's names: (params, inputs) for generate_witness,
# or (params, a function that returns the witness) where a client builds its
# own inputs.
CASES = {
    "balance_8_3_4": lambda m: _balance(m, 8, 3, 4, seed=11),
    "balance_2_2_16": lambda m: _balance(m, 2, 2, 16, seed=12),
    "training_verified": _verified,
    "training_v5": _v5,
    "secagg": _secagg,
    "secagg_legacy": _secagg_legacy,
    "tiny": lambda m: _tiny(m, False),
    "tiny_simple": lambda m: _tiny(m, True),
}


def _witness(case, pkg):
    m = _pkg(pkg)
    params, source = CASES[case](m)
    return params, source() if callable(source) else m.generate_witness(params, source).witness


@lru_cache(maxsize=None)
def _native_witness(case):
    return _witness(case, PORT)


@pytest.mark.parametrize("case", CASES)
def test_whole_witness_equals_the_python_branch(case):
    """The port's witness, its gadgets' wires from csrc/host, against
    zkfl_tpu's, each built from its own package's inputs."""
    ours = _native_witness(case)[1]
    assert ours == _witness(case, REF)[1]


@pytest.mark.parametrize("case", CASES)
def test_native_witness_satisfies_the_structure(case):
    params, witness = _native_witness(case)
    cs = build_structure(params)
    assert len(witness) == cs.n_wires
    cs.values = list(witness)
    assert cs.is_satisfied()


def test_native_counter_equals_the_gadget_counter():
    m = _pkg(PORT)
    params, inputs = _balance(m, 2, 2, 16, seed=13)
    trace.enable()
    try:
        m.generate_witness(params, inputs)
    finally:
        trace.disable()
        _, counters = trace.take()
    # Per sample: the t=17, t=2 and t=3 chunked leaf and 2 Merkle levels.
    assert counters["r1cs.poseidon"] == 2 * (3 + 2)
    assert "r1cs.poseidon_native" not in counters
