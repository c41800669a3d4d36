"""The Poseidon gadget's native witness path (csrc/host ``poseidon_witness``)
against its Python twin: the same S-box wires and hash at every width, the
same whole witness for every circuit of the port, each witness satisfying
its structure-mode R1CS, and the ``r1cs.poseidon_native`` counter."""

import random
from functools import lru_cache

import pytest
import torch

from zkfl_tpu_torch import native, trace
from zkfl_tpu_torch.commit.merkle import MerkleTree
from zkfl_tpu_torch.commit.vector_hash import gradient_commitment, poseidon, sample_hash, vector_hash
from zkfl_tpu_torch.field.bn254 import FR
from zkfl_tpu_torch.fl.client import Client, SharedLCG
from zkfl_tpu_torch.fl.config import REFERENCE_CONFIG
from zkfl_tpu_torch.fl.simulation import simulate_key_exchange
from zkfl_tpu_torch.poseidon.grain import R_F, partial_rounds
from zkfl_tpu_torch.r1cs.balance import BalanceParams
from zkfl_tpu_torch.r1cs.builder import ConstraintSystem
from zkfl_tpu_torch.r1cs.circuits import build_structure, generate_witness
from zkfl_tpu_torch.r1cs.gadgets import poseidon_gadget
from zkfl_tpu_torch.r1cs.secagg import SecaggLegacyParams, derive_legacy_mask
from zkfl_tpu_torch.r1cs.tiny import TinyParams
from zkfl_tpu_torch.r1cs.training import TrainingParams

# pytest-xdist workers share the cores: torch's own thread pool in each of
# them would oversubscribe the machine many times over.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def needs_the_native_library():
    if not native.available():
        pytest.skip("the native host library does not build (no g++)")


def _python_path(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def _gadget(values):
    cs = ConstraintSystem(witness_only=True)
    xs = cs.private_inputs("x", values)
    out = poseidon_gadget(cs, xs)
    return cs.values, out.value


@pytest.mark.parametrize("kind", ["random", "zeros", "p_minus_1"])
@pytest.mark.parametrize("t", range(2, 18))
def test_gadget_wires_equal_the_python_branch(t, kind, monkeypatch):
    values = {
        "random": [random.Random(1000 * t + 7).randrange(FR) for _ in range(t - 1)],
        "zeros": [0] * (t - 1),
        "p_minus_1": [FR - 1] * (t - 1),
    }[kind]
    ours, out = _gadget(values)
    _python_path(monkeypatch)
    theirs, out_py = _gadget(values)
    assert len(ours) == len(theirs) == 1 + (t - 1) + 3 * (R_F * t + partial_rounds(t))
    assert ours == theirs
    assert out == out_py == poseidon(values)


@pytest.mark.parametrize("n_inputs", [0, 17])
def test_native_witness_rejects_a_width_outside_2_to_17(n_inputs):
    with pytest.raises(ValueError):
        native.poseidon_witness([1] * n_inputs)


def _balance(n, depth, dim, seed):
    rng = random.Random(seed)
    feats = [[rng.randrange(1000) for _ in range(dim)] for _ in range(n)]
    labels = [i % 2 for i in range(n)]
    tree = MerkleTree([sample_hash(feats[i], labels[i]) for i in range(n)], depth)
    paths = [tree.prove(i) for i in range(n)]
    return BalanceParams(n=n, depth=depth, model_dim=dim), {
        "client_id": 1, "root": tree.root, "N_public": n,
        "c0": n - sum(labels), "c1": sum(labels),
        "features": feats, "labels": labels,
        "siblings": [p[0] for p in paths], "pathIndices": [p[1] for p in paths],
    }


def _reference_client():
    client = Client(1, REFERENCE_CONFIG, None)
    client.generate_private_dataset(SharedLCG(REFERENCE_CONFIG.seed))
    client.compute_dataset_commitment()
    return client


def _verified():
    client = _reference_client()
    model = [3, -2, 5, 1]
    return REFERENCE_CONFIG.training_params, lambda: client.training_witness(model)


def _v5():
    cfg, client = REFERENCE_CONFIG, _reference_client()
    grad = [17, -250, 0, 4096]
    grad_pos = [g if g > 0 else 0 for g in grad]
    grad_neg = [-g if g < 0 else 0 for g in grad]
    sib, idx = client._merkle_paths(cfg.batch_size)
    params = TrainingParams(batch_size=cfg.batch_size, model_dim=cfg.model_dim, depth=cfg.depth,
                            precision=cfg.precision, variant="v5")
    return params, {
        "client_id": 1, "round": 1, "root_D": client.root_d,
        "root_G": gradient_commitment([g % FR for g in grad], 1, 1),
        "tauSquared": sum(g * g for g in grad) + 1,
        "gradPos": grad_pos, "gradNeg": grad_neg,
        "features": client.features[:cfg.batch_size], "labels": client.labels[:cfg.batch_size],
        "siblings": sib, "pathIndices": idx,
    }


def _secagg():
    client = _reference_client()
    client.training_witness([0] * REFERENCE_CONFIG.model_dim)
    keys = simulate_key_exchange(REFERENCE_CONFIG.num_clients)
    return REFERENCE_CONFIG.secagg_params, lambda: client.secagg_witness(keys)


def _secagg_legacy():
    params, prf_seed, client_id = SecaggLegacyParams(dim=8), 424242, 1
    gradient = [(i * 7 + 3) % 100 for i in range(params.dim)]
    mask = derive_legacy_mask(prf_seed, client_id, params.dim)
    return params, {
        "client_id": client_id, "shared_key_hash": poseidon([prf_seed]),
        "root_G": vector_hash(gradient), "tauSquared": 10**8,
        "masked_update": [(g + m) % FR for g, m in zip(gradient, mask)],
        "gradient": gradient, "mask": mask, "prf_seed": prf_seed,
    }


def _tiny(simple):
    params = TinyParams(simple=simple)
    B, D, depth = params.batch_size, params.model_dim, params.depth
    n_leaves = 1 << depth
    feats = [[(i * D + j + 1) * 10 for j in range(D)] for i in range(n_leaves)]
    labels = [i % 2 for i in range(n_leaves)]
    leaves = [poseidon([labels[i]]) if simple else vector_hash(feats[i] + [labels[i]]) for i in range(n_leaves)]
    tree = MerkleTree(leaves, depth)
    paths = [tree.prove(i) for i in range(B)]
    gradient = [sum(feats[i][j] for i in range(B)) % FR for j in range(D)]
    return params, {
        "client_id": 1, "root_D": tree.root,
        "root_G": poseidon(gradient) if simple else vector_hash(gradient),
        "alpha": 10, "tau": 1000, "weights_old": [0] * D,
        "features": feats[:B], "labels": labels[:B],
        "siblings": [p[0] for p in paths], "pathIndices": [p[1] for p in paths],
    }


# Each case: (params, inputs) for generate_witness, or (params, a function
# that returns the witness) where a client builds its own inputs.
CASES = {
    "balance_8_3_4": lambda: _balance(8, 3, 4, seed=11),
    "balance_2_2_16": lambda: _balance(2, 2, 16, seed=12),
    "training_verified": _verified,
    "training_v5": _v5,
    "secagg": _secagg,
    "secagg_legacy": _secagg_legacy,
    "tiny": lambda: _tiny(False),
    "tiny_simple": lambda: _tiny(True),
}


def _witness(params, source):
    return source() if callable(source) else generate_witness(params, source).witness


@lru_cache(maxsize=None)
def _native_witness(case):
    params, source = CASES[case]()
    return params, _witness(params, source)


@pytest.mark.parametrize("case", CASES)
def test_whole_witness_equals_the_python_branch(case, monkeypatch):
    params, source = CASES[case]()
    ours = _witness(params, source)
    assert ours == _native_witness(case)[1]
    _python_path(monkeypatch)
    assert ours == _witness(params, source)


@pytest.mark.parametrize("case", CASES)
def test_native_witness_satisfies_the_structure(case):
    params, witness = _native_witness(case)
    cs = build_structure(params)
    assert len(witness) == cs.n_wires
    cs.values = list(witness)
    assert cs.is_satisfied()


def test_native_counter_equals_the_gadget_counter():
    params, inputs = _balance(2, 2, 16, seed=13)
    trace.enable()
    try:
        generate_witness(params, inputs)
    finally:
        trace.disable()
        _, counters = trace.take()
    # Per sample: the t=17, t=2 and t=3 chunked leaf and 2 Merkle levels.
    assert counters["r1cs.poseidon_native"] == counters["r1cs.poseidon"] == 2 * (3 + 2)
