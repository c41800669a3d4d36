"""The plain reference (zkbench/plain) against the port's own host code,
and the traffic's determinism by seed."""

import random

import pytest

from zkbench.plain import bn254, commit, fl_round, poseidon, prod_round
from zkbench.run import round_seed


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 16])
def test_poseidon_equals_the_port(width):
    from zkfl_tpu_torch.poseidon.reference import poseidon as port

    rng = random.Random(width)
    xs = [rng.randrange(poseidon.R) for _ in range(width)]
    assert poseidon.poseidon(xs) == port(xs)


def test_commitments_equal_the_port():
    from zkfl_tpu_torch.commit.merkle import MerkleTree
    from zkfl_tpu_torch.commit import vector_hash as vh

    rng = random.Random(7)
    rows = [[rng.randrange(1000) for _ in range(17)] for _ in range(5)]
    leaves = [commit.vector_hash(r) for r in rows]
    assert leaves == [vh.vector_hash(r) for r in rows]
    assert commit.merkle_root(leaves, 3) == MerkleTree(leaves, 3).root
    grad = [rng.randrange(-50, 50) for _ in range(4)]
    assert commit.gradient_commitment(grad, 2, 1) == \
        vh.gradient_commitment([g % poseidon.R for g in grad], 2, 1)


def test_pairing_equals_the_port_and_is_bilinear():
    from zkfl_tpu_torch.field import pairing as port
    from zkfl_tpu_torch.field.bn254 import G2_GEN_X, G2_GEN_Y

    assert bn254.G2_GEN == (tuple(G2_GEN_X), tuple(G2_GEN_Y))
    e = bn254.pairing(bn254.G2_GEN, bn254.G1_GEN)
    assert e != bn254.ONE12 and bn254.f12_pow(e, bn254.R) == bn254.ONE12
    assert bn254.pairing(bn254.g2_mul(bn254.G2_GEN, 3), bn254.g1_mul(bn254.G1_GEN, 5)) \
        == bn254.f12_pow(e, 15)
    from zkfl_tpu_torch.field.curve import g2_generator

    assert list(port.pairing(bn254.G1_GEN, g2_generator()).coeffs) == e


def test_fl_round_is_deterministic_by_seed():
    cfg = {"num_clients": 3, "n": 2, "model_dim": 2, "depth": 1, "batch_size": 2,
           "tau_squared": 10 ** 14, "precision": 1000, "current_round": 1, "learning_rate": 0.01}
    a, b, c = fl_round.expect(cfg, 11), fl_round.expect(cfg, 11), fl_round.expect(cfg, 12)
    assert a == b and a["publics"] != c["publics"]
    assert [round_seed(2 ** 31 + 5, i) for i in range(-1, 4)] == \
        [round_seed(2 ** 31 + 5, i) for i in range(-1, 4)]
    assert len({round_seed(2 ** 31 + 5, i) for i in range(-1, 64)}) == 65


def test_rounds_worked_out_in_worker_processes_equal_those_in_process():
    from zkbench.plain.judge import expected_rounds

    cfg = {"num_clients": 3, "n": 2, "model_dim": 2, "depth": 1, "batch_size": 2,
           "tau_squared": 10 ** 14, "precision": 1000, "current_round": 1, "learning_rate": 0.01}
    seeds = [5, 2 ** 31 + 7, 11]
    assert expected_rounds("fl_round", cfg, seeds) == [fl_round.expect(cfg, s) for s in seeds]


def test_fl_round_equals_the_port_round_semantics():
    """Datasets, commitments, gradients and masks as the port's Client and
    Server compute them (no proving)."""
    from dataclasses import replace

    from zkfl_tpu_torch.fl.client import Client, SharedLCG
    from zkfl_tpu_torch.fl.config import MICRO_CONFIG
    from zkfl_tpu_torch.fl.simulation import simulate_key_exchange

    cfg = replace(MICRO_CONFIG, seed=987654321)
    fields = {k: getattr(cfg, k) for k in ("num_clients", "n", "model_dim", "depth", "batch_size",
                                          "tau_squared", "precision", "current_round",
                                          "learning_rate")}
    want = fl_round.expect(fields, cfg.seed)
    rng = SharedLCG(cfg.seed)
    clients = [Client(i, cfg, None) for i in range(1, 4)]
    for c in clients:
        c.generate_private_dataset(rng)
    keys = simulate_key_exchange(3)
    for c in clients:
        c.compute_dataset_commitment()
        c.training_witness([0] * cfg.model_dim)
        c.secagg_witness(keys)
        assert want["publics"]["balance", c.client_id][1] == c.root_d
        assert want["publics"]["training", c.client_id][3:5] == [c.root_g, c.root_w]
        assert want["publics"]["secagg", c.client_id][7:7 + cfg.model_dim] == c.masked_update
        assert want["publics"]["secagg", c.client_id][5] == c.root_k


def test_prod_round_equals_the_port_generator():
    from zkfl_tpu_torch.fl import prod
    from zkbench.kinds.prod_round import lcg_ints

    ds = prod.generate_dataset(prod.PROD_SEED)
    cfg = {"n": prod.PROD_N, "dim": prod.PROD_DIM, "depth": prod.PROD_DEPTH,
           "batch": prod.PROD_BATCH, "precision": 1000, "grad_seed": prod.PROD_SEED + 1,
           "client_id": 1, "round": 1}
    flat = lcg_ints(prod.PROD_SEED, prod.PROD_N * prod.PROD_DIM, 0, 1000)
    assert [flat[i * 16:(i + 1) * 16] for i in range(prod.PROD_N)] == ds["features"]
    assert prod_round.lcg_ints(prod.PROD_SEED, 5, 0, 1000) == flat[:5]
    v5 = prod.v5_inputs(ds)
    grad, tau = prod_round.prod_gradient(cfg)
    assert tau == v5["tauSquared"]
    assert [max(g, 0) for g in grad] == v5["gradPos"] and [max(-g, 0) for g in grad] == v5["gradNeg"]
    bal = prod.balance_inputs(ds)
    small = dict(cfg, n=8, dim=16, depth=3)
    want = prod_round.expect(small, 31337)
    assert want["publics"]["balance", 1][2:] == [8, 4, 4] and bal["c0"] == bal["c1"] == 64


def test_toxic_waste_equals_the_port_setup():
    from zkfl_tpu_torch.groth16.setup import _toxic_waste
    from zkbench.plain.judge import toxic_waste

    tw = toxic_waste()
    assert tuple(tw[k] for k in ("tau", "alpha", "beta", "gamma", "delta")) == _toxic_waste("zkfl-dev")
