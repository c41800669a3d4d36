"""The judge (zkbench/plain) on a MICRO_CONFIG round that the port proved
on TorchEngine(cpu), batched as the reference cells' window proves it:
every check passes, and one proof element or one masked value changed is
caught.  Slow: the CPU runs the kernels' plain versions (a quarter of an
hour for the round); run it in one process (no ``-n``), so that the round
is proved once."""

import copy

import pytest

from zkbench.plain import bn254
from zkbench.plain.judge import ic_sha256, judge, keys_wrong, toxic_waste

MICRO = {"num_clients": 3, "n": 2, "model_dim": 2, "depth": 1, "batch_size": 2,
         "tau_squared": 10 ** 14, "precision": 1000, "current_round": 1, "learning_rate": 0.01}
SEED = 1234567


@pytest.fixture(scope="module")
def round_on_torch_cpu(tmp_path_factory):
    import torch

    from zkbench.kinds.fl_round import Cell
    from zkbench.trace import NullSpans
    from zkfl_tpu_torch.fl.config import FLConfig
    from zkfl_tpu_torch.groth16.device_prover import PipelineProfile
    from zkfl_tpu_torch.groth16.setup import setup_cached_many
    from zkfl_tpu_torch.r1cs.circuits import build_structure

    torch.set_num_threads(2)
    cache = str(tmp_path_factory.mktemp("keys"))
    cfg = FLConfig(**MICRO, artifacts_dir=cache)
    structures = [build_structure(p) for p in
                  (cfg.balance_params, cfg.training_params, cfg.secagg_params)]
    # The ladder's keys: the device setup's plain versions take many minutes.
    setup_cached_many(structures, cache, domain=PipelineProfile.cover(structures).domain,
                      device=None)
    cell = Cell({"fl_config": MICRO}, {"batch_clients": True}, torch.device("cpu"), cache, False)
    try:
        record = cell.round(SEED, NullSpans())
        return record, cell.vks()
    finally:
        cell.close()


def verdict(record, vks):
    # This MICRO set-up is the test's own, so its IC lists are pinned from
    # its keys; test_keys_wrong_counts_a_changed_ic_point holds the pins.
    pins = {circuit: ic_sha256(vk["ic"]) for circuit, vk in vks.items()}
    return judge("fl_round", MICRO, [record], vks, pins, proof_sample=9, seed=SEED)


@pytest.mark.slow
def test_judge_accepts_the_round(round_on_torch_cpu):
    record, vks = round_on_torch_cpu
    v = verdict(record, vks)
    del v["ic_sha256"]
    assert v == {"publics_wrong": 0, "proofs_rejected": 0, "aggregate_wrong": 0,
                 "keys_wrong": 0, "rounds_judged": 1, "proofs_verified": 9}


@pytest.mark.slow
def test_judge_rejects_a_proof_element_changed(round_on_torch_cpu):
    record, vks = round_on_torch_cpu
    bad = copy.deepcopy(record)
    proof = bad["proofs"]["training", 2]
    proof["a"] = bn254.g1_add(proof["a"], bn254.G1_GEN)
    assert verdict(bad, vks)["proofs_rejected"] == 1


@pytest.mark.slow
def test_judge_rejects_a_masked_value_changed(round_on_torch_cpu):
    record, vks = round_on_torch_cpu
    bad = copy.deepcopy(record)
    bad["proofs"]["secagg", 3]["publics"][7] += 1  # masked_update[0]
    v = verdict(bad, vks)
    assert v["publics_wrong"] == 1


def test_judge_rejects_a_changed_aggregate_without_proofs():
    """The plain side alone, on a round record made from the reference's own
    numbers: the aggregate and the model are compared exactly."""
    from zkbench.plain import fl_round

    want = fl_round.expect(MICRO, SEED)
    record = {"seed": SEED, "proofs": {}, "aggregate": list(want["aggregate"]),
              "model": list(want["model"])}
    v = judge("fl_round", MICRO, [record], {}, {}, proof_sample=0, seed=SEED)
    assert (v["aggregate_wrong"], v["publics_wrong"]) == (0, 9)
    record["aggregate"][1] += 1e-9
    v = judge("fl_round", MICRO, [record], {}, {}, proof_sample=0, seed=SEED)
    assert v["aggregate_wrong"] == 1


def test_keys_wrong_counts_a_changed_ic_point():
    """The development setup's key elements with an IC list pinned: no
    fault; one IC point moved along the curve, or no pin: one."""
    tw = toxic_waste()
    vk = {"alpha1": bn254.g1_mul(bn254.G1_GEN, tw["alpha"]),
          "beta2": bn254.g2_mul(bn254.G2_GEN, tw["beta"]),
          "gamma2": bn254.g2_mul(bn254.G2_GEN, tw["gamma"]),
          "delta2": bn254.g2_mul(bn254.G2_GEN, tw["delta"]),
          "ic": [bn254.G1_GEN, bn254.g1_mul(bn254.G1_GEN, 2)]}
    pins = {"balance": ic_sha256(vk["ic"])}
    assert keys_wrong({"balance": vk}, pins) == 0
    moved = dict(vk, ic=[bn254.G1_GEN, bn254.g1_mul(bn254.G1_GEN, 3)])
    assert keys_wrong({"balance": moved}, pins) == 1
    assert keys_wrong({"balance": vk}, {}) == 1
