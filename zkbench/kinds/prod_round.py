"""Traffic kind ``prod_round``: one client's production round in a closed
loop, one in flight, on the compiled circuits of ``fl/prod.py``: the
dataset and its Poseidon-Merkle commitment, the balance and training
(``sgd_step_v5``) witnesses, ``groth16_prove`` of each, ``groth16_verify``
of both and the binding check on root_D.  It is ``run_prod_integration``
after its set-up, repeated, with each round's dataset from its own seed.

The dataset generator and the witness inputs are ``fl/prod.py``'s
(``generate_dataset``, ``balance_inputs``, ``v5_inputs``), copied here with
their sizes taken from the configuration file.
"""

from __future__ import annotations

import sys

from . import convert

SPANS = (("zkfl_tpu_torch.groth16.prover", "_assemble_proof", "assembly"),)
MASK_31 = 0x7FFFFFFF


def lcg_ints(seed: int, count: int, lo: int, hi: int):
    """integration_test.mjs's seeded generator: lo + floor(next * (hi - lo))."""
    out, state = [], seed
    for _ in range(count):
        state = (state * 1103515245 + 12345) & MASK_31
        out.append(lo + int(state / MASK_31 * (hi - lo)))
    return out


class Cell:
    SPANS = SPANS

    def __init__(self, config: dict, traffic: dict, device, artifacts: str, rehearse: bool):
        from zkfl_tpu_torch.field.bn254 import FR, domain_size_for
        from zkfl_tpu_torch.fl import prod
        from zkfl_tpu_torch.groth16.engine import TorchEngine
        from zkfl_tpu_torch.groth16.setup import setup_cached
        from zkfl_tpu_torch.r1cs.balance import BalanceParams
        from zkfl_tpu_torch.r1cs.compiled import n_constraints
        from zkfl_tpu_torch.r1cs.training import TrainingParams

        p = self.p = config["rehearse" if rehearse else "prod"]
        self.engine = TorchEngine(device)
        self.bal_params = BalanceParams(n=p["n"], depth=p["depth"], model_dim=p["dim"])
        self.v5_params = TrainingParams(batch_size=p["batch"], model_dim=p["dim"],
                                        depth=p["depth"], precision=p["precision"], variant="v5")

        def log(msg):
            print(f"# {msg}", file=sys.stderr, flush=True)

        keys = []
        for params in (self.bal_params, self.v5_params):
            cc, full = prod._structure(params, artifacts, log)
            if rehearse and full is not None:  # the ladder: seconds on the CPU
                setup_cached(full, artifacts, domain=domain_size_for(n_constraints(cc) + 1),
                             device=None)
            keys.append((cc, prod._setup(cc, full, params, artifacts, None, self.engine.device, log)))
        (self.bal_cc, (self.bal_pk, self.bal_vk)), (self.v5_cc, (self.v5_pk, self.v5_vk)) = keys

        grad = lcg_ints(p["grad_seed"], p["dim"], -10000, 10001)
        self.tau = max(sum(g * g for g in grad) + 1, 76014)
        self.grad_pos = [g if g > 0 else 0 for g in grad]
        self.grad_neg = [-g if g < 0 else 0 for g in grad]
        self.grad_field = [(a - b) % FR for a, b in zip(self.grad_pos, self.grad_neg)]
        self.latencies = []

    def close(self) -> None:
        pass

    def judged_config(self) -> dict:
        return self.p

    def vks(self) -> dict:
        return {"balance": convert.vk(self.bal_vk), "training": convert.vk(self.v5_vk)}

    def round(self, seed: int, spans) -> dict:
        """One production round; raises AssertionError where a proof fails
        to verify or the two proofs bind different roots."""
        from zkfl_tpu_torch.commit.merkle import MerkleTree
        from zkfl_tpu_torch.commit.vector_hash import gradient_commitment, sample_hash
        from zkfl_tpu_torch.fl.prod import verify_binding
        from zkfl_tpu_torch.groth16.prover import groth16_prove
        from zkfl_tpu_torch.groth16.verifier import groth16_verify
        from zkfl_tpu_torch.r1cs.circuits import generate_witness

        p = self.p
        n, dim, batch, cid, rnd = p["n"], p["dim"], p["batch"], p["client_id"], p["round"]
        with spans("dataset"):
            flat = lcg_ints(seed, n * dim, 0, 1000)
            features = [flat[i * dim:(i + 1) * dim] for i in range(n)]
            labels = [i % 2 for i in range(n)]
            tree = MerkleTree([sample_hash(features[i], labels[i]) for i in range(n)], p["depth"])
        paths = [tree.prove(i) for i in range(n)]
        c1 = sum(labels)
        bal_inputs = {
            "client_id": cid, "root": tree.root, "N_public": n, "c0": n - c1, "c1": c1,
            "features": features, "labels": labels,
            "siblings": [s for s, _ in paths], "pathIndices": [i for _, i in paths],
        }
        v5_inputs = {
            "client_id": cid, "round": rnd, "root_D": tree.root,
            "root_G": gradient_commitment(self.grad_field, cid, rnd),
            "tauSquared": self.tau, "gradPos": self.grad_pos, "gradNeg": self.grad_neg,
            "features": features[:batch], "labels": labels[:batch],
            "siblings": [s for s, _ in paths[:batch]], "pathIndices": [i for _, i in paths[:batch]],
        }
        with spans("witness"):
            bal_wit = generate_witness(self.bal_params, bal_inputs).witness
            v5_wit = generate_witness(self.v5_params, v5_inputs).witness
        with spans("prove"):
            bal_proof = groth16_prove(self.bal_pk, self.bal_cc, bal_wit, engine=self.engine)
            v5_proof = groth16_prove(self.v5_pk, self.v5_cc, v5_wit, engine=self.engine)
        with spans("verify"):
            ok = [groth16_verify(self.bal_vk, bal_proof), groth16_verify(self.v5_vk, v5_proof)]
        if not all(ok) or not verify_binding(bal_proof.public_signals, v5_proof.public_signals):
            raise AssertionError(f"production round rejected: verified {ok}, binding "
                                 f"{verify_binding(bal_proof.public_signals, v5_proof.public_signals)}")
        return {"seed": seed, "proofs": {("balance", cid): convert.proof(bal_proof),
                                         ("training", cid): convert.proof(v5_proof)}}
