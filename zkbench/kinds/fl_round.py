"""Traffic kind ``fl_round``: whole federated rounds in a closed loop, one
in flight, through the shipped entry ``fl.simulation.run_round`` on one
``RoundProver``: every client's dataset and commitment, the balance,
training and secure-aggregation proofs with their verification, and the
aggregate.  Each round's datasets come from its own seed.

Traffic file keys: ``batch_clients`` (each proof phase as one batched
prove of every client, or the reference's client-at-a-time loop),
``proof_sample`` (how many proofs the judge verifies by pairing).
"""

from __future__ import annotations

import time
from dataclasses import replace

from . import convert

# Wrapped in a traced run: (module, attribute, span).
SPANS = (
    ("zkfl_tpu_torch.fl.client", "generate_witness", "witness"),
    ("zkfl_tpu_torch.groth16.prover", "_assemble_proof", "assembly"),
    ("zkfl_tpu_torch.fl.prover", "groth16_verify", "verify"),
    ("zkfl_tpu_torch.fl.prover", "groth16_prove", "prove"),
    ("zkfl_tpu_torch.fl.prover", "groth16_prove_many", "prove"),
)
# A client's proof calls, witness included: each one's latency is kept.
PROOF_CALLS = ("generate_balance_proof", "train_and_generate_proof", "generate_secagg_proof")
CIRCUITS = ("balance", "training", "secagg")


class Cell:
    SPANS = SPANS

    def __init__(self, config: dict, traffic: dict, device, artifacts: str, rehearse: bool):
        from zkfl_tpu_torch.fl.client import Client
        from zkfl_tpu_torch.fl.config import FLConfig
        from zkfl_tpu_torch.fl.prover import RoundProver
        from zkfl_tpu_torch.groth16.engine import HostEngine, TorchEngine

        self.fields = config["rehearse" if rehearse else "fl_config"]
        self.cfg = FLConfig(**self.fields, artifacts_dir=artifacts)
        # The CPU rehearsal proves on the port's pure-Python HostEngine,
        # client at a time: TorchEngine's plain versions take a quarter of
        # an hour for one MICRO round there.
        engine = HostEngine() if rehearse else TorchEngine(device)
        self.prover = RoundProver(self.cfg, engine)
        self.batch = bool(traffic["batch_clients"]) and not rehearse
        self.latencies = []
        self._client, self._saved = Client, {}
        for name in PROOF_CALLS:
            self._saved[name] = getattr(Client, name)
            setattr(Client, name, self._timed(self._saved[name]))

    def _timed(self, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.latencies.append(time.perf_counter() - t0)
            return out
        return timed

    def close(self) -> None:
        for name, fn in self._saved.items():
            setattr(self._client, name, fn)

    def judged_config(self) -> dict:
        return self.fields

    def vks(self) -> dict:
        p = self.prover
        return {"balance": convert.vk(p.balance_vk), "training": convert.vk(p.training_vk),
                "secagg": convert.vk(p.secagg_vk)}

    def round(self, seed: int, spans) -> dict:
        """One round; raises AssertionError where the program's server
        rejects a proof."""
        from zkfl_tpu_torch.fl.simulation import run_round

        server, timings = run_round(replace(self.cfg, seed=seed), prover=self.prover,
                                    verbose=False, batch_clients=self.batch)
        stores = (server.balance_proofs, server.training_updates, server.secagg_updates)
        proofs = {(name, cid): convert.proof(pkg.proof)
                  for name, store in zip(CIRCUITS, stores) for cid, pkg in store.items()}
        return {"seed": seed, "proofs": proofs,
                "aggregate": [float(a) for a in server.aggregated_gradient],
                "model": [float(w) for w in server.global_model],
                "phases": {k: v for k, v in timings.items() if k != "total"}}
