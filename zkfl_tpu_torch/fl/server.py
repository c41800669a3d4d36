"""FL server: verifier + aggregator for one federated round.

Mirrors the reference Server (tests/full_system_simulation.mjs:795-1238):
every positional public-signal check, the cross-proof binding checks
(root_D/root_G/root_W equality across the three proofs), the tau^2 policy
check, the root_G recomputation hardening, and the field-sum aggregation
with signed unwrap and SGD model update.  Proof verification is the native
pairing check instead of a snarkjs subprocess.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..commit.vector_hash import from_field, gradient_commitment
from ..field.bn254 import FR
from .client import ProofPackage
from .config import FLConfig


class Server:
    def __init__(self, config: FLConfig, prover):
        self.cfg = config
        self.prover = prover       # RoundProver (vkeys + pairing verify)
        self.registered: Dict[int, dict] = {}
        self.commitments: Dict[int, dict] = {}
        self.balance_proofs: Dict[int, ProofPackage] = {}
        self.training_updates: Dict[int, ProofPackage] = {}
        self.secagg_updates: Dict[int, ProofPackage] = {}
        self.results: Dict[str, Dict[int, bool]] = {
            "balance": {}, "training": {}, "binding": {}, "secagg": {},
        }
        self.global_model: Optional[List[int]] = None
        self.aggregated_gradient: Optional[List[float]] = None
        self.log: List[str] = []

    def _fail(self, kind: str, cid: int, msg: str) -> bool:
        self.results[kind][cid] = False
        self.log.append(f"client {cid} {kind}: {msg}")
        return False

    # -- Phase 0/1/2 ------------------------------------------------------
    def initialize_model(self):
        self.global_model = [0] * self.cfg.model_dim
        return {"model_dim": self.cfg.model_dim}

    def register_client(self, client_id: int, metadata: dict):
        self.registered[client_id] = dict(metadata)

    def receive_dataset_commitment(self, commitment: dict):
        self.commitments[commitment["client_id"]] = dict(commitment)

    # -- Phase 3 ----------------------------------------------------------
    def verify_balance_proof(self, pkg: ProofPackage) -> bool:
        """Publics [client_id, root, N_public, c0, c1]; root at index 1
        (full_system_simulation.mjs:848-880)."""
        cid = pkg.client_id
        if pkg.public_signals[1] != pkg.root_D % FR:
            return self._fail("balance", cid, "root_D mismatch in public signals")
        if not self.prover.verify_balance(pkg.proof):
            return self._fail("balance", cid, "proof verification failed")
        self.balance_proofs[cid] = pkg
        self.results["balance"][cid] = True
        return True

    # -- Phase 4 ----------------------------------------------------------
    def verify_training_proof(self, pkg: ProofPackage) -> bool:
        """Publics [client_id, round, root_D, root_G, root_W, tauSquared]
        (full_system_simulation.mjs:886-989)."""
        cid = pkg.client_id
        sig = pkg.public_signals
        balance = self.balance_proofs.get(cid)
        if balance is None:
            return self._fail("training", cid, "no balance proof for client")
        if pkg.root_D != balance.root_D:
            self.results["binding"][cid] = False
            return self._fail("training", cid, "BINDING: root_D != balance root_D")
        self.results["binding"][cid] = True

        if sig[2] != pkg.root_D % FR:
            return self._fail("training", cid, "root_D mismatch in publics")
        if sig[3] != pkg.root_G % FR:
            return self._fail("training", cid, "root_G mismatch in publics")
        if sig[4] != pkg.root_W % FR:
            return self._fail("training", cid, "root_W mismatch in publics")
        if sig[1] != pkg.round:
            return self._fail("training", cid, "round mismatch in publics")
        if sig[5] != self.cfg.tau_squared:
            return self._fail("training", cid, "tauSquared != server clipping bound")

        # Hardening: recompute root_G from the submitted gradient — blocks
        # "prove one gradient, aggregate another" (mjs:953-966).
        grad_field = [g % FR for g in pkg.gradient]
        recomputed = gradient_commitment(grad_field, cid, pkg.round)
        if recomputed != pkg.root_G:
            return self._fail("training", cid, "recomputed root_G mismatch")

        if not self.prover.verify_training(pkg.proof):
            return self._fail("training", cid, "proof verification failed")
        self.training_updates[cid] = pkg
        self.results["training"][cid] = True
        return True

    # -- Phase 4.5 --------------------------------------------------------
    def verify_secagg_proof(self, pkg: ProofPackage) -> bool:
        """Publics [client_id, round, root_D, root_G, root_W, root_K,
        tauSquared, masked_update[0..DIM-1], peer_ids...]
        (full_system_simulation.mjs:995-1131)."""
        cid = pkg.client_id
        sig = pkg.public_signals
        training = self.training_updates.get(cid)
        if training is None:
            return self._fail("secagg", cid, "no training proof for client")
        if pkg.root_G != training.root_G:
            return self._fail("secagg", cid, "BINDING: root_G != training root_G")
        balance = self.balance_proofs.get(cid)
        if balance is None:
            return self._fail("secagg", cid, "no balance proof for client")
        if pkg.root_D != balance.root_D:
            return self._fail("secagg", cid, "BINDING: root_D != balance root_D")
        if pkg.root_W != training.root_W:
            return self._fail("secagg", cid, "BINDING: root_W != training root_W")

        checks = [
            (sig[0], cid, "client_id"),
            (sig[1], pkg.round, "round"),
            (sig[2], pkg.root_D % FR, "root_D"),
            (sig[3], pkg.root_G % FR, "root_G"),
            (sig[4], pkg.root_W % FR, "root_W"),
            (sig[5], pkg.root_K % FR, "root_K"),
            (sig[6], self.cfg.tau_squared, "tauSquared"),
        ]
        for got, want, name in checks:
            if got != want:
                return self._fail("secagg", cid, f"{name} mismatch in publics")
        for k in range(self.cfg.model_dim):
            if sig[7 + k] != pkg.masked_update[k] % FR:
                return self._fail("secagg", cid, f"masked_update[{k}] mismatch")

        if not self.prover.verify_secagg(pkg.proof):
            return self._fail("secagg", cid, "proof verification failed")
        self.secagg_updates[cid] = pkg
        self.results["secagg"][cid] = True
        return True

    # -- Phase 5 ----------------------------------------------------------
    def aggregate_updates(self):
        """Field-sum of masked updates (masks cancel), signed unwrap,
        average, model w <- w - lr * mean(g)
        (full_system_simulation.mjs:1137-1199)."""
        verified = [
            cid
            for cid, ok in self.results["secagg"].items()
            if ok and self.results["training"].get(cid) and self.results["binding"].get(cid)
        ]
        if not verified:
            return None
        agg = [0] * self.cfg.model_dim
        for cid in verified:
            upd = self.secagg_updates[cid]
            for j in range(self.cfg.model_dim):
                agg[j] = (agg[j] + upd.masked_update[j]) % FR
        self.aggregated_gradient = [from_field(a) / len(verified) for a in agg]
        for j in range(self.cfg.model_dim):
            self.global_model[j] -= self.cfg.learning_rate * self.aggregated_gradient[j]
        return {
            "aggregated_gradient": self.aggregated_gradient,
            "new_model": self.global_model,
            "num_clients": len(verified),
        }

    def get_summary(self):
        out = {}
        for kind, res in self.results.items():
            out[kind] = {"passed": sum(res.values()), "total": len(res)}
        out["all_passed"] = all(
            v["passed"] == v["total"] for v in out.values() if isinstance(v, dict)
        )
        return out
