"""FL client: prover-side state machine for one federated round.

Mirrors the reference Client (tests/full_system_simulation.mjs:244-789)
semantics exactly — dataset generation (shared-LCG), commitments, the
circuit-exact fixed-point gradient, pairwise masking — while routing all
proving through the native Groth16 stack (no subprocesses; the port's
TorchEngine runs the MSMs on the card).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..commit.merkle import MerkleTree
from ..commit.vector_hash import (
    derive_pairwise_mask,
    gradient_commitment,
    key_material_commitment,
    vector_hash,
    weight_commitment,
)
from ..field.bn254 import FR
from ..poseidon.reference import poseidon
from ..r1cs.circuits import generate_witness
from .config import FLConfig


class SharedLCG:
    """The reference's deterministic RNG: one GLOBAL seed mutated across all
    clients in generation order (full_system_simulation.mjs:118-126)."""

    def __init__(self, seed: int = 12345):
        self.state = seed

    def random(self, client_id: int = 0) -> float:
        self.state = (self.state * 1103515245 + 12345 + client_id * 7919) & 0x7FFFFFFF
        return self.state / 0x7FFFFFFF

    def randint(self, lo: int, hi: int, client_id: int = 0) -> int:
        return int(self.random(client_id) * (hi - lo + 1)) + lo


@dataclass
class ProofPackage:
    """In-memory analog of the reference's JSON proof packages."""

    client_id: int
    proof: object                  # groth16.prover.Proof
    public_signals: List[int]
    fields: Dict[str, object] = field(default_factory=dict)

    def __getattr__(self, name):
        try:
            return self.fields[name]
        except KeyError:
            raise AttributeError(name)


class Client:
    """Prover for one client: 5-phase round state machine."""

    def __init__(self, client_id: int, config: FLConfig, prover):
        self.client_id = client_id
        self.cfg = config
        self.prover = prover       # fl.prover.RoundProver (shared setups)
        self.features: List[List[int]] = []
        self.labels: List[int] = []
        self.c0 = 0
        self.c1 = 0
        self.tree: Optional[MerkleTree] = None
        self.root_d: Optional[int] = None
        self.weights: List[int] = []
        self.gradient: List[int] = []
        self.root_g: Optional[int] = None
        self.root_w: Optional[int] = None
        self.root_k: Optional[int] = None
        self.masked_update: List[int] = []

    # -- Phase 1 ----------------------------------------------------------
    def generate_private_dataset(self, rng: SharedLCG) -> dict:
        """Seeded dataset; labels alternate (i + id) % 2
        (full_system_simulation.mjs:273-303)."""
        cfg = self.cfg
        self.features = [
            [
                rng.randint(0, 100, self.client_id * 1000 + i * 10 + j)
                for j in range(cfg.model_dim)
            ]
            for i in range(cfg.n)
        ]
        self.labels = [(i + self.client_id) % 2 for i in range(cfg.n)]
        self.c1 = sum(self.labels)
        self.c0 = cfg.n - self.c1
        return {"client_id": self.client_id, "N": cfg.n, "c0": self.c0, "c1": self.c1}

    # -- Phase 2 ----------------------------------------------------------
    def compute_dataset_commitment(self) -> dict:
        """leaf_i = VectorHash(features_i || label_i); Merkle root -> root_D
        (full_system_simulation.mjs:308-335)."""
        leaves = [
            vector_hash(self.features[i] + [self.labels[i]])
            for i in range(self.cfg.n)
        ]
        self.tree = MerkleTree(leaves, self.cfg.depth)
        self.root_d = self.tree.root
        return {
            "client_id": self.client_id,
            "root_D": self.root_d,
            "c0": self.c0,
            "c1": self.c1,
            "N": self.cfg.n,
        }

    # -- Phase 3 ----------------------------------------------------------
    def balance_witness(self) -> List[int]:
        """Witness for the class-balance circuit (witness-gen half of
        generateBalanceProof, full_system_simulation.mjs:340-395)."""
        cfg = self.cfg
        sib, idx = self._merkle_paths(cfg.n)
        inputs = {
            "client_id": self.client_id,
            "root": self.root_d,
            "N_public": cfg.n,
            "c0": self.c0,
            "c1": self.c1,
            "features": self.features,
            "labels": self.labels,
            "siblings": sib,
            "pathIndices": idx,
        }
        return generate_witness(cfg.balance_params, inputs).witness

    def package_balance(self, proof) -> ProofPackage:
        return ProofPackage(
            self.client_id, proof, proof.public_signals,
            {"root_D": self.root_d, "c0": self.c0, "c1": self.c1},
        )

    def generate_balance_proof(self) -> ProofPackage:
        """Class-balance proof over the committed dataset
        (full_system_simulation.mjs:340-395)."""
        proof = self.prover.prove_balance(self.balance_witness())
        return self.package_balance(proof)

    # -- Phase 4 ----------------------------------------------------------
    def compute_verified_gradient(self, weights: List[int]):
        """Circuit-exact linear-regression gradient
        (full_system_simulation.mjs:511-553): summed_j = sum_i (w.x_i -
        y_i*P) * x_ij ; grad = floor(summed / (B*P)), rem >= 0."""
        cfg = self.cfg
        divisor = cfg.batch_size * cfg.precision
        summed = [0] * cfg.model_dim
        for i in range(cfg.batch_size):
            pred = sum(self.features[i][j] * weights[j] for j in range(cfg.model_dim))
            err = pred - self.labels[i] * cfg.precision
            for j in range(cfg.model_dim):
                summed[j] += err * self.features[i][j]
        grad, rem = [], []
        for j in range(cfg.model_dim):
            q = summed[j] // divisor  # floor division (Python matches JS Math.floor)
            grad.append(q)
            rem.append(summed[j] - q * divisor)
        return grad, summed, rem

    def training_witness(self, global_model: List[int]) -> List[int]:
        """Witness for the training circuit; updates weight/gradient state
        (witness-gen half of trainAndGenerateProof,
        full_system_simulation.mjs:401-506)."""
        cfg = self.cfg
        self.weights = list(global_model)
        grad, summed, rem = self.compute_verified_gradient(self.weights)
        self.gradient = grad

        grad_pos = [g if g >= 0 else 0 for g in grad]
        grad_neg = [-g if g < 0 else 0 for g in grad]
        norm_sq = sum(g * g for g in grad)
        if norm_sq > cfg.tau_squared:
            raise ValueError(
                f"gradient norm^2 {norm_sq} exceeds tau^2 {cfg.tau_squared}"
            )

        self.root_w = weight_commitment(self.weights)
        grad_field = [g % FR for g in grad]
        self.root_g = gradient_commitment(grad_field, self.client_id, cfg.current_round)

        sib, idx = self._merkle_paths(cfg.batch_size)
        inputs = {
            "client_id": self.client_id,
            "round": cfg.current_round,
            "root_D": self.root_d,
            "root_G": self.root_g,
            "root_W": self.root_w,
            "tauSquared": cfg.tau_squared,
            "weights": self.weights,
            "expectedSummedGrad": summed,
            "remainder": rem,
            "gradPos": grad_pos,
            "gradNeg": grad_neg,
            "features": self.features,
            "labels": self.labels,
            "siblings": sib,
            "pathIndices": idx,
        }
        return generate_witness(cfg.training_params, inputs).witness

    def package_training(self, proof) -> ProofPackage:
        return ProofPackage(
            self.client_id, proof, proof.public_signals,
            {
                "root_D": self.root_d,
                "root_G": self.root_g,
                "root_W": self.root_w,
                "round": self.cfg.current_round,
                "gradient": self.gradient,
            },
        )

    def train_and_generate_proof(self, global_model: List[int]) -> ProofPackage:
        """Training-integrity proof with in-circuit gradient correctness
        (full_system_simulation.mjs:401-506)."""
        proof = self.prover.prove_training(self.training_witness(global_model))
        return self.package_training(proof)

    # -- Phase 4.5 --------------------------------------------------------
    def secagg_witness(self, all_shared_keys: Dict[int, Dict[int, int]]) -> List[int]:
        """Witness for the masked-update proof
        (full_system_simulation.mjs:558-668):
        m = g + sum_j sign(i,j) * PRF(K_ij, round, min, max, k) mod p."""
        cfg = self.cfg
        shared = all_shared_keys[self.client_id]
        self.master_key = poseidon([self.client_id, 12345])

        peer_ids = [j for j in range(1, cfg.num_clients + 1) if j != self.client_id]
        peer_keys = [shared[j] for j in peer_ids]
        self.root_k = key_material_commitment(self.master_key, peer_keys)

        masked = [g % FR for g in self.gradient]
        for j in peer_ids:
            mask = derive_pairwise_mask(
                shared[j], cfg.current_round, self.client_id, j, cfg.model_dim
            )
            sign = 1 if self.client_id < j else -1
            for k in range(cfg.model_dim):
                masked[k] = (masked[k] + sign * mask[k]) % FR
        self.masked_update = masked

        inputs = {
            "client_id": self.client_id,
            "round": cfg.current_round,
            "root_D": self.root_d,
            "root_G": self.root_g,
            "root_W": self.root_w,
            "root_K": self.root_k,
            "tauSquared": cfg.tau_squared,
            "masked_update": masked,
            "peer_ids": peer_ids,
            "gradient": [g % FR for g in self.gradient],
            "master_key": self.master_key,
            "shared_keys": peer_keys,
        }
        return generate_witness(cfg.secagg_params, inputs).witness

    def package_secagg(self, proof) -> ProofPackage:
        return ProofPackage(
            self.client_id, proof, proof.public_signals,
            {
                "root_D": self.root_d,
                "root_G": self.root_g,
                "root_W": self.root_w,
                "root_K": self.root_k,
                "round": self.cfg.current_round,
                "masked_update": self.masked_update,
            },
        )

    def generate_secagg_proof(self, all_shared_keys: Dict[int, Dict[int, int]]) -> ProofPackage:
        proof = self.prover.prove_secagg(self.secagg_witness(all_shared_keys))
        return self.package_secagg(proof)

    # -- helpers ----------------------------------------------------------
    def _merkle_paths(self, count: int):
        sib, idx = [], []
        for i in range(count):
            s, p = self.tree.prove(i)
            sib.append(s)
            idx.append(p)
        return sib, idx
