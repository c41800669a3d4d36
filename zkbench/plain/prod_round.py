"""Traffic kind ``prod_round``'s plain round: the production client's
round (integration_test.mjs) from the configuration's ``prod`` and the
round's seed: the dataset and its Poseidon-Merkle root, and both proofs'
public signals.
"""

from __future__ import annotations

from .commit import MASK_31, gradient_commitment, merkle_root, vector_hash


def lcg_ints(seed: int, count: int, lo: int, hi: int):
    """integration_test.mjs's seeded generator: lo + floor(next * (hi - lo))."""
    out, state = [], seed
    for _ in range(count):
        state = (state * 1103515245 + 12345) & MASK_31
        out.append(lo + int(state / MASK_31 * (hi - lo)))
    return out


def prod_gradient(cfg: dict):
    """(gradient, tau^2) of the training proof: drawn from the configured
    seed, with tau^2 just above its norm (at least 76014)."""
    grad = lcg_ints(cfg["grad_seed"], cfg["dim"], -10000, 10001)
    return grad, max(sum(g * g for g in grad) + 1, 76014)


def expect(cfg: dict, seed: int) -> dict:
    """The production round of ``cfg`` (the configuration file's ``prod``)
    on the dataset seeded by ``seed``: both proofs' public signals."""
    n, dim, depth = cfg["n"], cfg["dim"], cfg["depth"]
    flat = lcg_ints(seed, n * dim, 0, 1000)
    labels = [i % 2 for i in range(n)]
    leaves = [vector_hash(flat[i * dim:(i + 1) * dim] + [labels[i]]) for i in range(n)]
    root = merkle_root(leaves, depth)
    c1 = sum(labels)
    cid, rnd = cfg["client_id"], cfg["round"]
    grad, tau = prod_gradient(cfg)
    return {"publics": {
        ("balance", cid): [cid, root, n, n - c1, c1],
        ("training", cid): [cid, rnd, root, gradient_commitment(grad, cid, rnd), tau],
    }}
