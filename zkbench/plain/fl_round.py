"""Traffic kind ``fl_round``'s plain round: the reference's federated
round (full_system_simulation.mjs) from the configuration's ``fl_config``
and the round's seed: every client's dataset, commitment, class counts,
gradient and masks, every proof's public signals, and the aggregate.
"""

from __future__ import annotations

from .commit import MASK_31, gradient_commitment, merkle_root, vector_hash
from .poseidon import R, poseidon


def expect(cfg: dict, seed: int) -> dict:
    """The round of ``cfg`` (the configuration file's ``fl_config``) seeded by
    ``seed``: {"publics": {(kind, client): [...]}, "aggregate": [...],
    "model": [...]}, the aggregate and the model as the server's floats."""
    n, dim, depth, batch = cfg["n"], cfg["model_dim"], cfg["depth"], cfg["batch_size"]
    clients = range(1, cfg["num_clients"] + 1)
    rnd, tau, prec = cfg["current_round"], cfg["tau_squared"], cfg["precision"]
    state = seed

    def randint(lo, hi, salt):
        nonlocal state
        state = (state * 1103515245 + 12345 + salt * 7919) & MASK_31
        return int(state / MASK_31 * (hi - lo + 1)) + lo

    data = {}
    for c in clients:  # one generator, mutated client after client
        feats = [[randint(0, 100, c * 1000 + i * 10 + j) for j in range(dim)] for i in range(n)]
        data[c] = (feats, [(i + c) % 2 for i in range(n)])

    weights = [0] * dim
    pair_key = {(i, j): poseidon([min(i, j), max(i, j), 12345])
                for i in clients for j in clients if i != j}
    publics, grads = {}, {}
    for c in clients:
        feats, labels = data[c]
        root = merkle_root([vector_hash(f + [y]) for f, y in zip(feats, labels)], depth)
        c1 = sum(labels)
        publics["balance", c] = [c, root, n, n - c1, c1]

        summed = [0] * dim
        for i in range(batch):
            err = sum(feats[i][j] * weights[j] for j in range(dim)) - labels[i] * prec
            for j in range(dim):
                summed[j] += err * feats[i][j]
        grad = [s // (batch * prec) for s in summed]
        if sum(g * g for g in grad) > tau:
            raise ValueError(f"client {c}: gradient norm over tau^2")
        root_g = gradient_commitment(grad, c, rnd)
        root_w = vector_hash(weights)
        publics["training", c] = [c, rnd, root, root_g, root_w, tau]

        peers = [j for j in clients if j != c]
        root_k = poseidon([poseidon([c, 12345])] + [pair_key[c, j] for j in peers])
        masked = [g % R for g in grad]
        for j in peers:
            sign = 1 if c < j else -1
            lo, hi = min(c, j), max(c, j)
            for k in range(dim):
                masked[k] = (masked[k] + sign * poseidon([pair_key[c, j], rnd, lo, hi, k])) % R
        publics["secagg", c] = [c, rnd, root, root_g, root_w, root_k, tau, *masked, *peers]
        grads[c] = grad

    count = len(grads)
    aggregate = [sum(grads[c][j] for c in clients) / count for j in range(dim)]
    model = [weights[j] - cfg["learning_rate"] * aggregate[j] for j in range(dim)]
    return {"publics": publics, "aggregate": aggregate, "model": model}
