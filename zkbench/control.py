"""A run of a cell with the program broken underneath, to show that the
judge turns ``correct`` false.  Never part of a benchmark run.

    python3 -m zkbench.control --fault <name> --workload <cell> --seed <n> --seconds <s>
                               [--trace 0|1] [--rehearse DIR]

Faults (each a patch of the program's code, made after the set-up's
imports and undone at the end):

- ``proof_altered``: every proof's C point moved by the generator where
  the proof is assembled (an answer altered where it is produced); the
  program's own verifier rejects the rounds.
- ``proof_unchecked``: the control.  ``proof_altered`` with the program's
  verification always passing, so that only the judge's pairing check
  stands between the altered proofs and the result.
- ``half_batch``: the aggregate taken over the first half of the clients
  only, the mean over them (federated rounds).
- ``model_unchanged``: the aggregation step leaves the global model as it
  was (federated rounds).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import sys

from . import run


def _patch(stack, module: str, path: str, make) -> None:
    """Replace ``module.path`` (a function, or ``Class.method``) by
    ``make(old)`` until ``stack`` closes."""
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for name in parents:
        owner = getattr(owner, name)
    old = getattr(owner, attr)
    setattr(owner, attr, make(old))
    stack.callback(setattr, owner, attr, old)


def _altered_assembly(assemble):
    from zkfl_tpu_torch.field.curve import g1_add_jac, g1_from_jacobian, g1_generator, g1_to_jacobian

    def altered(*args, **kwargs):
        proof = assemble(*args, **kwargs)
        proof.pi_c = g1_from_jacobian(g1_add_jac(g1_to_jacobian(proof.pi_c),
                                                 g1_to_jacobian(g1_generator())))
        return proof
    return altered


def _always_true(_verify):
    return lambda *args, **kwargs: True


def _half_batch(aggregate):
    def half(server):
        keep = sorted(server.results["secagg"])[: max(1, len(server.results["secagg"]) // 2)]
        server.results["secagg"] = {cid: server.results["secagg"][cid] for cid in keep}
        return aggregate(server)
    return half


def _model_unchanged(aggregate):
    def unchanged(server):
        before = list(server.global_model)
        out = aggregate(server)
        server.global_model[:] = before
        return out
    return unchanged


FAULTS = {
    "proof_altered": [("zkfl_tpu_torch.groth16.prover", "_assemble_proof", _altered_assembly)],
    "proof_unchecked": [
        ("zkfl_tpu_torch.groth16.prover", "_assemble_proof", _altered_assembly),
        ("zkfl_tpu_torch.fl.prover", "groth16_verify", _always_true),
        ("zkfl_tpu_torch.groth16.verifier", "groth16_verify", _always_true),
    ],
    "half_batch": [("zkfl_tpu_torch.fl.server", "Server.aggregate_updates", _half_batch)],
    "model_unchanged": [("zkfl_tpu_torch.fl.server", "Server.aggregate_updates", _model_unchanged)],
}


@contextlib.contextmanager
def planted(name: str):
    with contextlib.ExitStack() as stack:
        for module, path, make in FAULTS[name]:
            _patch(stack, module, path, make)
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="a benchmark run with a fault planted")
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    known, rest = ap.parse_known_args(argv)
    return run.main(rest, fault=lambda: planted(known.fault))


if __name__ == "__main__":
    sys.exit(main())
