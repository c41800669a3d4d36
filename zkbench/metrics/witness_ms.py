"""witness_ms: host-clock milliseconds in the ``witness`` span over the
window, a proof (traced run)."""

from ._spans import per_proof_ms


def read(run):
    return per_proof_ms(run, "witness")
