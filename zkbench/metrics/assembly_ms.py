"""assembly_ms: host-clock milliseconds in the ``assembly`` span over the
window, a proof (traced run)."""

from ._spans import per_proof_ms


def read(run):
    return per_proof_ms(run, "assembly")
