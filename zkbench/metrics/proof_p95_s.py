"""proof_p95_s: the 95th percentile of one proof's latency, from the start
of a client's proof call (witness included) to the proof on the host,
over every proof the window made one client at a time (host clock)."""

import statistics


def read(run):
    if len(run.latencies) < 20:
        return None
    return statistics.quantiles(run.latencies, n=20, method="inclusive")[18]
