"""Shared by the roofline readers: the least time the card could take for
a class of the profiled rounds' launches (each launch's from its op's cost
file) as a share of the time their kernels took (the profiler's durations,
matched to the launches in order; nothing where they could not be
matched)."""


def share(run, kind: str):
    if run.activity is None or run.activity["kernel_rows"] is None:
        return None
    rows = [(least, card) for cls, least, card in run.activity["kernel_rows"] if cls == kind]
    card = sum(c for _, c in rows)
    if not rows or card <= 0:
        return None
    return 100.0 * sum(least for least, _ in rows) / card
