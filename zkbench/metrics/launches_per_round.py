"""launches_per_round: the program's kernel launches (backend.LAUNCHES,
an exact count) over the window, a completed round."""


def read(run):
    if not run.on_device or not run.rounds_ok:
        return None
    return sum(run.launches.values()) / run.rounds_ok
