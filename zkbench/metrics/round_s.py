"""round_s: the measured window's seconds over the rounds completed in it
whose every proof the program verified (host clock)."""


def read(run):
    return run.window_s / run.rounds_ok if run.rounds_ok else None
