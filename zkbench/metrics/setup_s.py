"""setup_s: seconds from the start of the run to the window: imports, the
kernels built or loaded, circuits and keys, the warm-up round (host clock)."""


def read(run):
    return run.setup_s
