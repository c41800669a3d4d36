"""msm_glue_share: the share of the MSMs' wall time (the card synchronised
around each ``msm._msm_impl``) that their point kernels' card time does
not cover: the torch glue, the gathers and the launches around them (%)."""


def read(run):
    if run.tracer is None or not run.on_device or not run.tracer.msm_wall_s:
        return None
    wall = sum(run.tracer.msm_wall_s)
    card = sum(c for _, cls, _, c, msm in run.tracer.launches if cls == "point" and msm is not None)
    return 100.0 * (1.0 - card / wall) if wall > 0 else None
