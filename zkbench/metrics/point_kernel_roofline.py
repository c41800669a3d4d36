"""point_kernel_roofline: the G1 and G2 point kernels' (K4, K6) least time
over their card time, in the window (%)."""

from ._roofline import share


def read(run):
    return share(run, "point")
