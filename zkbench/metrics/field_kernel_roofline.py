"""field_kernel_roofline: the field kernels' (K1 element-wise ops, K2
butterflies, K3 normalisation) least time over their card time, in the
window (%)."""

from ._roofline import share


def read(run):
    return share(run, "field")
