"""The sponge kernels' share of their roofline over the traced calls."""

from benchmark import readers


def read(run):
    return readers.kernel_roofline_pct(run, "sponge", "sponge")
