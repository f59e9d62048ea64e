"""The Jive kernels' share of their roofline over the traced batches."""

from benchmark import readers


def read(run):
    return readers.kernel_roofline_pct(run, "jive", "jive")
