"""The width-4 Jive kernel's share of its roofline over the traced arity-4 roots."""

from benchmark import readers


def read(run):
    return readers.kernel_roofline_pct(run, "jive", "jive")
