"""The share of the traced roots' wall time in which no Jive kernel runs on the card:
the levels' copies, the launch gaps and the host."""

from benchmark import readers


def read(run):
    return readers.outside_pct(run, "jive")
