"""The share of the traced window that no operation on the card covers (arity-4 root cell)."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
