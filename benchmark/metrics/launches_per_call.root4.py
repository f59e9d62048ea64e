"""Kernel launches (``anemoi.launch`` spans) a traced arity-4 root."""

from benchmark import spans


def read(run):
    return spans.count_per_call(run, "anemoi.launch")
