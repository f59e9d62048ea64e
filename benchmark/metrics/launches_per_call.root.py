"""Kernel launches (``anemoi.launch`` spans) a traced root."""

from benchmark import spans


def read(run):
    return spans.count_per_call(run, "anemoi.launch")
