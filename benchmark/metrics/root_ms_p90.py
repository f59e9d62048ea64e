"""The 90th percentile of the roots' latencies in the window, call to synchronised result."""

from benchmark import readers


def read(run):
    return readers.latency_ms(run, 90)
