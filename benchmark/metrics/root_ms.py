"""The window's wall time over the roots it completed."""

from benchmark import readers


def read(run):
    return readers.ms_per(run, "roots")
