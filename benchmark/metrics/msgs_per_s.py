"""Messages hashed by the whole calls in the window over its wall time."""

from benchmark import readers


def read(run):
    return readers.rate(run, "messages")
