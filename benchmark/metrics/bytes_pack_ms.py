"""Host time in the native packer over every message (``anemoi.bytes.pack``), ms a traced call."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "anemoi.bytes.pack")
