"""Host time stacking the packed messages into a contiguous [E, L, B] (``anemoi.bytes.layout``),
ms a traced call."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "anemoi.bytes.layout")
