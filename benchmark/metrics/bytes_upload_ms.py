"""Host time of the messages' copy to the card (``anemoi.bytes.upload``), ms a traced call."""

from benchmark import spans


def read(run):
    return spans.ms_per_call(run, "anemoi.bytes.upload")
