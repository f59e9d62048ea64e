"""The roots' Jive device time were every level to run at level 1's time a state, over their Jive device
time: 100 when the small levels cost no more a state than the largest (``anemoi.merkle.level`` spans)."""

from benchmark import spans


def read(run):
    return spans.level_efficiency_pct(run, "anemoi.merkle.level", "jive")
