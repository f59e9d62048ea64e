"""``merkle_level_efficiency_pct`` of the arity-4 roots: their Jive device time were every level to run at
level 1's time a state, over their Jive device time (``anemoi.merkle.level`` spans, the arity from the
call's hashes and levels)."""

from benchmark import spans


def read(run):
    return spans.level_efficiency_pct(run, "anemoi.merkle.level", "jive")
