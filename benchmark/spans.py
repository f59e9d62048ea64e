"""What the readers of the program's own spans share.

The port records a span (a ``user_annotation`` event, ``anemoi.<layer>...``)
at its layer boundaries while a ``torch.profiler`` runs
(``anemoi_tpu_torch/utils/profiling.py:span``); ``tracefile.Trace`` keeps
them in ``host_ops`` with the harness's own.  A span belongs to the traced
call in which it starts.  A reader returns None where the trace holds none
of the spans it reads, as from a program that records none.
"""

from __future__ import annotations

import bisect

from .tracefile import covered, union


def _by_call(calls: list, intervals) -> list:
    """(start, end) intervals, a sorted list per call in which they start."""
    starts = [lo for lo, _ in calls]
    out = [[] for _ in calls]
    for a, b in intervals:
        k = bisect.bisect_right(starts, a) - 1
        if k >= 0 and a <= calls[k][1]:
            out[k].append((a, b))
    return [sorted(x) for x in out]


def _in_calls(run, name: str) -> list | None:
    """The (start, end) of each span `name`, a list per traced call; None
    without a trace, without calls, or without such a span in them."""
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    per_call = _by_call(tr.calls, ((a, b) for n, a, b in tr.host_ops if n == name))
    return per_call if any(per_call) else None


def ms_per_call(run, name: str) -> float | None:
    """Host time inside spans `name` (nested ones counted once), ms a traced call."""
    per_call = _in_calls(run, name)
    if per_call is None:
        return None
    return 1e3 * sum(covered(union(s), lo, hi) for s, (lo, hi) in zip(per_call, run.trace.calls)) / len(per_call)


def count_per_call(run, name: str) -> float | None:
    """Spans `name` a traced call, mean."""
    per_call = _in_calls(run, name)
    return None if per_call is None else sum(map(len, per_call)) / len(per_call)


def arity_of(hashes: int, levels: int) -> int | None:
    """The arity a for which a tree of `levels` levels holds `hashes` nodes
    above its leaves: (a^levels - 1) / (a - 1) = hashes."""
    if levels == 1:  # one node whatever the arity
        return 2 if hashes == 1 else None
    for a in range(2, hashes + 1):
        nodes = (a**levels - 1) // (a - 1)
        if nodes >= hashes:
            return a if nodes == hashes else None
    return None


def level_efficiency_pct(run, level: str, part: str) -> float | None:
    """Mean over the traced calls of 100 x (the call's hashes x level 1's
    device time a state) / (the call's device time in kernels whose name
    holds `part`).  One launch a level on one stream: the trace's such
    kernels, in order of start, are the level spans in order, matched by
    count and order rather than by the clock, on which the card's events
    may lie a little off the host's.  Level k of m holds a^(m-k) states.
    None where kernels and spans differ in number, or no arity fits a
    call's hashes."""
    per_call = _in_calls(run, level)
    hashes = run.items.get("hashes", 0)
    if per_call is None or not hashes:
        return None
    kernels = sorted((a, b) for n, a, b in run.trace.device_ops if part in n)
    if len(kernels) != sum(map(len, per_call)):
        return None
    values, k = [], 0
    for spans in per_call:
        ops, k = kernels[k:k + len(spans)], k + len(spans)
        arity = arity_of(hashes, len(spans)) if spans else None
        if arity is None:
            return None
        first_per_state = (ops[0][1] - ops[0][0]) / arity ** (len(spans) - 1)
        values.append(100.0 * hashes * first_per_state / sum(b - a for a, b in ops))
    return sum(values) / len(values)
