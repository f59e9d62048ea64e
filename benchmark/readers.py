"""What the metric readers under ``metrics/`` share.

A reader returns None where it finds nothing to read (no trace, no kernel
of its name, a card with no published peaks), and the harness then leaves
its metric out of the line.
"""

from __future__ import annotations

import numpy as np

from . import roofline
from .tracefile import covered


def rate(run, item: str) -> float:
    """Items of the whole calls in the window over the window's wall time."""
    return run.total(item) / run.wall_s


def ms_per(run, item: str) -> float:
    return 1e3 * run.wall_s / run.total(item)


def latency_ms(run, q: float) -> float:
    """The q-th percentile of the calls' latencies."""
    return float(np.percentile([1e3 * (b - a) for a, b in run.calls], q))


def idle_pct(run) -> float | None:
    tr = run.trace
    if tr is None or tr.window_s() <= 0:
        return None
    return 100.0 * (tr.window_s() - tr.busy_s()) / tr.window_s()


def kernel_roofline_pct(run, part: str, kind: str) -> float | None:
    """The least time of the traced calls' `kind` work over the device time
    of the kernels whose name holds `part`."""
    tr = run.trace
    if tr is None or not tr.calls or kind not in run.work:
        return None
    least = roofline.least_time(run.work[kind] * len(tr.calls), run.device_name)
    busy = sum(b - a for a, b in tr.ops(part))
    if least is None or busy <= 0:
        return None
    return 100.0 * least[0] / busy


def outside_pct(run, part: str) -> float | None:
    """The share of the traced calls' wall time in which no kernel whose
    name holds `part` runs."""
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    ops = tr.ops(part)
    if not ops:
        return None
    wall = sum(b - a for a, b in tr.calls)
    inside = sum(covered(ops, a, b) for a, b in tr.calls)
    return 100.0 * (wall - inside) / wall

