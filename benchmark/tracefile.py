"""A ``torch.profiler`` Chrome trace of the window, reduced to intervals.

The harness marks the window with a ``bench.window`` span and each call
with a ``bench.call`` span; the card's operations are the trace's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events.  Times are seconds
on the trace's clock.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the merged intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in intervals)


def short_name(name: str) -> str:
    return name.removeprefix("void ").split("(")[0][:120]


@dataclass
class Trace:
    window: tuple  # (start, end) of bench.window
    calls: list  # (start, end) of each bench.call
    device_ops: list  # (name, start, end) of each operation on the card
    host_ops: list  # (name, start, end) of the host's spans, sorted by start

    @classmethod
    def from_chrome(cls, doc: dict) -> "Trace":
        window, calls, dev, host = None, [], [], []
        for e in doc.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            a = float(e["ts"]) * 1e-6
            iv = (name, a, a + float(e["dur"]) * 1e-6)
            if cat == "user_annotation" and name == "bench.window":
                window = iv[1:]
            elif cat == "user_annotation" and name == "bench.call":
                calls.append(iv[1:])
            elif cat in DEVICE_CATS:
                dev.append(iv)
            elif cat in HOST_CATS:
                host.append(iv)
        if window is None:
            raise ValueError("the trace has no bench.window span")
        host.sort(key=lambda x: x[1])
        return cls(window, sorted(calls), dev, host)

    def ops(self, part: str = "") -> list:
        """Merged intervals, inside the window, of the device operations whose
        name holds `part`."""
        lo, hi = self.window
        return union((max(a, lo), min(b, hi)) for n, a, b in self.device_ops if part in n and b > lo and a < hi)

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.ops())

    def _label(self, t: float) -> str:
        """The innermost host span open at time t."""
        starts = [h[1] for h in self.host_ops]
        k = bisect.bisect_right(starts, t) - 1
        for j in range(k, max(k - 5000, -1), -1):
            name, a, b = self.host_ops[j]
            if b >= t:
                return name
        return "host outside any span"

    def breakdown(self) -> dict:
        lo, hi = self.window
        by_op: dict[str, float] = {}
        for n, a, b in self.device_ops:
            if b > lo and a < hi:
                key = short_name(n)
                by_op[key] = by_op.get(key, 0.0) + min(b, hi) - max(a, lo)
        edges = [lo] + [t for iv in self.ops() for t in iv] + [hi]
        by_gap: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                key = self._label((a + b) / 2)
                by_gap[key] = by_gap.get(key, 0.0) + b - a
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
