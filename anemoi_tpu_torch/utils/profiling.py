"""Tracing and section timing.

Counterpart of ``anemoi_tpu/utils/profiling.py``: ``trace`` wraps
``torch.profiler.profile`` (with CUDA activity when a card is present) and
writes a Chrome trace, which names every kernel the card ran; ``Timer``
times named sections, synchronizing the card around each one so that a
section times the device's work, not its enqueue.  ``span`` marks a span
of the program in the trace of a running ``torch.profiler``, and costs a
check when none runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch

from ..ff import cuda_backend

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records a span `name` in the trace of the
    ``torch.profiler`` recording in this process (a ``user_annotation``
    event on the trace's clock, nested as entered), and the shared no-op
    context when none records.  Names are fixed constants."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(out_dir):
    """Profiles the block and writes a Chrome trace into `out_dir`:

        with trace("traces") as prof:
            run()
        prof.trace_path  # the JSON file written

    The profiler object is yielded (``key_averages()`` sums the time of
    each kernel); its ``trace_path`` is set once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.trace_path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_path))


class Timer:
    """Host-clock timing of named sections on ``device`` (None: the card);
    on the card each section synchronizes on entry and on exit, so it times
    the work it enqueued."""

    def __init__(self, device=None):
        self.device = cuda_backend.resolve_device(device)
        self.sections: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.sections[name] = self.sections.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.sections.values())
        return "\n".join(f"{k}: {v * 1e3:.2f} ms ({v / total:.0%})" for k, v in self.sections.items())
