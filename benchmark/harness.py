"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` is the whole run after the command line has found a card;
``run.py`` is its command line.  The window is the traffic's loop
(``loops/<loop>.py``; ``closed`` where the traffic names none: one prover
that waits for each synchronised result, whole calls only).  The harness
drives one process on one card: a cell on four cards needs more of it
(its ranks started, the peak read on the fullest card).

After the window: the modules are checked for JAX, the memory peak is
read, the sampled answers are copied to the host, the program's state is
freed, and the reference recomputes the sample (``judge.py``).  With
``trace`` the window runs under ``torch.profiler`` and the cell's
per-layer metrics are read from its trace; without it, its end-to-end
metrics from the host clock.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from functools import partial

from . import generator, judge, spec
from .tracefile import Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "anemoi_tpu")


class ForbiddenModules(RuntimeError):
    pass


@dataclass
class Run:
    """What a metric's reader reads."""

    device_name: str
    setup_s: float
    calls: list  # (start, end) host seconds of each call in the window
    items: dict  # per call
    work: dict  # per call: kind -> roofline.Work
    trace: Trace | None = None

    @property
    def wall_s(self) -> float:
        return self.calls[-1][1] - self.calls[0][0]

    def total(self, item: str) -> float:
        return self.items.get(item, 0) * len(self.calls)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float, device=None,
             traffic_overrides: dict | None = None, workers: int | None = None, control: bool = False) -> dict:
    """Runs cell `name` once and returns the result line's object, with
    "checks" last.  ``device`` None means card 0; a CPU device is for the
    benchmark's own tests only.  ``control`` judges the control's answers
    (the reference with the final reduction skipped) in the program's place."""
    import torch

    t_import = time.perf_counter()
    bench = spec.load()
    cell = spec.workload(bench, name)
    cfg = spec.config(cell["config"])
    traffic = {**spec.traffic(cell["traffic"]), **(traffic_overrides or {})}
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

    entry = generator.build(cfg, traffic, seed, device)
    _sync(torch, device)
    t_inputs = time.perf_counter()
    for w in range(traffic.get("warmup_calls", 1)):
        entry.call(w % entry.n_sets)
    _sync(torch, device)
    setup_s = time.perf_counter() - t_start
    print(f"[bench] set-up {setup_s:.3f} s: to torch imported {t_import - t_start:.3f}, card and inputs "
          f"{t_inputs - t_import:.3f}, warm-up {t_start + setup_s - t_inputs:.3f}", file=sys.stderr)

    loop = spec.loop(traffic.get("loop", "closed"))
    sync = partial(_sync, torch, device)
    tmp = tempfile.mkdtemp(prefix="bench_trace_") if trace else None
    try:
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("bench.window"):
                    calls, kept, failed = loop.run(entry, seconds, sync, torch.profiler.record_function)
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            with open(path) as f:
                tr = Trace.from_chrome(json.load(f))
        else:
            calls, kept, failed = loop.run(entry, seconds, sync, None)
            tr = None
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)

    if calls:
        ms = sorted(1e3 * (b - a) for a, b in calls)
        print(f"[bench] window {calls[-1][1] - calls[0][0]:.3f} s, {len(calls)} calls; a call's ms: min {ms[0]:.3f}, "
              f"median {ms[len(ms) // 2]:.3f}, max {ms[-1]:.3f}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"loaded after the window: {', '.join(found)}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the sampled answers go to the host; then the program's state is freed
    error = None
    try:
        tasks, answers = judge.gather(entry, kept)
    except Exception as exc:  # an output of the wrong shape or type
        error = f"{type(exc).__name__}: {exc}"
        tasks, answers = [], []
    run = Run(device_name, setup_s, calls, entry.items, entry.work, tr)
    what = entry.answers
    del entry, kept
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    verdict = judge.compare(tasks, answers, workers=workers, control=control)
    if error:
        print(f"[bench] the outputs could not be read: {error}", file=sys.stderr)

    checks = {f"wrong_{what}": {"value": verdict["wrong"], "limit": 0, "of": verdict["compared"]}}
    correct = error is None and not failed and verdict["compared"] > 0 and verdict["wrong"] == 0
    metrics = {}
    if calls:
        for m in spec.metrics_for(bench, name, trace):
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": len(calls) + failed,
        "failed": failed + verdict["wrong_calls"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": device_name,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"].update({"busy_s": tr.busy_s(), "window_s": tr.window_s()})
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result
