"""The closed loop: one prover that starts a call, waits for its
synchronised result and starts the next, until ``seconds`` have passed
since the window opened.  The window closes at the end of the last call,
so it holds whole calls only."""

import sys
import time
from contextlib import nullcontext


def run(entry, seconds: float, sync, mark) -> tuple[list, dict, int]:
    calls, kept, failed = [], {}, 0
    opened = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if i and t0 - opened >= seconds:
            break
        s = i % entry.n_sets
        try:
            with mark("bench.call") if mark else nullcontext():
                out = entry.call(s)
                sync()
        except Exception as exc:  # the program failed: the run is not correct
            print(f"[bench] call {i} raised {type(exc).__name__}: {exc}", file=sys.stderr)
            failed += 1
            break
        calls.append((t0, time.perf_counter()))
        kept[s] = out
        i += 1
    return calls, kept, failed
