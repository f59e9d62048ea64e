"""Runs one cell of the benchmark once, on the card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks' numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output.
Exits non-zero, with no result, where there is no card (or fewer than the
cell asks for) and where JAX or the JAX package was loaded.

``--control 1`` judges the control in the program's place (see judge.py):
its runs must come out not correct.

This module imports only the standard library at its top: the reference's
spawned workers import it again.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _process_age() -> float:
    """Seconds since this process started, from /proc, else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), time.perf_counter() - T_START)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() - _process_age()
    _caches()

    from benchmark import harness, spec

    cell = spec.workload(spec.load(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"[bench] {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start,
                                  control=bool(args.control))
    except harness.ForbiddenModules as exc:
        print(f"[bench] {exc}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[bench] check {name}: {c['value']} (limit {c['limit']}, of {c['of']} compared)", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
