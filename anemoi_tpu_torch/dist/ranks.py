"""Ranks of a process group as processes on one machine.

The port's counterpart of the virtual CPU devices that ``bench.py``'s
multi-chip dry run and ``__graft_entry__.py:dryrun_multichip`` give
JAX: ``run_ranks`` starts n Python processes, each joins a group of n
ranks (gloo on the CPU, NCCL on the card) through a ``file://`` store in
a fresh temporary directory, calls one function with the group's mesh,
and prints its JSON result, which the parent gathers from the rank's
output file in that directory.

    python -m anemoi_tpu_torch.dist.ranks MODULE:FUNCTION RANK WORLD STORE DEVICE KWARGS_JSON TIMEOUT

is the rank's side; ``run_ranks`` builds that command line.  A CPU rank
sees no card (``CUDA_VISIBLE_DEVICES=""``), so n ranks open no CUDA
context, and takes an equal share of the host's cores for its threads.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the directory that holds anemoi_tpu_torch/
RESULT = "rank result: "
START_S = 60  # the parent's allowance, beyond the ranks' timeout, for starting them (imports, a CUDA context)


def rank_env(device: str, world: int) -> dict:
    """The environment of one rank: the package on the path, no launcher's
    WORLD_SIZE, and on the CPU no card and 1/world of the cores."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    env.pop("WORLD_SIZE", None)
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
        env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // world))
    return env


def run_ranks(target: str, n: int, *, device: str = "cpu", kwargs: dict | None = None, timeout: float = 600) -> list:
    """Runs ``target`` ("module:function", called as f(mesh, **kwargs)) on
    n ranks of a new group and returns their JSON results in rank order.
    Each rank's output goes to files in the temporary directory.  Raises
    RuntimeError, with the end of the rank's standard error, when a rank
    exits non-zero (a group that does not form within ``timeout`` seconds
    among the causes) or the ranks outlast ``timeout`` + START_S seconds;
    the other ranks are then killed."""
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        args = [target, None, str(n), store, device, json.dumps(kwargs or {}), str(timeout)]
        procs, logs = [], [(Path(tmp) / f"rank_{r}.out", Path(tmp) / f"rank_{r}.err") for r in range(n)]
        deadline = time.monotonic() + timeout + START_S
        try:
            for r, (out, err) in enumerate(logs):
                args[1] = str(r)
                with open(out, "w") as fo, open(err, "w") as fe:
                    procs.append(subprocess.Popen([sys.executable, "-m", "anemoi_tpu_torch.dist.ranks", *args],
                                                  env=rank_env(device, n), cwd=tmp, stdout=fo, stderr=fe))
            # until every rank has ended, one has failed, or the time is up
            while None in (codes := [p.poll() for p in procs]) and not any(codes):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{target} on {n} ranks: no result within {timeout + START_S} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        results = []
        # a rank that failed first, then any that printed no result
        for r in sorted(range(n), key=lambda r: not codes[r]):
            out, err = logs[r]
            lines = [line for line in out.read_text().splitlines() if line.startswith(RESULT)]
            if codes[r] or not lines:
                raise RuntimeError(f"{target}: rank {r} of {n} exited {codes[r]}:\n{err.read_text()[-3000:]}")
            results.append((r, json.loads(lines[-1][len(RESULT):])))
    return [res for _, res in sorted(results)]


def main(argv: list[str]) -> None:
    target, rank, world, store, device, kwargs, timeout = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    from . import mesh

    if device == "cpu":
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    mesh.initialize_distributed(init_method=store, world_size=world, rank=rank, device=device, timeout=float(timeout))
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    result = fn(mesh.chip_mesh(world, device=device), **json.loads(kwargs))
    print(RESULT + json.dumps(result), flush=True)
    dist.barrier()  # every rank is done with the group
    # Leave without tearing the group down: a gloo rank's interpreter
    # shutdown can race its peers' and abort in the destructor of a thread
    # still running ("terminate called without an active exception").
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
