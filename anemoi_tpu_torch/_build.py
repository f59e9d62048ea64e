"""Builds the CUDA sources under ``csrc/`` with plain nvcc and loads them.

Each ``.cu`` file becomes a shared library with a plain C interface,
loaded with ``ctypes``: no PyTorch headers, so a build takes seconds.  The
library is named after a hash of its sources and flags, in
``build/anemoi_tpu_torch/`` beside the package, so a changed source is
rebuilt and an unchanged one is loaded as it is.  ptxas's report
(registers, spills, shared memory) is kept beside each library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

log = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "anemoi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class Library:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float | None  # None when an earlier build was loaded
    ptxas: list[str]  # ptxas's register / spill / shared-memory lines


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _ptxas_lines(text: str) -> list[str]:
    keep = ("Compiling entry", "Function properties", "registers", "spill")
    return [line.strip() for line in text.splitlines() if any(k in line for k in keep)]


def build(source: str) -> tuple[Path, float | None]:
    """Compiles csrc/<source> (and every header it may include) if its
    library is missing; returns the library's path and the build's seconds."""
    deps = sorted(CSRC.glob("*.cuh")) + [CSRC / source]
    digest = hashlib.sha256()
    for part in [*NVCC_FLAGS, *(p.read_bytes() for p in deps)]:
        digest.update(part.encode() if isinstance(part, str) else part)
    lib_path = BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n{proc.stdout}\n{proc.stderr}")
    report = _ptxas_lines(proc.stdout + proc.stderr)
    lib_path.with_suffix(".ptxas.txt").write_text("\n".join(report) + "\n")
    os.replace(tmp, lib_path)
    log.info("built %s in %.2f s", lib_path.name, seconds)
    for line in report:
        log.info("ptxas: %s", line)
    return lib_path, seconds


def load(source: str) -> Library:
    path, seconds = build(source)
    report = path.with_suffix(".ptxas.txt")
    lines = report.read_text().splitlines() if report.exists() else []
    return Library(ctypes.CDLL(str(path)), path, seconds, lines)
