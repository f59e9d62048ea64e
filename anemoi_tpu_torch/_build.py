"""Builds the port's native sources and loads them with ``ctypes``.

Each ``.cu`` file under ``csrc/`` becomes a shared library with a plain C
interface, built by plain nvcc for ``sm_90a``: no PyTorch headers, so a
build takes seconds.  A source may be built more than once with different
``-D`` defines (``jive.cu`` and ``sponge.cu`` once per word count), each
build its own library.  The host library of the byte packer
(``native/anemoi_host.cpp``, shared with the JAX package and never written
to) is built by g++ the same way.  A library is named after a hash of its
sources and flags, in ``build/anemoi_tpu_torch/`` beside the package, so a
changed source is rebuilt and an unchanged one is loaded as it is.
ptxas's report (registers, spills, shared memory) is kept beside each CUDA
library.
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
ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = ROOT / "build" / "anemoi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# no -march=native: the library must run on whichever host loads it
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


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


def _compile(source: Path, deps: list[Path], compiler: str, flags: tuple) -> tuple[Path, float | None]:
    """Compiles `source` into BUILD_DIR if its library (keyed by the hash of
    `deps` and `flags`) is missing; returns its path and the build's seconds."""
    digest = hashlib.sha256()
    for part in [*flags, *(p.read_bytes() for p in deps)]:
        digest.update(part.encode() if isinstance(part, str) else part)
    lib_path = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed ({proc.returncode}) for {source.name}:\n{proc.stdout}\n{proc.stderr}")
    report = _ptxas_lines(proc.stdout + proc.stderr)
    if report:
        lib_path.with_suffix(".ptxas.txt").write_text("\n".join(report) + "\n")
    os.replace(tmp, lib_path)
    log.info("built %s in %.2f s", lib_path.name, seconds)
    return lib_path, seconds


def build(source: str, defines: tuple[str, ...] = ()) -> tuple[Path, float | None]:
    """Compiles csrc/<source> (and every header it may include) with the
    given ``-D`` flags if its library is missing; returns the library's path
    and the build's seconds."""
    deps = sorted(CSRC.glob("*.cuh")) + [CSRC / source]
    return _compile(CSRC / source, deps, nvcc(), NVCC_FLAGS + tuple(defines))


def load(source: str, defines: tuple[str, ...] = ()) -> Library:
    path, seconds = build(source, defines)
    report = path.with_suffix(".ptxas.txt")
    lines = report.read_text().splitlines() if report.exists() else []
    return Library(ctypes.CDLL(str(path)), path, seconds, lines)


def load_host(source: Path) -> Library:
    """A C++ source of the host, built by g++ into BUILD_DIR at first use."""
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the host library cannot be built")
    path, seconds = _compile(source, [source], compiler, GXX_FLAGS)
    return Library(ctypes.CDLL(str(path)), path, seconds, [])
