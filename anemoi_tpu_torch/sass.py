"""What nvcc made of the kernels: ptxas's register and spill report, the
SASS (``cuobjdump -sass``) by kernel, and a comparison of the kernels built
from two source trees, for a change that must leave some of them as they
were:

    python -m anemoi_tpu_torch.sass OTHER_CSRC

builds ``jive.cu`` and ``sponge.cu`` of this package's ``csrc/`` and of
OTHER_CSRC (for example ``csrc/`` of a ``git archive`` of the parent
commit) at 8 and 12 words with the package's nvcc flags, all at once in a
temporary directory, and prints for every kernel (``jive_kernel``,
``permute_kernel``, ``permute_group_kernel``, ``sponge_kernel``) "same" when
its PTX and its SASS instructions (opcodes, registers, operands, in order)
are the same in both trees and "changed" otherwise, with how many
instructions differ and whether the binary encodings differ too; a kernel
that only this tree has is "new".  Needs nvcc and cuobjdump (the card's
machine).
"""

from __future__ import annotations

import difflib
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import _build

SASS_LINE = r"/\*[0-9a-f]{4,}\*/"  # an instruction's offset in cuobjdump's listing
OPCODE = re.compile(SASS_LINE + r"\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
COUNTED = ("LDL", "STL", "SHFL", "VOTE", "IMAD")  # local memory, shuffles, votes, multiply-adds


def kernel_name(mangled: str) -> str:
    """_Z13sponge_kernelILi4EEv... -> sponge_kernel<4>."""
    m = re.match(r"_Z\d+(\w+?)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
    return f"{m.group(1)}<{args}>"


def ptxas_table(lines: list[str]) -> dict[str, tuple[int, int, int]]:
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ptxas -v's lines (``_build.Library.ptxas``)."""
    table, cur, spills = {}, None, (0, 0)
    for line in lines:
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line):
            cur = kernel_name(m.group(1))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and cur:
            table[cur] = (int(m.group(1)), *spills)
    return table


def disassemble(lib: Path) -> str:
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc()).parent / "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True, timeout=120).stdout


def functions(text: str, start: str = "Function :", line_re: str = SASS_LINE,
              end: str | None = None) -> dict[str, list[str]]:
    """{mangled name: its lines} from a listing (SASS by default, or PTX
    with start=".entry" and end="}") whose functions open with `start` and
    the name, and close with a line `end` (or at the next function)."""
    out, cur = {}, None
    for line in text.splitlines():
        if start in line:
            cur = re.search(r"(_Z\w+)", line.split(start, 1)[1]).group(1)
            out[cur] = []
        elif cur is not None and re.search(line_re, line):
            out[cur].append(line.strip())
            if line.rstrip() == end:  # at the line's start: inner blocks are indented
                cur = None
    return out


def opcode_counts(lines: list[str]) -> dict[str, int]:
    """Instructions but NOPs, and those of COUNTED by opcode."""
    ops = [m.group(1) for line in lines if (m := OPCODE.search(line))]
    return {"instructions": sum(op != "NOP" for op in ops), **{c: ops.count(c) for c in COUNTED}}


def innermost_loop(lines: list[str]) -> list[str]:
    """The shortest body between a backward branch and its target: in the
    sponge kernel, one trip of the x^(1/alpha) ladder, one group product."""
    at = [int(re.search(r"/\*([0-9a-f]{4,})\*/", line).group(1), 16) for line in lines]
    best: list[str] = []
    for off, line in zip(at, lines):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", line)
        if m and int(m.group(1), 16) < off:
            body = [x for o, x in zip(at, lines) if int(m.group(1), 16) <= o <= off]
            best = body if not best or len(body) < len(best) else best
    return best


def kernel_counts(lib: Path) -> dict[str, dict[str, int]]:
    """{kernel: opcode_counts} over a built library, and those of its
    innermost loop under "loop"."""
    return {kernel_name(name): {**opcode_counts(lines), "loop": opcode_counts(innermost_loop(lines))}
            for name, lines in functions(disassemble(lib)).items()}


def compare(name: str, this: tuple[dict, dict], other: tuple[dict, dict]) -> str:
    """One kernel of two builds, each (SASS, PTX) functions by mangled name:
    "same" (PTX alike but for the basic-block labels, which are numbered
    across the module, and SASS instructions alike, whatever their
    encodings), "changed" (with how many instruction lines differ) or
    "new"."""
    (sass_a, ptx_a), (sass_b, ptx_b) = this, other
    if name not in sass_b:
        return f"{kernel_name(name)}: new ({len(sass_a[name])} SASS instructions)"
    a, b = ([re.sub(r"/\*.*?\*/", "", line).strip() for line in f[name]] for f in (sass_a, sass_b))
    changed = sum(line[:1] in "+-" and not line.startswith(("+++", "---"))
                  for line in difflib.unified_diff(b, a, lineterm="", n=0))
    label = lambda lines: [re.sub(r"\$L__BB\d+_", "$L__BB_", line) for line in lines or ()]
    same_ptx = label(ptx_a.get(name)) == label(ptx_b.get(name))  # blocks are numbered across the module
    return (f"{kernel_name(name)}: {'same' if same_ptx and a == b else 'changed'}; PTX "
            f"{'the same' if same_ptx else 'differs'}; SASS {len(a)} and {len(b)} instructions, "
            + ("the same" if a == b else f"{changed} lines differ")
            + ("" if sass_a[name] == sass_b[name] else " (their encodings differ)"))


def _build_one(csrc: Path, source: str, words: int, out: Path) -> tuple[dict, dict]:
    """(SASS, PTX) functions of csrc/source at `words` words."""
    stem = out / f"{csrc.parent.name}_{Path(source).stem}_{words}"
    define = f"-DANEMOI_WORDS={words}"
    lib, ptx = stem.with_suffix(".so"), stem.with_suffix(".ptx")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, define, "-o", str(lib), str(csrc / source)], check=True,
                   capture_output=True)
    subprocess.run([_build.nvcc(), "-std=c++17", "-O3", "-arch=sm_90a", "-ptx", define, "-o", str(ptx),
                    str(csrc / source)], check=True, capture_output=True)
    return functions(disassemble(lib)), functions(ptx.read_text(), ".entry", r"\S", "}")


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    trees = (_build.CSRC, Path(argv[0]).resolve())
    jobs = [(t, s, w) for t in range(2) for s in ("jive.cu", "sponge.cu") for w in (8, 12)]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(jobs)) as pool:
        dirs = [Path(tmp) / "this", Path(tmp) / "other"]
        for d in dirs:
            d.mkdir()
        built = dict(zip(jobs, pool.map(lambda j: _build_one(trees[j[0]], j[1], j[2], dirs[j[0]]), jobs)))
    for _, source, words in jobs[:4]:
        this, other = built[(0, source, words)], built[(1, source, words)]
        for name in sorted(this[0], key=kernel_name):
            print(f"{words} words, {compare(name, this, other)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
