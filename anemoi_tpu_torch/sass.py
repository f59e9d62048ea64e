"""What nvcc made of the kernels: ptxas's register and spill report, the
SASS (``cuobjdump -sass``) by kernel, and a comparison of the kernels built
from two source trees, for a change that must leave some of them as they
were:

    python -m anemoi_tpu_torch.sass [--sources jive_mma.cu,...] [--ptx-diff N] OTHER_CSRC

builds ``jive.cu``, ``sponge.cu``, ``jive_mma.cu`` and ``sponge_mma.cu``
of this package's ``csrc/`` and of OTHER_CSRC (for example ``csrc/`` of a
``git archive`` of the parent commit; a source it lacks is not built) at 8
and 12 words, and ``microbench.cu`` once (it holds both word counts'
kernels), with the package's nvcc flags, all at once in a temporary
directory, and prints for every kernel (``jive_kernel``,
``permute_kernel``, ``permute_group_kernel``, ``sponge_kernel``,
``jive_mma_kernel``, ``permute_mma_kernel``, ``sponge_mma_kernel``,
``permute_mma_thread_kernel``, ``sqr_chain_kernel``, ``mad_loop_kernel``)
"same" when its PTX and its SASS instructions (opcodes, registers,
operands, in order) are the same in both trees and "changed" otherwise,
with how many instructions differ and whether the binary encodings differ
too; a kernel that only this tree has is "new".  ``--sources`` builds only
the sources named; ``--ptx-diff N`` prints, under each kernel whose PTX
differs, the first N lines of the difference (``ptx_labelled``);
OTHER_CSRC the package's own ``csrc/`` builds each source twice, to tell
a change from a build that differs from itself.  For each tensor-core
kernel (``MMA_KERNELS``) it also prints its registers and spills (ptxas)
and the instructions of one product (``product_mix`` of ``product_loop``,
a trip of the x^(1/alpha) window's loop over the products that trip runs:
one squaring and one product in the one-state-a-thread kernels, one N-fold
product of the width's columns in the quad-form ones): IMMA, IMAD,
shuffles, votes and the other integer instructions.  Needs nvcc and cuobjdump (the card's
machine).
"""

from __future__ import annotations

import argparse
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
# what is not integer ALU work in product_mix: the tensor cores, multiply-adds, lane traffic, memory, control
NOT_ALU = ("IMMA", "IMAD", "SHFL", "VOTE", "LDS", "STS", "LDG", "STG", "LDL", "STL", "LDC", "ULDC", "BRA", "BAR",
           "BSSY", "BSYNC", "WARPSYNC", "EXIT", "NOP", "CALL", "RET")
SOURCES = ("jive.cu", "sponge.cu", "jive_mma.cu", "sponge_mma.cu", "microbench.cu")
# the word counts a source is built for (-DANEMOI_WORDS); microbench.cu is one library for both
BUILT_WORDS = {"microbench.cu": (8,)}
# the tensor-core kernels, by source: their product's reduction runs as mma.sync (IMMA)
MMA_KERNELS = {"jive_mma.cu": ("jive_mma_kernel",),
               "sponge_mma.cu": ("permute_mma_kernel", "sponge_mma_kernel", "permute_mma_thread_kernel")}
# those of them in the quad form (field32_mma.cuh): the columns of a round run side by side, and a squaring is
# the product by the value itself
QUAD_KERNELS = ("permute_mma_kernel", "sponge_mma_kernel")


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


def product_mix(lines: list[str], products: int = 1) -> dict[str, float]:
    """Instructions by kind over `products` products: IMMA (tensor cores),
    IMAD, SHFL, VOTE, ALU (every other instruction but memory and control,
    NOT_ALU) and all but NOPs."""
    ops = [m.group(1) for line in lines if (m := OPCODE.search(line))]
    mix = {k: ops.count(k) for k in ("IMMA", "IMAD", "SHFL", "VOTE")}
    mix["ALU"] = sum(op not in NOT_ALU for op in ops)
    mix["instructions"] = sum(op != "NOP" for op in ops)
    return {k: v / products for k, v in mix.items()}


def innermost_loop(lines: list[str], holding: str | None = None, least: int = 1,
                   without: str | None = None) -> list[str]:
    """The shortest body between a backward branch and its target (of those
    that hold at least `least` instructions of opcode `holding`, if given,
    and none of opcode `without`): in the sponge kernel, one trip of the
    x^(1/alpha) ladder, one group product; in a tensor-core kernel, with
    holding="IMMA", the window table's trip (one product), with `least`
    twice a product's IMMAs, the window's trip of a one-state-a-thread
    kernel (a squaring and a product), and without="STS" that of a
    quad-form kernel (one product; the table's trip stores its entry)."""
    at = [int(re.search(r"/\*([0-9a-f]{4,})\*/", line).group(1), 16) for line in lines]
    best: list[str] = []
    for off, line in zip(at, lines):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", line)
        if m and int(m.group(1), 16) < off:
            body = [x for o, x in zip(at, lines) if int(m.group(1), 16) <= o <= off]
            ops = [op.group(1) for x in body if (op := OPCODE.search(x))]
            if (holding and ops.count(holding) < least) or (without and without in ops):
                continue
            best = body if not best or len(body) < len(best) else best
    return best


def product_loop(kernel: str, lines: list[str]) -> tuple[list[str], int]:
    """(the x^(1/alpha) window's trip, the products in it) of tensor-core
    kernel<width, ...>'s SASS lines.  In the quad form (QUAD_KERNELS), the
    shortest loop holding an IMMA and no shared-memory store (the table's
    trip stores its entry): one product of the width's columns side by
    side, a squaring and a product sharing its code.  Otherwise the shortest
    loop holding twice the IMMAs of the shortest loop that holds any (the
    table's trip, one product): one squaring and one product."""
    name, args = kernel.split("<")
    if name in QUAD_KERNELS:
        return innermost_loop(lines, "IMMA", without="STS"), int(args.split(",")[0].rstrip(">")) // 2
    per = int(product_mix(innermost_loop(lines, "IMMA"))["IMMA"])
    return innermost_loop(lines, "IMMA", least=2 * max(per, 1)), 2


def compare(name: str, this: tuple[dict, dict], other: tuple[dict, dict]) -> str:
    """One kernel of two builds, each (SASS, PTX) functions by mangled name:
    "same" (PTX alike but for the numbers of its labels and virtual
    registers, ``ptx_labelled``, and SASS instructions alike, whatever their
    encodings), "changed" (with how many instruction lines differ) or
    "new"."""
    (sass_a, ptx_a), (sass_b, ptx_b) = this, other
    if name not in sass_b:
        return f"{kernel_name(name)}: new ({len(sass_a[name])} SASS instructions)"
    a, b = ([re.sub(r"/\*.*?\*/", "", line).strip() for line in f[name]] for f in (sass_a, sass_b))
    changed = sum(line[:1] in "+-" and not line.startswith(("+++", "---"))
                  for line in difflib.unified_diff(b, a, lineterm="", n=0))
    same_ptx = ptx_labelled(ptx_a.get(name)) == ptx_labelled(ptx_b.get(name))
    return (f"{kernel_name(name)}: {'same' if same_ptx and a == b else 'changed'}; PTX "
            f"{'the same' if same_ptx else 'differs'}; SASS {len(a)} and {len(b)} instructions, "
            + ("the same" if a == b else f"{changed} lines differ")
            + ("" if sass_a[name] == sass_b[name] else " (their encodings differ)"))


def ptx_labelled(lines: list[str] | None) -> list[str]:
    """A function's PTX lines with its basic-block labels numbered alike
    (they are numbered across the module) and its virtual registers
    renamed in the order they first appear, their declared counts left out:
    nvcc at 12 words numbers them differently from one build of the same
    source to the next (``jive_mma_kernel<2,2>``'s %r12105 in one build is
    %r12107 in its twin)."""
    names: dict[str, str] = {}
    counts: dict[str, int] = {}

    def rename(m: re.Match) -> str:
        if m.group(0) not in names:
            names[m.group(0)] = f"%{m.group(1)}_{counts.get(m.group(1), 0)}"
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        return names[m.group(0)]

    out = []
    for line in lines or ():
        line = re.sub(r"\$L__BB\d+_", "$L__BB_", line)
        line = re.sub(r"(%[a-z]+)<\d+>", r"\1<>", line)
        out.append(re.sub(r"%(rd|rs|r|p|fd|f|h)\d+\b", rename, line))
    return out


def ptx_diff(name: str, this: tuple[dict, dict], other: tuple[dict, dict], limit: int) -> list[str]:
    """The first `limit` lines of the unified difference of one kernel's
    PTX (``ptx_labelled``), from the other build's to this one's."""
    diff = difflib.unified_diff(ptx_labelled(other[1].get(name)), ptx_labelled(this[1].get(name)), lineterm="", n=1)
    return [line for line, _ in zip(diff, range(limit))]


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
    ap = argparse.ArgumentParser(prog="python -m anemoi_tpu_torch.sass", description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc", help="the csrc/ directory of the other tree")
    ap.add_argument("--sources", default=",".join(SOURCES), help="comma-separated sources to build")
    ap.add_argument("--ptx-diff", type=int, default=0, help="lines of each differing kernel's PTX difference")
    args = ap.parse_args(argv)
    sources = [s for s in SOURCES if s in args.sources.split(",")]
    trees = (_build.CSRC, Path(args.other_csrc).resolve())
    jobs = [(t, s, w) for t in range(2) for s in sources for w in BUILT_WORDS.get(s, (8, 12))
            if (trees[t] / s).exists()]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(jobs)) as pool:
        dirs = [Path(tmp) / "this", Path(tmp) / "other"]
        for d in dirs:
            d.mkdir()
        built = dict(zip(jobs, pool.map(lambda j: _build_one(trees[j[0]], j[1], j[2], dirs[j[0]]), jobs)))
    for source in sources:
        for words in BUILT_WORDS.get(source, (8, 12)):
            this, other = built[(0, source, words)], built.get((1, source, words), ({}, {}))
            label = source if source in BUILT_WORDS else f"{words} words"
            for name in sorted(this[0], key=kernel_name):
                print(f"{label}, {compare(name, this, other)}", flush=True)
                if args.ptx_diff and name in other[0]:
                    for line in ptx_diff(name, this, other, args.ptx_diff):
                        print(f"    {line}", flush=True)
            if source in MMA_KERNELS:
                print_mma_report(source, words)
    return 0


def mma_report(lib) -> dict[str, dict]:
    """{kernel<...>: its registers, spill store and load bytes, the whole
    kernel's ``product_mix`` and one product's (``product_loop``'s trip over
    its products)} for each tensor-core kernel of a built ``jive_mma.cu`` or
    ``sponge_mma.cu`` library (``_build.Library``)."""
    regs = ptxas_table(lib.ptxas)
    out = {}
    for name, lines in functions(disassemble(lib.path)).items():
        kernel = kernel_name(name)
        if kernel.startswith(sum(MMA_KERNELS.values(), ())):
            r, st, ld = regs[kernel]
            out[kernel] = {"registers": r, "spill_store": st, "spill_load": ld, "whole": product_mix(lines),
                           "product": product_mix(*product_loop(kernel, lines))}
    return out


def print_mma_report(source: str, words: int) -> None:
    """``mma_report`` of the package's own build of `source` at `words` words."""
    from .ff import cuda_backend

    library = {"jive_mma.cu": cuda_backend.mma_library, "sponge_mma.cu": cuda_backend.sponge_mma_library}[source]
    for kernel, r in mma_report(library(words)).items():
        print(f"{words} words, {kernel}: {r['registers']} registers, spills {r['spill_store']}/{r['spill_load']} "
              f"bytes; a product: " + ", ".join(f"{k} {v:g}" for k, v in r["product"].items()), flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
