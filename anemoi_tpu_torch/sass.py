"""What nvcc made of the kernels: ptxas's register and spill report, the
SASS (``cuobjdump -sass``) by kernel, and a comparison of the kernels built
from two source trees, for a change that must leave some of them as they
were:

    python -m anemoi_tpu_torch.sass OTHER_CSRC

builds ``jive.cu``, ``sponge.cu``, ``jive_mma.cu`` and ``sponge_mma.cu``
of this package's ``csrc/`` and of OTHER_CSRC (for example ``csrc/`` of a
``git archive`` of the parent commit; a source it lacks is not built) at 8
and 12 words, and ``microbench.cu`` once (it holds both word counts'
kernels), with the package's nvcc flags, all at once in a temporary
directory, and prints for every kernel (``jive_kernel``,
``permute_kernel``, ``permute_group_kernel``, ``sponge_kernel``,
``jive_mma_kernel``, ``permute_mma_kernel``, ``sponge_mma_kernel``,
``sqr_chain_kernel``, ``mad_loop_kernel``)
"same" when its PTX and its SASS instructions (opcodes, registers,
operands, in order) are the same in both trees and "changed" otherwise,
with how many instructions differ and whether the binary encodings differ
too; a kernel that only this tree has is "new".  For each tensor-core
kernel (``MMA_KERNELS``) it also prints its registers and spills (ptxas)
and the instructions of one product (``product_mix`` of ``product_loop``:
for ``jive_mma_kernel``, whose x^(1/alpha) is the window, a trip of the
window's loop, one squaring and one product; for the others a trip of the
ladder, over the products that trip runs): IMMA, IMAD, shuffles, votes
and the other integer instructions.  Needs nvcc and cuobjdump (the card's
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
# what is not integer ALU work in product_mix: the tensor cores, multiply-adds, lane traffic, memory, control
NOT_ALU = ("IMMA", "IMAD", "SHFL", "VOTE", "LDS", "STS", "LDG", "STG", "LDL", "STL", "LDC", "ULDC", "BRA", "BAR",
           "BSSY", "BSYNC", "WARPSYNC", "EXIT", "NOP", "CALL", "RET")
SOURCES = ("jive.cu", "sponge.cu", "jive_mma.cu", "sponge_mma.cu", "microbench.cu")
# the word counts a source is built for (-DANEMOI_WORDS); microbench.cu is one library for both
BUILT_WORDS = {"microbench.cu": (8,)}
# the tensor-core kernels, by source: their product's reduction runs as mma.sync (IMMA)
MMA_KERNELS = {"jive_mma.cu": ("jive_mma_kernel",), "sponge_mma.cu": ("permute_mma_kernel", "sponge_mma_kernel")}
# those of them whose x^(1/alpha) is the 4-bit window (the others run the binary ladder)
WINDOW_KERNELS = ("jive_mma_kernel",)


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


def innermost_loop(lines: list[str], holding: str | None = None, least: int = 1) -> list[str]:
    """The shortest body between a backward branch and its target (of those
    that hold at least `least` instructions of opcode `holding`, if given):
    in the sponge kernel, one trip of the x^(1/alpha) ladder, one group
    product; in a tensor-core kernel, with holding="IMMA", the ladder's trip
    or the window table's (one product), and with `least` twice a product's
    IMMAs, the window's (a squaring and a product)."""
    at = [int(re.search(r"/\*([0-9a-f]{4,})\*/", line).group(1), 16) for line in lines]
    best: list[str] = []
    for off, line in zip(at, lines):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", line)
        if m and int(m.group(1), 16) < off:
            body = [x for o, x in zip(at, lines) if int(m.group(1), 16) <= o <= off]
            if holding and sum(bool((op := OPCODE.search(x)) and op.group(1) == holding) for x in body) < least:
                continue
            best = body if not best or len(body) < len(best) else best
    return best


def product_loop(kernel: str, lines: list[str]) -> tuple[list[str], int]:
    """(the loop whose trip ``mma_report`` counts, the products in a trip)
    of tensor-core kernel<width, ...>'s SASS lines.  Under the window
    (WINDOW_KERNELS): the shortest loop holding twice the IMMAs of the
    shortest loop that holds any (the table's trip, one product), that is
    the window's trip, one squaring and one product.  Under the ladder: the
    shortest loop holding an IMMA, one product of the width's columns."""
    name, args = kernel.split("<")
    if name in WINDOW_KERNELS:
        per = int(product_mix(innermost_loop(lines, "IMMA"))["IMMA"])
        return innermost_loop(lines, "IMMA", least=2 * max(per, 1)), 2
    return innermost_loop(lines, "IMMA"), int(args.split(",")[0].rstrip(">")) // 2


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
    jobs = [(t, s, w) for t in range(2) for s in SOURCES for w in BUILT_WORDS.get(s, (8, 12))
            if (trees[t] / s).exists()]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(jobs)) as pool:
        dirs = [Path(tmp) / "this", Path(tmp) / "other"]
        for d in dirs:
            d.mkdir()
        built = dict(zip(jobs, pool.map(lambda j: _build_one(trees[j[0]], j[1], j[2], dirs[j[0]]), jobs)))
    for source in SOURCES:
        for words in BUILT_WORDS.get(source, (8, 12)):
            this, other = built[(0, source, words)], built.get((1, source, words), ({}, {}))
            label = source if source in BUILT_WORDS else f"{words} words"
            for name in sorted(this[0], key=kernel_name):
                print(f"{label}, {compare(name, this, other)}", flush=True)
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
