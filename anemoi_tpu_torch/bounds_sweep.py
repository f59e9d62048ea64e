"""The blocks an SM each Jive and permutation kernel is built for, swept on the card.

The second bound of ``__launch_bounds__`` caps a kernel's registers and
changes how ptxas schedules it: ``JIVE2_MIN_BLOCKS`` and
``JIVE4_MIN_BLOCKS`` in ``csrc/jive.cu``, ``PERMUTE_MIN_BLOCKS`` and
``PERMUTE_GROUP_MIN_BLOCKS`` in ``csrc/sponge.cu``, ``JIVE_MMA2_MIN_BLOCKS``
and ``JIVE_MMA4_MIN_BLOCKS`` in ``csrc/jive_mma.cu``,
``PERMUTE_MMA_MIN_BLOCKS``, ``SPONGE_MMA_MIN_BLOCKS`` and
``PERMUTE_MMA_THREAD_MIN_BLOCKS`` in ``csrc/sponge_mma.cu`` (the tensor-core
sources count a value in 128-thread blocks' worth of warps, the same
register budget whatever their blocks), one value per word count.  Each is
the fastest value without spills of those this sweep measures.  For each
value, the sources are built at 8 and 12 words with each of their
constants set to it by ``-D``, 16 builds at once, beside the libraries as
shipped; ``sponge_mma.cu`` is also built with quad-form blocks of 2 and 4
warps (``MMA_BLOCK_WARPS``; it ships 1) and thread-form blocks of 1 and 2
(``PERMUTE_MMA_THREAD_BLOCK_WARPS``; it ships 4), and ``jive_mma.cu`` with
blocks of 1 and 2 (``JIVE_MMA_BLOCK_WARPS``; it ships 4), each with its
shipped bounds.  Then each kernel's
registers and spills (ptxas) and resident blocks per SM are read, and it
is timed with CUDA events at its main path's size on random canonical
states or messages made on the card, its output held bit for bit against
the shipped library's:

  * ``jive_kernel<2,2>`` over 2^20 states (Vesta 2_1, BLS12-381 2_1) and
    ``jive_kernel<4,2>`` over 2^20 (Vesta 4_3, BLS12-381 4_3);
  * ``permute_group_kernel<4>`` at 4,096 states and ``permute_kernel<4>``
    at 65,536 (Vesta 4_3, BLS12-381 4_3);
  * ``jive_mma_kernel<2,2>`` and ``<4,2>`` over 2^20 states, as
    ``jive_kernel``'s;
  * the quad form's ``permute_mma_kernel<4>`` at 4,096 states and
    ``sponge_mma_kernel<4>`` over 4,096 messages of 10 KB (Vesta 4_3, 331
    elements; BLS12-381 4_3, 218), the thread form's
    ``permute_mma_thread_kernel<4>`` at 65,536 states.

Run on the card:

    python3 -m anemoi_tpu_torch.bounds_sweep [--values 1,2,...] [--sources jive_mma.cu,...] [--out FILE.json]

The fastest value moves with ptxas, so the constants are measured again
when nvcc changes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import sass
from .ff import cuda_backend
from .fields.params import get_instance
from .microbench import event_ms

MACROS = {"jive.cu": ("JIVE2_MIN_BLOCKS", "JIVE4_MIN_BLOCKS"),
          "sponge.cu": ("PERMUTE_MIN_BLOCKS", "PERMUTE_GROUP_MIN_BLOCKS"),
          "jive_mma.cu": ("JIVE_MMA2_MIN_BLOCKS", "JIVE_MMA4_MIN_BLOCKS"),
          "sponge_mma.cu": ("PERMUTE_MMA_MIN_BLOCKS", "SPONGE_MMA_MIN_BLOCKS", "PERMUTE_MMA_THREAD_MIN_BLOCKS")}
# further builds of a source with its shipped bounds: (macro, value)
SHAPES = {"sponge_mma.cu": (("MMA_BLOCK_WARPS", 2), ("MMA_BLOCK_WARPS", 4), ("PERMUTE_MMA_THREAD_BLOCK_WARPS", 1),
                            ("PERMUTE_MMA_THREAD_BLOCK_WARPS", 2)),
          "jive_mma.cu": (("JIVE_MMA_BLOCK_WARPS", 1), ("JIVE_MMA_BLOCK_WARPS", 2))}
FIELDS = {8: "vesta", 12: "bls12_381"}
# (source, kernel as ptxas names it, the macro that bounds it, instance, k or the permutation kernel, states);
# sponge_mma_kernel's fifth field is None: its E is a 10 KB message's elements; the tensor-core permutation's is
# the form, 1 the quad form and 0 the thread form
KERNELS = (
    ("jive.cu", "jive_kernel<2,2>", "JIVE2_MIN_BLOCKS", "anemoi_2_1", 2, 1 << 20),
    ("jive.cu", "jive_kernel<4,2>", "JIVE4_MIN_BLOCKS", "anemoi_4_3", 2, 1 << 20),
    ("sponge.cu", "permute_group_kernel<4>", "PERMUTE_GROUP_MIN_BLOCKS", "anemoi_4_3", 1, 4096),
    ("sponge.cu", "permute_kernel<4>", "PERMUTE_MIN_BLOCKS", "anemoi_4_3", 0, 1 << 16),
    ("jive_mma.cu", "jive_mma_kernel<2,2>", "JIVE_MMA2_MIN_BLOCKS", "anemoi_2_1", 2, 1 << 20),
    ("jive_mma.cu", "jive_mma_kernel<4,2>", "JIVE_MMA4_MIN_BLOCKS", "anemoi_4_3", 2, 1 << 20),
    ("sponge_mma.cu", "permute_mma_kernel<4>", "PERMUTE_MMA_MIN_BLOCKS", "anemoi_4_3", 1, 4096),
    ("sponge_mma.cu", "permute_mma_thread_kernel<4>", "PERMUTE_MMA_THREAD_MIN_BLOCKS", "anemoi_4_3", 0, 1 << 16),
    ("sponge_mma.cu", "sponge_mma_kernel<4>", "SPONGE_MMA_MIN_BLOCKS", "anemoi_4_3", None, 4096),
)
MSG_BYTES = 10 * 1024
LIBRARIES = {"jive.cu": cuda_backend.library, "sponge.cu": cuda_backend.sponge_library,
             "jive_mma.cu": cuda_backend.mma_library, "sponge_mma.cu": cuda_backend.sponge_mma_library}
REPS = 3


def defines(source: str, value: int) -> tuple[str, ...]:
    """The -D flags that set every constant of `source` to `value`."""
    return tuple(f"-D{m}={value}" for m in MACROS[source])


def build(source: str, words: int, value):
    """`source` at `words` words, as shipped (value None), with every
    constant set to `value`, or with the shipped bounds and the (macro,
    value) of SHAPES that `value` names."""
    if value is None:
        flags = ()
    elif isinstance(value, tuple):
        flags = (f"-D{value[0]}={value[1]}",)
    else:
        flags = defines(source, value)
    return LIBRARIES[source](words, flags)


def label(value) -> str:
    return "shipped" if value is None else f"{value[0]}={value[1]}" if isinstance(value, tuple) else str(value)


def random_states(inst, n: int, seed: int, rows: int | None = None) -> torch.Tensor:
    """int32 [rows*L, n] random canonical elements made on the card (rows
    WIDTH unless given): every limb below 2^13, the top limb cut below
    2^(bits(p) - 1)."""
    L, rows = inst.field.n_limbs, rows or inst.width
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 1 << 13, (rows, L, n), generator=gen, device="cuda", dtype=torch.int32)
    x[:, L - 1] &= (1 << (inst.field.p.bit_length() - 1 - 13 * (L - 1))) - 1
    return x.reshape(rows * L, n)


def elements(inst) -> int:
    """A 10 KB message's elements: ceil(10,240 / the field's byte chunk)."""
    return -(-MSG_BYTES // inst.field.byte_chunk)


def run_kernel(lib, source: str, inst, arg: int, x: torch.Tensor) -> torch.Tensor:
    """One launch of the named kernel of `lib` on x; not counted by the
    port's wrappers (this is not a path of the port)."""
    consts = cuda_backend.consts_words(inst).ctypes.data
    if source in ("jive.cu", "jive_mma.cu"):
        out = torch.empty((x.shape[0] // arg, x.shape[1]), dtype=torch.int32, device=x.device)
        if source == "jive.cu":
            cuda_backend._launch(lib.cdll, "anemoi_jive", x, out, inst.width, arg, consts)
        else:
            cuda_backend._launch(lib.cdll, "anemoi_jive_mma", x, out, inst.width, arg, consts,
                                 cuda_backend.fragments(inst.field, x.device).data_ptr())
    elif source == "sponge_mma.cu":
        frag = cuda_backend.fragments(inst.field, x.device).data_ptr()
        if arg is None:
            E = x.shape[0] // inst.field.n_limbs
            out = torch.empty((inst.field.n_limbs, x.shape[1]), dtype=torch.int32, device=x.device)
            cuda_backend._launch(lib.cdll, "anemoi_sponge_mma", x, out, inst.width, E, consts, frag)
        else:
            out = torch.empty_like(x)
            cuda_backend._launch(lib.cdll, "anemoi_permute_mma", x, out, inst.width, arg, consts, frag,
                                 ctypes.pointer(ctypes.c_int(-1)))
    else:
        out = torch.empty_like(x)
        cuda_backend._launch(lib.cdll, "anemoi_permute", x, out, inst.width, arg, consts,
                             ctypes.pointer(ctypes.c_int(-1)))
    return out


def blocks_per_sm(lib, kernel: str) -> int:
    name, args = kernel.split("<")
    args = [int(a) for a in args.rstrip(">").split(",")]
    if name == "jive_kernel":
        return lib.cdll.anemoi_jive_blocks_per_sm(*args)
    if name == "jive_mma_kernel":
        return lib.cdll.anemoi_jive_mma_blocks_per_sm(*args)
    if name in ("permute_mma_kernel", "sponge_mma_kernel", "permute_mma_thread_kernel"):
        which = ("permute_mma_kernel", "sponge_mma_kernel", "permute_mma_thread_kernel").index(name)
        return lib.cdll.anemoi_sponge_mma_blocks_per_sm(which, *args)
    return lib.cdll.anemoi_sponge_blocks_per_sm({"permute_kernel": 0, "permute_group_kernel": 1}[name], *args)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--values", default="1,2,3,4,5,6,7,8", help="the blocks an SM to try")
    ap.add_argument("--sources", default=",".join(MACROS), help="the sources whose kernels to sweep")
    ap.add_argument("--out", type=Path, help="write the table to this JSON file as well")
    args = ap.parse_args()
    sources = args.sources.split(",")
    if not set(sources) <= set(MACROS):
        ap.error(f"sources are {', '.join(MACROS)}")
    if not torch.cuda.is_available():
        raise SystemExit("bounds_sweep: no CUDA device")
    values = [int(v) for v in args.values.split(",")]
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    variants = {s: (None, *values, *SHAPES.get(s, ())) for s in sources}
    jobs = [(s, w, v) for s in sources for w in FIELDS for v in variants[s]]
    t = time.perf_counter()
    with ThreadPoolExecutor(min(len(jobs), 16)) as pool:  # one nvcc per build, 16 at once
        libs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs)))
    print(f"{len(jobs)} builds, 16 at once: {time.perf_counter() - t:.1f} s", flush=True)
    rows = []
    for source, kernel, macro, iname, arg, n in (k for k in KERNELS if k[0] in sources):
        for words, field in FIELDS.items():
            inst = get_instance(field, iname)
            sponge = source == "sponge_mma.cu" and arg is None
            x = random_states(inst, n, seed=words, rows=elements(inst) if sponge else None)
            want = run_kernel(libs[(source, words, None)], source, inst, arg, x)
            what = f"{n} messages of {elements(inst)} elements" if sponge else f"{n} states"
            print(f"{kernel}, {words} words ({macro}), {inst.qualified_name}, {what} ({REPS} calls after a "
                  f"warm-up, CUDA events; {smi}):\n  value | registers | spill store / load bytes | blocks per SM "
                  f"| ms", flush=True)
            table = []
            for value in variants[source]:
                lib = libs[(source, words, value)]
                regs, st, ld = sass.ptxas_table(lib.ptxas)[kernel]
                if not torch.equal(run_kernel(lib, source, inst, arg, x), want):
                    raise SystemExit(f"bounds_sweep: {kernel} at {words} words, {macro}={value}: output differs")
                ms = event_ms(lambda: run_kernel(lib, source, inst, arg, x), REPS)
                row = {"kernel": kernel, "words": words, "macro": macro, "value": label(value), "registers": regs,
                       "spill_store": st, "spill_load": ld, "blocks_per_sm": blocks_per_sm(lib, kernel), "ms": ms,
                       "instance": inst.qualified_name, "states": n}
                table.append(row)
                print(f"  {row['value']} | {regs} | {st} / {ld} | {row['blocks_per_sm']} | {ms:.3f}", flush=True)
            best = min((r for r in table if r["value"].isdigit() and not r["spill_store"] + r["spill_load"]),
                       key=lambda r: r["ms"], default=None)
            print(f"  fastest without spills: {best and best['value']} ({best and round(best['ms'], 3)} ms); "
                  f"shipped: {table[0]['registers']} registers, {table[0]['ms']:.3f} ms", flush=True)
            rows += table
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "reps": REPS, "rows": rows}, indent=1) + "\n")
    print(json.dumps({"bounds_sweep": "ok", "rows": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
