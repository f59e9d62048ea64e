"""Two microbenchmarks of the card's integer rate, with their plain versions.

Counterparts of the repo's two TPU measurement tools, whose kernels are
ported to ``csrc/microbench.cu``:

  * ``sqr_chain`` (``tools/mxu_prototype.py:chain_kernel``): n_iter serial
    Montgomery squarings of every lane of an int32 [L, N] limb tensor,
    through the hash kernels' field code at 8 words (L = 20) or 12 words
    (L = 30).  ``check_chain`` holds an 8-deep chain against Python ints,
    as the tool's ``check_correct`` does; ``measure_chain`` times the slope
    between two trip counts, as its ``measure`` does.
  * ``mad_loop`` (``tools/microbench_layout.py:time_body``): each element
    runs ``acc = (acc * acc + i) & 0x1FFF`` for i < n_iter.
    ``measure_mad`` times the slope at the tool's shapes (``MAD_SHAPES``)
    and at one that fills the card.

Each wrapper launches its kernel for a tensor on the card and runs its
plain version for a tensor on the CPU, and counts its launches.  Times come
from CUDA events.  Run on the card:

    python -m anemoi_tpu_torch.microbench
"""

from __future__ import annotations

import ctypes
import math
import re
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from . import _build, sass
from .ff import cuda_backend
from .ff import limb_ops as lo
from .fields.params import FieldParams, get_field, get_instance

# the shapes tools/microbench_layout.py:main sweeps
MAD_SHAPES = ((512,), (1024,), (4, 128), (8, 128), (1, 512), (8, 512), (20, 512), (20, 8, 128))
MAD_MASK = 0x1FFF
BLOCK = 128  # threads a block in microbench.cu


def imads_per_reduction(words: int, pasta: bool = False) -> int:
    """32-bit multiply-adds of one Montgomery reduction (field32.cuh's CIOS):
    any modulus (F32AnyModulus), words^2 m*p word products, low and high
    halves each, and `words` low products m = t0 * n0, 136 at 8 words; the
    Pasta moduli's shape (F32PastaModulus, 8 words only), m*p[1..3] alone,
    48."""
    return 2 * 3 * words if pasta else 2 * words * words + words


def imads_per_product(words: int, pasta: bool = False) -> int:
    """The same for one product (f32_mont_mul): words^2 a*b word products,
    low and high halves each, and the reduction.  264 at 8 words (176 under
    the Pasta shape), 588 at 12."""
    return 2 * words * words + imads_per_reduction(words, pasta)


def imads_per_squaring(words: int, pasta: bool = False) -> int:
    """The same for a squaring (f32_mont_sqr), which forms each of its
    words(words+1)/2 distinct a_i*a_j once.  208 at 8 words (120 under the
    Pasta shape), 456 at 12."""
    return 2 * (words * (words + 1) // 2) + imads_per_reduction(words, pasta)


@lru_cache(maxsize=None)
def library() -> _build.Library:
    """microbench.cu, built at first use, with its C interface declared."""
    built = _build.load("microbench.cu")
    lib = built.cdll
    cuda_backend.declare(lib, {
        "anemoi_sqr_chain": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "anemoi_mad_loop": [ctypes.c_int],
    })
    lib.anemoi_microbench_consts_words.argtypes = [ctypes.c_int]
    lib.anemoi_microbench_consts_words.restype = ctypes.c_int
    for words in cuda_backend.KERNEL_WORDS:
        if lib.anemoi_microbench_consts_words(words) != cuda_backend.consts_len(words):
            raise RuntimeError(f"AnemoiConsts<{words}> in microbench.cu and consts_words() disagree on the layout")
    return built


def _on_card(x, what: str) -> bool:
    """Validates an int32 input; True when it goes to the kernel."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise ValueError(f"{what}: expected an int32 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the input must be contiguous")
    return True


# --------------------------------------------------------------------------
# the squaring chain
# --------------------------------------------------------------------------


def sqr_chain_plain(fp: FieldParams, x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """The plain PyTorch version: ``limb_ops.mont_sqr`` n_iter times, then
    ``canonicalize``."""
    fc = lo.field_consts(fp)
    for _ in range(n_iter):
        x = lo.mont_sqr(x, fc)
    return lo.canonicalize(x, fc)


def sqr_chain(fp: FieldParams, x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """n_iter Montgomery squarings of every lane: int32 [L, N] canonical
    Montgomery limbs -> the same.  A CUDA tensor goes to the kernel (or the
    call raises), a CPU tensor to ``sqr_chain_plain``."""
    L = fp.n_limbs
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    on_card = _on_card(x, "sqr_chain")
    if x.dim() != 2 or x.shape[0] != L:
        raise ValueError(f"expected [{L}, N], got {tuple(x.shape)}")
    if not on_card:
        return sqr_chain_plain(fp, x, n_iter)
    out = torch.empty_like(x)
    if x.shape[1] == 0:
        return out
    consts = cuda_backend.consts_words(get_instance(fp.name, "anemoi_2_1"))
    cuda_backend._launch(library().cdll, "anemoi_sqr_chain", x, out, n_iter, fp.kernel_words, consts.ctypes.data)
    sqr_chain.launches += 1
    return out


sqr_chain.launches = 0


# --------------------------------------------------------------------------
# the multiply-add loop
# --------------------------------------------------------------------------


def mad_loop_plain(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """The plain PyTorch version: a loop of int32 torch ops (``*`` wraps
    mod 2^32)."""
    acc = x.clone()
    for i in range(n_iter):
        acc = (acc * acc + i) & MAD_MASK
    return acc


def mad_loop(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """n_iter iterations of acc = (acc * acc + i) & 0x1FFF on every element
    of an int32 tensor of any shape.  A CUDA tensor goes to the kernel (or
    the call raises), a CPU tensor to ``mad_loop_plain``."""
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if not _on_card(x, "mad_loop"):
        return mad_loop_plain(x, n_iter)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    cuda_backend._launch(library().cdll, "anemoi_mad_loop", x.view(1, -1), out.view(1, -1), n_iter)
    mad_loop.launches += 1
    return out


mad_loop.launches = 0


# --------------------------------------------------------------------------
# checks and timing on the card
# --------------------------------------------------------------------------


def check_chain(field: str, lanes: int, device, seed: int = 3) -> None:
    """An 8-deep chain against Python ints (tools/mxu_prototype.py:
    check_correct): in Montgomery form x*R squares to x^2*R, so the chain
    gives x^(2^8)."""
    fp = get_field(field)
    rng = np.random.default_rng(seed)
    vals = [int(rng.integers(0, 2**62)) * int(rng.integers(1, 2**62)) % fp.p for _ in range(lanes)]
    got = lo.decode_ints(sqr_chain(fp, lo.encode_ints(vals, fp).to(device), 8), fp)
    want = [pow(v, 1 << 8, fp.p) for v in vals]
    if got != want:
        raise AssertionError(f"{field}: the 8-deep squaring chain differs from Python ints")


def event_ms(fn, reps: int) -> float:
    """Mean ms of fn() over `reps` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def slope(run, n1: int, n2: int, reps: int) -> dict:
    """The time of run(n1) and run(n2) and the slope between them, which
    cancels the launch and the work outside the loop."""
    ms1, ms2 = event_ms(lambda: run(n1), reps), event_ms(lambda: run(n2), reps)
    return {"n1": n1, "n2": n2, "ms1": ms1, "ms2": ms2, "ms_per_iter": (ms2 - ms1) / (n2 - n1)}


def measure_chain(field: str, lanes: int, n1: int, n2: int, reps: int, device, seed: int = 0) -> dict:
    """ns per squaring per lane over `lanes` lanes, and the IMAD rate it
    implies at ``imads_per_squaring`` of the field's word count."""
    fp = get_field(field)
    x = torch.from_numpy(lo.random_canonical(fp, (lanes,), np.random.default_rng(seed))).to(device)
    s = slope(lambda n: sqr_chain(fp, x, n), n1, n2, reps)
    sqr_per_s = lanes / (s["ms_per_iter"] / 1e3)
    imads = imads_per_squaring(fp.kernel_words)
    return {**s, "field": field, "words": fp.kernel_words, "lanes": lanes,
            "ns_per_sqr_per_lane": s["ms_per_iter"] * 1e6 / lanes, "sqr_per_s": sqr_per_s,
            "imads_per_sqr": imads, "imads_per_s": sqr_per_s * imads}


def measure_mad(shape: tuple, n1: int, n2: int, reps: int, device, *, sms: int, clock_mhz: float,
                seed: int = 0) -> dict:
    """The multiply-add loop's slope at `shape`: ns per iteration, and
    iterations per clock per busy SM (one block of 128 elements per SM at
    most for the tool's small shapes; all SMs for a card-filling one)."""
    n = math.prod(shape)
    x = torch.from_numpy(np.random.default_rng(seed).integers(1, 1000, size=shape, dtype=np.int32)).to(device)
    s = slope(lambda k: mad_loop(x, k), n1, n2, reps)
    busy = min(-(-n // BLOCK), sms)
    per_s = n / (s["ms_per_iter"] / 1e3)  # element-iterations per second
    return {**s, "shape": list(shape), "elements": n, "busy_sms": busy, "ns_per_iter": s["ms_per_iter"] * 1e6,
            "ns_per_elem_iter": s["ms_per_iter"] * 1e6 / n,
            "iters_per_clock_per_sm": per_s / (clock_mhz * 1e6 * busy)}


def fill_shape(sms: int) -> tuple:
    """One element per thread the card can hold: SMs x 2,048."""
    return (sms * 2048,)


def mad_sass() -> list[str]:
    """The SASS of mad_loop_kernel (``cuobjdump -sass`` on the built
    library): its instruction lines."""
    kernels = sass.functions(sass.disassemble(library().path))
    lines = next(v for k, v in kernels.items() if "mad_loop_kernel" in k)
    return [re.sub(r"\s+", " ", line.split(";")[0]).strip() + ";" for line in lines]


def main() -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="the port's microbenchmarks on the card")
    ap.add_argument("--fields", default="vesta,bls12_381")
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("microbench: no CUDA device")
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    clock = float(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.split()[0])
    for field in args.fields.split(","):
        check_chain(field, 128, dev)
        print(json.dumps(measure_chain(field, args.lanes, 1000, 3000, args.reps, dev)))
    for shape in (*MAD_SHAPES, fill_shape(props.multi_processor_count)):
        print(json.dumps(measure_mad(shape, 20000, 60000, args.reps, dev, sms=props.multi_processor_count,
                                     clock_mhz=clock)))


if __name__ == "__main__":
    main()
