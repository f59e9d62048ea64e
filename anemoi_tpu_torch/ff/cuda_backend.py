"""The CUDA kernels on the card, with their plain PyTorch versions.

Counterparts of ``anemoi_tpu/ff/pallas_backend.py``'s three kernels, with
their I/O contract: int32 limb-major tensors (13-bit limbs, Montgomery
``R = 2^(13L)``, canonical), any N, the ragged edge masked in the kernel.

  * ``jive`` (``csrc/jive.cu``, for ``jive_pallas``): fused Jive-k,
    int32 [WIDTH*L, N] -> int32 [(WIDTH/k)*L, N].
  * ``permutation`` (``csrc/sponge.cu``, for ``permutation_pallas``):
    int32 [WIDTH*L, N] -> int32 [WIDTH*L, N].  Two kernels: up to
    ``permute_group_max`` states (the library's crossover, measured on the
    card) ``permute_group_kernel``, four lanes per state (4N threads), as
    the sponge; above it ``permute_kernel``, one thread per state.
  * ``sponge`` (``csrc/sponge.cu``, for ``sponge_pallas``): the fused
    fixed-length sponge over messages of E >= rate elements,
    int32 [E*L, N] -> int32 [DIGEST*L, N].  Its kernel runs four lanes
    per message (4N threads): each lane holds a quarter of every state
    word, and the group does the field arithmetic together through warp
    shuffles (``csrc/field32_group.cuh``).  The Jive kernel runs one thread
    per state; its x^(1/alpha) is a 4-bit sliding window whose table lives
    in shared memory, as in the one-thread permutation kernel.

Each wrapper launches its kernel for a tensor on the card, and runs its
plain version (``*_plain``: the layers of ``permutation/batched.py`` over
``limb_ops``) for a tensor on the CPU; it never falls back from one to the
other.  Each counts its launches in ``<wrapper>.launches``;
``permutation.group_launches`` counts those of them that went to the
four-lane kernel, as the launcher reports the kernel it picked.  The kernels
cover every field: each source is built once per word count (8 for the
20-limb fields, 12 for the 30-limb ones), and a wrapper launches the
library of its field's ``kernel_words``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..fields.params import InstanceParams, kernel_consts
from ..permutation.batched import permutation_fn
from . import limb_ops as lo

KERNEL_SHAPES = ((2, 2), (4, 2), (4, 4))  # (WIDTH, k) instantiated in jive.cu
KERNEL_WORDS = (8, 12)  # the word counts each source is built for
_MAX_ROUND_COLUMNS = 28  # rounds * columns of the largest instance


def consts_len(words: int) -> int:
    """uint32 words of ``AnemoiConsts<words>`` (anemoi32.cuh): 507 or 759."""
    return words + 1 + 6 * words + 2 + 2 * _MAX_ROUND_COLUMNS * words


def resolve_device(device=None) -> torch.device:
    """None means the card; without one, only an explicit CPU device is taken."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the plain path")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@lru_cache(maxsize=None)
def consts_words(inst: InstanceParams) -> np.ndarray:
    """The kernels' constant struct (``AnemoiConsts<NW>`` in anemoi32.cuh,
    NW = ``inst.field.kernel_words``) as uint32 words."""
    kc = kernel_consts(inst)
    nw = inst.field.kernel_words
    rc = lambda t: np.concatenate(
        [t.reshape(-1), np.zeros((_MAX_ROUND_COLUMNS - inst.rounds * inst.columns) * nw, np.uint32)]
    )
    return np.concatenate([
        kc.p, [kc.n0], kc.c_in, kc.c_out, kc.one, kc.beta, kc.delta, kc.inv_alpha,
        [kc.inv_alpha_bits, inst.rounds], rc(kc.C), rc(kc.D),
    ]).astype(np.uint32)


@lru_cache(maxsize=None)
def _plain_permute(inst: InstanceParams):
    return permutation_fn(inst)


def _check(inst: InstanceParams, x, rows: int) -> bool:
    """Validates an int32 [rows, N] input; True when it goes to a kernel."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"expected an int32 tensor [{rows}, N], got {getattr(x, 'dtype', type(x))} "
                         f"{tuple(getattr(x, 'shape', ()))}")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the input must be contiguous")
    return True


def _launch(lib: ctypes.CDLL, name: str, x: torch.Tensor, out: torch.Tensor, *args) -> None:
    """Calls a launcher of the C interface on x's device and current stream."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, name)(x.data_ptr(), out.data_ptr(), x.shape[1], *args, x.device.index, stream)
    if err:
        raise RuntimeError(f"kernel launch failed: {name}: {lib.anemoi_error_string(err).decode()}")


# --------------------------------------------------------------------------
# Jive-k
# --------------------------------------------------------------------------


def jive_plain(inst: InstanceParams, k: int, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the Jive kernel, on any device."""
    W, L = inst.width, inst.field.n_limbs
    fc = lo.field_consts(inst.field)
    c = W // k
    states = x.reshape(W, L, x.shape[1])
    post = _plain_permute(inst)(states)
    outs = []
    for i in range(c):
        acc = lo.add_mod(states[i], post[i], fc)
        for j in range(1, k):
            acc = lo.add_mod(acc, states[i + c * j], fc)
            acc = lo.add_mod(acc, post[i + c * j], fc)
        outs.append(acc)
    return torch.cat(outs, dim=0)


def jive(inst: InstanceParams, k: int, x: torch.Tensor) -> torch.Tensor:
    """Jive-k compression: int32 [WIDTH*L, N] -> int32 [(WIDTH/k)*L, N].

    A CUDA tensor goes to the kernel (or the call raises), a CPU tensor to
    ``jive_plain``.  Inputs must be canonical, as everywhere in the port."""
    W, L = inst.width, inst.field.n_limbs
    if (W, k) not in KERNEL_SHAPES:
        raise ValueError(f"{inst.qualified_name} has no Jive-{k}")
    if not _check(inst, x, W * L):
        return jive_plain(inst, k, x)
    lib = library(inst.field.kernel_words).cdll
    out = torch.empty(((W // k) * L, x.shape[1]), dtype=torch.int32, device=x.device)
    if x.shape[1] == 0:
        return out
    _launch(lib, "anemoi_jive", x, out, W, k, consts_words(inst).ctypes.data)
    jive.launches += 1
    return out


jive.launches = 0


# --------------------------------------------------------------------------
# the bare permutation
# --------------------------------------------------------------------------


def permutation_plain(inst: InstanceParams, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the permutation kernel, on any device."""
    W, L = inst.width, inst.field.n_limbs
    return _plain_permute(inst)(x.reshape(W, L, x.shape[1])).reshape(W * L, x.shape[1])


def permutation(inst: InstanceParams, x: torch.Tensor) -> torch.Tensor:
    """The Anemoi permutation of every state: int32 [WIDTH*L, N] -> int32
    [WIDTH*L, N].  A CUDA tensor goes to a kernel (or the call raises): the
    four-lane kernel up to ``permute_group_max`` states, the one-thread
    kernel above; a CPU tensor goes to ``permutation_plain``."""
    W, L = inst.width, inst.field.n_limbs
    if not _check(inst, x, W * L):
        return permutation_plain(inst, x)
    if x.shape[1] == 0:
        return torch.empty_like(x)
    out, group = _permute(inst, x, -1)
    permutation.launches += 1
    permutation.group_launches += group
    return out


permutation.launches = 0
permutation.group_launches = 0


def permute_group_max(words: int) -> int:
    """The most states for which ``permutation`` launches the four-lane
    kernel: ``PERMUTE_GROUP_MAX`` of the `words`-word library."""
    return sponge_library(words).cdll.anemoi_permute_group_max()


def permutation_with(inst: InstanceParams, x: torch.Tensor, group: bool) -> torch.Tensor:
    """The permutation of CUDA states by the named kernel, the four-lane one
    (``group``) or the one-thread one, whatever N: for timing the two
    against each other and holding each against the plain version.  Not a
    path of the port, so not counted in ``permutation.launches``."""
    W, L = inst.width, inst.field.n_limbs
    if not _check(inst, x, W * L):
        raise ValueError("permutation_with takes a CUDA tensor")
    return _permute(inst, x, int(group))[0] if x.shape[1] else torch.empty_like(x)


def _permute(inst: InstanceParams, x: torch.Tensor, kernel: int) -> tuple[torch.Tensor, bool]:
    """Launches ``anemoi_permute`` on CUDA states: `kernel` -1 lets the
    launcher pick by N, 1 and 0 name the four-lane and the one-thread
    kernel.  Returns the output and whether the four-lane kernel ran, as
    the launcher reports it."""
    out = torch.empty_like(x)
    launched = ctypes.c_int(-1)
    _launch(sponge_library(inst.field.kernel_words).cdll, "anemoi_permute", x, out, inst.width, kernel,
            consts_words(inst).ctypes.data, ctypes.pointer(launched))
    return out, launched.value == 1


# --------------------------------------------------------------------------
# the fused fixed-length sponge
# --------------------------------------------------------------------------


def sponge_plain(inst: InstanceParams, num_elements: int, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the sponge kernel, on any device: the
    scan composition of ``anemoi_tpu/modes/batched.py`` (rate-block adds and
    one permutation per block, then the tail and sigma)."""
    W, L, rate, ds = inst.width, inst.field.n_limbs, inst.rate, inst.digest_size
    fc = lo.field_consts(inst.field)
    permute = _plain_permute(inst)
    elems = x.reshape(num_elements, L, x.shape[1])
    state = [torch.zeros((L, elems.shape[-1]), dtype=x.dtype, device=x.device) for _ in range(W)]
    full, tail = divmod(num_elements, rate)
    for b in range(full):
        for i in range(rate):
            state[i] = lo.add_mod(state[i], elems[b * rate + i], fc)
        state = list(permute(torch.stack(state)).unbind(0))
    for i in range(tail):
        state[i] = lo.add_mod(state[i], elems[full * rate + i], fc)
    if tail:
        state[tail] = lo.add_const(state[tail], fc.one_mont, fc)
        state = list(permute(torch.stack(state)).unbind(0))
    else:
        state[-1] = lo.add_const(state[-1], fc.one_mont, fc)
    return torch.cat(state[:ds], dim=0)


def sponge(inst: InstanceParams, num_elements: int, x: torch.Tensor) -> torch.Tensor:
    """The sponge over N messages of E = num_elements >= rate elements:
    int32 [E*L, N] Montgomery limbs -> int32 [DIGEST*L, N].  A CUDA tensor
    goes to the kernel (or the call raises), a CPU tensor to ``sponge_plain``."""
    L, rate, ds = inst.field.n_limbs, inst.rate, inst.digest_size
    if num_elements < rate:
        raise ValueError(f"the fused sponge takes E >= rate = {rate} elements, got {num_elements}")
    if not _check(inst, x, num_elements * L):
        return sponge_plain(inst, num_elements, x)
    lib = sponge_library(inst.field.kernel_words).cdll
    out = torch.empty((ds * L, x.shape[1]), dtype=torch.int32, device=x.device)
    if x.shape[1] == 0:
        return out
    _launch(lib, "anemoi_sponge", x, out, inst.width, num_elements, consts_words(inst).ctypes.data)
    sponge.launches += 1
    return out


sponge.launches = 0


def launch_counts() -> dict:
    """The wrappers' launch counts now: "jive", "permutation" (both
    permutation kernels), "four_lane" (those of them that went to the
    four-lane kernel) and "sponge"."""
    return {"jive": jive.launches, "permutation": permutation.launches, "four_lane": permutation.group_launches,
            "sponge": sponge.launches}


# --------------------------------------------------------------------------
# the libraries
# --------------------------------------------------------------------------


def declare(lib: ctypes.CDLL, launchers: dict) -> None:
    """Declares the C launchers f(in, out, n, *args, device, stream) -> int
    and anemoi_error_string."""
    for name, args in launchers.items():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, *args,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.anemoi_error_string.argtypes = [ctypes.c_int]
    lib.anemoi_error_string.restype = ctypes.c_char_p


def _declare(fn, argtypes: list, restype) -> None:
    fn.argtypes, fn.restype = argtypes, restype


def _load(source: str, words: int, launchers: dict, consts_fn: str, defines: tuple) -> _build.Library:
    """csrc/<source> built for `words` (-DANEMOI_WORDS) and any further
    `defines`, its C interface declared and its constants' layout checked
    against ``consts_words``."""
    if words not in KERNEL_WORDS:
        raise ValueError(f"the kernels are built for {KERNEL_WORDS} words, not {words}")
    built = _build.load(source, defines=(f"-DANEMOI_WORDS={words}", *defines))
    lib = built.cdll
    declare(lib, launchers)
    layout = getattr(lib, consts_fn)
    _declare(layout, [], ctypes.c_int)
    if layout() != consts_len(words):
        raise RuntimeError(f"AnemoiConsts<{words}> in {source} and consts_words() disagree on the layout")
    return built


@lru_cache(maxsize=None)
def library(words: int, defines: tuple = ()) -> _build.Library:
    """jive.cu for `words`-word fields, built at first use; `defines` (-D
    flags) only for measuring variants of the source's constants."""
    built = _load("jive.cu", words, {"anemoi_jive": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]},
                  "anemoi_jive_consts_words", defines)
    _declare(built.cdll.anemoi_jive_blocks_per_sm, [ctypes.c_int, ctypes.c_int], ctypes.c_int)
    return built


@lru_cache(maxsize=None)
def sponge_library(words: int, defines: tuple = ()) -> _build.Library:
    """sponge.cu for `words`-word fields, built at first use; `defines` as
    ``library``'s."""
    built = _load(
        "sponge.cu",
        words,
        {
            "anemoi_permute": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
            "anemoi_sponge": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        },
        "anemoi_sponge_consts_words",
        defines,
    )
    _declare(built.cdll.anemoi_permute_group_max, [], ctypes.c_longlong)
    _declare(built.cdll.anemoi_sponge_blocks_per_sm, [ctypes.c_int, ctypes.c_int], ctypes.c_int)
    return built
