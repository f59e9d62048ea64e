"""The CUDA kernels on the card, with their plain PyTorch versions.

Counterparts of ``anemoi_tpu/ff/pallas_backend.py``'s three kernels, with
their I/O contract: int32 limb-major tensors (13-bit limbs, Montgomery
``R = 2^(13L)``, canonical), any N, the ragged edge masked in the kernel.

  * ``jive`` (``csrc/jive.cu``, for ``jive_pallas``): fused Jive-k,
    int32 [WIDTH*L, N] -> int32 [(WIDTH/k)*L, N].  For a field whose
    modulus has the Pasta primes' shape (Vesta, Pallas) the launcher picks
    ``jive_pasta_kernel``, whose Montgomery reduction is compiled for that
    shape, and ``jive_kernel`` for the others.  With a ``mul_impl``
    that starts with "mxu" (the JAX package's default product, on its matrix
    unit) it launches ``csrc/jive_mma.cu`` instead: one state a thread, as
    ``jive.cu``, with each Montgomery product's reduction on the tensor
    cores (``ff/mxu_ops.py``) for the warp's 32 states.
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
  * With an "mxu" ``mul_impl``, ``permutation`` and ``sponge`` launch
    ``csrc/sponge_mma.cu`` instead, the reduction on the tensor cores: the
    sponge ``sponge_mma_kernel``, and the permutation up to
    ``permute_mma_group_max`` states (the library's crossover, measured on
    the card) ``permute_mma_kernel``, both one state or message a quad of
    four lanes (8 a warp, each word-sliced as in the sponge); above it
    ``permute_mma_thread_kernel``, one state a thread as in the Jive.
  * ``unpack`` (``csrc/unpack.cu``; the JAX package packs bytes on the
    host): byte messages of one element count, joined into one buffer,
    -> int32 [E, L, B] Montgomery limbs, the sponge's input; one thread an
    (element, message).

Each wrapper launches its kernel for a tensor on the card, and runs its
plain version (``*_plain``: the layers of ``permutation/batched.py`` over
``limb_ops``) for a tensor on the CPU; it never falls back from one to the
other.  Each counts its launches in ``<wrapper>.launches``;
``jive.pasta_launches`` counts those of ``jive`` that went to
``jive_pasta_kernel`` and ``permutation.group_launches`` those of
``permutation`` that went to the four-lane kernel, as the launchers report
the kernel they picked; the
tensor-core kernels count theirs in ``jive_mma.launches``,
``permutation_mma.launches`` (and in ``permutation_mma.quad_launches``
those that went to the quad form) and ``sponge_mma.launches``; the unpack
kernel in ``unpack.launches``.  The kernels
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
from ..fields.params import LIMB_BITS, LIMB_MASK, InstanceParams, kernel_consts, words_from_int
from ..permutation.batched import permutation_fn
from ..utils import profiling
from . import limb_ops as lo
from .mxu_ops import fragment_regs, fragment_tiles, fragment_words, selects_mma

KERNEL_SHAPES = ((2, 2), (4, 2), (4, 4))  # (WIDTH, k) instantiated in jive.cu
KERNEL_WORDS = (8, 12)  # the word counts each source is built for
_MAX_ROUND_COLUMNS = 28  # rounds * columns of the largest instance
_UNPACK_PLAIN_SLOTS = 1 << 16  # (element, message) pairs unpack_plain takes a pass


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
    """Calls a launcher of the C interface on x's device and current stream,
    inside an ``anemoi.launch`` span (the host's dispatch)."""
    with profiling.span("anemoi.launch"):
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


def jive(inst: InstanceParams, k: int, x: torch.Tensor, mul_impl: str | None = None) -> torch.Tensor:
    """Jive-k compression: int32 [WIDTH*L, N] -> int32 [(WIDTH/k)*L, N].

    A CUDA tensor goes to a kernel (or the call raises): a ``mul_impl``
    name that starts with "mxu" (the JAX package's products on the matrix
    unit) to ``jive_mma_kernel``, whose reduction runs on the tensor cores,
    counted in ``jive_mma.launches``; every other name, and None, to
    ``jive_kernel``, or to ``jive_pasta_kernel`` where the field's modulus
    has the Pasta primes' shape, as the launcher decides from the constants
    and reports (counted in ``jive.pasta_launches`` as well).  A CPU tensor
    goes to ``jive_plain`` whatever the name:
    the function is the same.  Inputs must be canonical, as everywhere in
    the port.  A name the JAX package rejects raises ValueError."""
    lo.check_tuning(mul_impl)
    W, L = inst.width, inst.field.n_limbs
    if (W, k) not in KERNEL_SHAPES:
        raise ValueError(f"{inst.qualified_name} has no Jive-{k}")
    if not _check(inst, x, W * L):
        return jive_plain(inst, k, x)
    mma = selects_mma(mul_impl)
    lib = (mma_library if mma else library)(inst.field.kernel_words).cdll
    out = torch.empty(((W // k) * L, x.shape[1]), dtype=torch.int32, device=x.device)
    if x.shape[1] == 0:
        return out
    if mma:
        jive_mma(lib, inst, k, x, out)
        return out
    pasta = ctypes.c_int(-1)
    _launch(lib, "anemoi_jive", x, out, W, k, consts_words(inst).ctypes.data, ctypes.pointer(pasta))
    jive.launches += 1
    jive.pasta_launches += pasta.value == 1
    return out


jive.launches = 0
jive.pasta_launches = 0


def pasta_shape(inst: InstanceParams) -> bool:
    """Whether ``jive`` sends `inst` to ``jive_pasta_kernel``: the launcher's
    own test of the constants' p and n0 (``anemoi_jive_pasta``; builds
    ``jive.cu``, as a launch does)."""
    return bool(library(inst.field.kernel_words).cdll.anemoi_jive_pasta(consts_words(inst).ctypes.data))


def jive_mma(lib: ctypes.CDLL, inst: InstanceParams, k: int, x: torch.Tensor, out: torch.Tensor) -> None:
    """Launches ``jive_mma_kernel`` of `lib` (``csrc/jive_mma.cu``) on CUDA
    states into `out`; counted in ``jive_mma.launches``."""
    _launch(lib, "anemoi_jive_mma", x, out, inst.width, k, consts_words(inst).ctypes.data,
            fragments(inst.field, x.device).data_ptr())
    jive_mma.launches += 1


jive_mma.launches = 0


@lru_cache(maxsize=None)
def fragments(field, device: torch.device) -> torch.Tensor:
    """The field's constant fragments (``mxu_ops.fragment_words``) on the card."""
    return torch.from_numpy(fragment_words(field).view(np.int32)).to(device)


# --------------------------------------------------------------------------
# the bare permutation
# --------------------------------------------------------------------------


def permutation_plain(inst: InstanceParams, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the permutation kernel, on any device."""
    W, L = inst.width, inst.field.n_limbs
    return _plain_permute(inst)(x.reshape(W, L, x.shape[1])).reshape(W * L, x.shape[1])


def permutation(inst: InstanceParams, x: torch.Tensor, mul_impl: str | None = None) -> torch.Tensor:
    """The Anemoi permutation of every state: int32 [WIDTH*L, N] -> int32
    [WIDTH*L, N].  A CUDA tensor goes to a kernel (or the call raises): a
    ``mul_impl`` name that starts with "mxu" to the tensor-core kernels,
    whose reduction runs on the tensor cores, the quad form up to
    ``permute_mma_group_max`` states and the thread form above, counted in
    ``permutation_mma.launches``; every other name, and None, to the
    four-lane kernel up to ``permute_group_max`` states and the one-thread
    kernel above.  A CPU tensor goes to ``permutation_plain`` whatever the
    name.  A name the JAX package rejects raises ValueError."""
    lo.check_tuning(mul_impl)
    W, L = inst.width, inst.field.n_limbs
    if not _check(inst, x, W * L):
        return permutation_plain(inst, x)
    if x.shape[1] == 0:
        return torch.empty_like(x)
    if selects_mma(mul_impl):
        return permutation_mma(inst, x)
    out, group = _permute(inst, x, -1)
    permutation.launches += 1
    permutation.group_launches += group
    return out


permutation.launches = 0
permutation.group_launches = 0


def permutation_mma(inst: InstanceParams, x: torch.Tensor) -> torch.Tensor:
    """Launches the tensor-core permutation (``csrc/sponge_mma.cu``) on
    CUDA states, the launcher picking the form by N; counted in
    ``permutation_mma.launches`` and, when the launcher reports the quad
    form, in ``permutation_mma.quad_launches``."""
    out, quad = _permute_mma(inst, x, -1)
    permutation_mma.launches += 1
    permutation_mma.quad_launches += quad
    return out


permutation_mma.launches = 0
permutation_mma.quad_launches = 0


def permute_mma_group_max(words: int) -> int:
    """The most states for which ``permutation`` with an "mxu" name launches
    the quad form: ``PERMUTE_MMA_GROUP_MAX`` of the `words`-word library."""
    return sponge_mma_library(words).cdll.anemoi_permute_mma_group_max()


def permutation_mma_with(inst: InstanceParams, x: torch.Tensor, quad: bool) -> torch.Tensor:
    """The permutation of CUDA states by the named form of the tensor-core
    kernels, the quad form (``quad``) or the thread form, whatever N: for
    timing the two against each other and holding each against the plain
    version.  Not a path of the port, so not counted."""
    W, L = inst.width, inst.field.n_limbs
    if not _check(inst, x, W * L):
        raise ValueError("permutation_mma_with takes a CUDA tensor")
    return _permute_mma(inst, x, int(quad))[0] if x.shape[1] else torch.empty_like(x)


def _permute_mma(inst: InstanceParams, x: torch.Tensor, kernel: int) -> tuple[torch.Tensor, bool]:
    """Launches ``anemoi_permute_mma`` (``csrc/sponge_mma.cu``) on CUDA
    states: `kernel` -1 lets the launcher pick the form by N, 1 and 0 name
    the quad and the thread form.  Returns the output and whether the quad
    form ran, as the launcher reports it."""
    out = torch.empty_like(x)
    launched = ctypes.c_int(-1)
    _launch(sponge_mma_library(inst.field.kernel_words).cdll, "anemoi_permute_mma", x, out, inst.width, kernel,
            consts_words(inst).ctypes.data, fragments(inst.field, x.device).data_ptr(), ctypes.pointer(launched))
    return out, launched.value == 1


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


def sponge(inst: InstanceParams, num_elements: int, x: torch.Tensor, mul_impl: str | None = None) -> torch.Tensor:
    """The sponge over N messages of E = num_elements >= rate elements:
    int32 [E*L, N] Montgomery limbs -> int32 [DIGEST*L, N].  A CUDA tensor
    goes to a kernel (or the call raises): a ``mul_impl`` name that starts
    with "mxu" to ``sponge_mma_kernel``, whose reduction runs on the tensor
    cores, counted in ``sponge_mma.launches``; every other name, and None,
    to ``sponge_kernel``.  A CPU tensor goes to ``sponge_plain`` whatever
    the name.  A name the JAX package rejects raises ValueError."""
    lo.check_tuning(mul_impl)
    L, rate, ds = inst.field.n_limbs, inst.rate, inst.digest_size
    if num_elements < rate:
        raise ValueError(f"the fused sponge takes E >= rate = {rate} elements, got {num_elements}")
    if not _check(inst, x, num_elements * L):
        return sponge_plain(inst, num_elements, x)
    mma = selects_mma(mul_impl)
    lib = (sponge_mma_library if mma else sponge_library)(inst.field.kernel_words).cdll
    out = torch.empty((ds * L, x.shape[1]), dtype=torch.int32, device=x.device)
    if x.shape[1] == 0:
        return out
    if mma:
        sponge_mma(lib, inst, num_elements, x, out)
        return out
    _launch(lib, "anemoi_sponge", x, out, inst.width, num_elements, consts_words(inst).ctypes.data)
    sponge.launches += 1
    return out


sponge.launches = 0


def sponge_mma(lib: ctypes.CDLL, inst: InstanceParams, num_elements: int, x: torch.Tensor,
               out: torch.Tensor) -> None:
    """Launches ``sponge_mma_kernel`` of `lib` (``csrc/sponge_mma.cu``) on
    CUDA messages into `out`; counted in ``sponge_mma.launches``."""
    _launch(lib, "anemoi_sponge_mma", x, out, inst.width, num_elements, consts_words(inst).ctypes.data,
            fragments(inst.field, x.device).data_ptr())
    sponge_mma.launches += 1


sponge_mma.launches = 0


# --------------------------------------------------------------------------
# byte messages -> Montgomery limbs
# --------------------------------------------------------------------------


def unpack_plain(inst: InstanceParams, num_elements: int, data: torch.Tensor, spans: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the unpack kernel, on any device: the
    elements' bytes gathered (the pad byte 1 right after a short last
    chunk), sliced into 13-bit limbs, then ``limb_ops.to_mont``; a few
    elements a pass, so a 4,096 x 10 KB bucket needs no GBs of temporaries."""
    fp = inst.field
    E, L, chunk, B = num_elements, fp.n_limbs, fp.byte_chunk, spans.shape[1]
    out = torch.zeros((E, L, B), dtype=torch.int32, device=data.device)
    if E == 0 or B == 0:
        return out
    first = [LIMB_BITS * l // 8 for l in range(L)]  # each limb's bits lie in bytes first .. first + 2
    width = first[-1] + 3
    j = torch.arange(width, device=data.device)
    idx = torch.tensor(first, device=data.device)
    shift = torch.tensor([LIMB_BITS * l % 8 for l in range(L)], device=data.device)
    fc = lo.field_consts(fp)
    step = max(1, _UNPACK_PLAIN_SLOTS // B)  # elements a pass, so the int64 temporaries stay tens of MB
    for e0 in range(0, E, step):
        n = min(step, E - e0)
        pos = torch.arange(e0, e0 + n, device=data.device).reshape(n, 1, 1) * chunk + j  # [n, 1, width]
        rest = spans[1].reshape(1, B, 1) - pos  # [n, B, width]: the message's bytes from each slot on
        inside = (rest > 0) & (j < chunk)
        byte = torch.where(inside, data[torch.where(inside, spans[0].reshape(1, B, 1) + pos, 0)].long(), 0)
        byte = torch.where((rest == 0) & (j < chunk), 1, byte)  # the pad byte
        word = byte[..., idx] | byte[..., idx + 1] << 8 | byte[..., idx + 2] << 16
        limbs = (word >> shift) & LIMB_MASK  # [n, B, L], canonical
        mont = lo.to_mont(limbs.permute(2, 0, 1).reshape(L, n * B), fc)
        out[e0:e0 + n] = mont.reshape(L, n, B).permute(1, 0, 2)
    return out


def unpack(inst: InstanceParams, num_elements: int, data: torch.Tensor, spans: torch.Tensor) -> torch.Tensor:
    """B byte messages of E = num_elements elements each -> their elements,
    int32 [E, L, B] Montgomery limbs, the sponge's input.  ``data`` is uint8
    [nbytes], the messages joined; ``spans`` int64 [2, B], each message's
    offset in ``data`` and its length.  Chunking, padding and limbs as
    ``native.pack_bytes``, then ``limb_ops.to_mont``.  CUDA tensors go to
    ``unpack_kernel`` (``csrc/unpack.cu``), counted in ``unpack.launches``;
    CPU tensors to ``unpack_plain``."""
    if data.dtype != torch.uint8 or data.dim() != 1 or spans.dtype != torch.int64 or spans.dim() != 2 \
            or spans.shape[0] != 2 or spans.device != data.device:
        raise ValueError(f"expected uint8 [nbytes] and int64 [2, B] on one device, got {data.dtype} "
                         f"{tuple(data.shape)} and {spans.dtype} {tuple(spans.shape)}")
    if data.device.type == "cpu":
        return unpack_plain(inst, num_elements, data, spans)
    if not (data.is_contiguous() and spans.is_contiguous()):
        raise ValueError("the inputs must be contiguous")
    fp = inst.field
    out = torch.empty((num_elements, fp.n_limbs, spans.shape[1]), dtype=torch.int32, device=data.device)
    if out.numel() == 0:
        return out
    _launch(unpack_library(fp.kernel_words).cdll, "anemoi_unpack", spans, out, data.data_ptr(), num_elements,
            fp.byte_chunk, fp.n_limbs, unpack_consts(fp).ctypes.data)
    unpack.launches += 1
    return out


unpack.launches = 0


@lru_cache(maxsize=None)
def unpack_consts(fp) -> np.ndarray:
    """``UnpackConsts<NW>`` (csrc/unpack.cu) as uint32 words: p, n0 and
    2^(13L + 32 NW) mod p, by which one Montgomery product takes x to x R."""
    nw = fp.kernel_words
    to_mont = pow(2, LIMB_BITS * fp.n_limbs + fp.kernel_r_bits, fp.p)
    return np.concatenate([words_from_int(fp.p, nw), [fp.kernel_n0], words_from_int(to_mont, nw)]).astype(np.uint32)


def launch_counts() -> dict:
    """The wrappers' launch counts now: "jive" (both integer Jive kernels),
    "jive_pasta" (those of them that went to ``jive_pasta_kernel``),
    "jive_mma" (the tensor-core Jive kernel), "permutation" (both integer
    permutation kernels),
    "four_lane" (those of them that went to the four-lane kernel),
    "sponge", "permutation_mma" (the tensor-core permutation's quad form,
    ``permute_mma_kernel``), "permutation_mma_thread" (its thread form,
    ``permute_mma_thread_kernel``), "sponge_mma" (the tensor-core sponge)
    and "unpack" (bytes to Montgomery limbs)."""
    return {"jive": jive.launches, "jive_pasta": jive.pasta_launches, "jive_mma": jive_mma.launches,
            "permutation": permutation.launches,
            "four_lane": permutation.group_launches, "sponge": sponge.launches,
            "permutation_mma": permutation_mma.quad_launches,
            "permutation_mma_thread": permutation_mma.launches - permutation_mma.quad_launches,
            "sponge_mma": sponge_mma.launches, "unpack": unpack.launches}


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


def _load(source: str, words: int, launchers: dict, consts_fn: str, defines: tuple,
          n_consts: int | None = None) -> _build.Library:
    """csrc/<source> built for `words` (-DANEMOI_WORDS) and any further
    `defines`, its C interface declared and its constants' layout checked:
    ``n_consts`` words, by default ``consts_words``'s."""
    if words not in KERNEL_WORDS:
        raise ValueError(f"the kernels are built for {KERNEL_WORDS} words, not {words}")
    built = _build.load(source, defines=(f"-DANEMOI_WORDS={words}", *defines))
    lib = built.cdll
    declare(lib, launchers)
    layout = getattr(lib, consts_fn)
    _declare(layout, [], ctypes.c_int)
    if layout() != (consts_len(words) if n_consts is None else n_consts):
        raise RuntimeError(f"the constants of {source} at {words} words and the port's disagree on the layout")
    return built


@lru_cache(maxsize=None)
def unpack_library(words: int) -> _build.Library:
    """unpack.cu for `words`-word fields, built at first use."""
    launcher = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return _load("unpack.cu", words, {"anemoi_unpack": launcher}, "anemoi_unpack_consts_words", (), 2 * words + 1)


@lru_cache(maxsize=None)
def library(words: int, defines: tuple = ()) -> _build.Library:
    """jive.cu for `words`-word fields, built at first use; `defines` (-D
    flags) only for measuring variants of the source's constants."""
    launcher = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    built = _load("jive.cu", words, {"anemoi_jive": launcher}, "anemoi_jive_consts_words", defines)
    _declare(built.cdll.anemoi_jive_blocks_per_sm, [ctypes.c_int] * 3, ctypes.c_int)
    _declare(built.cdll.anemoi_jive_pasta, [ctypes.c_void_p], ctypes.c_int)
    return built


@lru_cache(maxsize=None)
def mma_library(words: int, defines: tuple = ()) -> _build.Library:
    """jive_mma.cu for `words`-word fields, built at first use, its
    fragment layout checked against ``mxu_ops``; `defines` as
    ``library``'s."""
    built = _load("jive_mma.cu", words,
                  {"anemoi_jive_mma": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]},
                  "anemoi_jive_mma_consts_words", defines)
    lib = built.cdll
    _declare(lib.anemoi_jive_mma_blocks_per_sm, [ctypes.c_int, ctypes.c_int], ctypes.c_int)
    _declare(lib.anemoi_mma_check, [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int)
    _check_fragments("jive_mma.cu", words, lib.anemoi_jive_mma_frag_words)
    return built


def _check_fragments(source: str, words: int, frag_words) -> None:
    """Raises unless the library's fragment words (``frag_words()``) are
    those ``mxu_ops`` lays out for `words`-word fields."""
    _declare(frag_words, [], ctypes.c_int)
    m_tiles, u_tiles = fragment_tiles(words)
    if frag_words() != (m_tiles + u_tiles) * fragment_regs(words) * 32:
        raise RuntimeError(f"{source} and mxu_ops disagree on the fragments of {words}-word fields")


@lru_cache(maxsize=None)
def sponge_mma_library(words: int, defines: tuple = ()) -> _build.Library:
    """sponge_mma.cu for `words`-word fields, built at first use, its
    fragment layout checked against ``mxu_ops``; `defines` as
    ``library``'s."""
    built = _load(
        "sponge_mma.cu",
        words,
        {
            "anemoi_permute_mma": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int)],
            "anemoi_sponge_mma": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
        },
        "anemoi_sponge_mma_consts_words",
        defines,
    )
    lib = built.cdll
    _declare(lib.anemoi_sponge_mma_blocks_per_sm, [ctypes.c_int, ctypes.c_int], ctypes.c_int)
    _declare(lib.anemoi_sponge_mma_block_threads, [ctypes.c_int], ctypes.c_int)
    _declare(lib.anemoi_permute_mma_group_max, [], ctypes.c_longlong)
    _check_fragments("sponge_mma.cu", words, lib.anemoi_sponge_mma_frag_words)
    return built


def mma_check(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    """One warp's ``mma.sync`` on the card for the 32 lanes' fragment
    registers: a int32 [32, 4] (k = 16: the first 2 of each row), b [32, 2]
    (k = 16: the first); returns d [32, 4].  For holding the fragment
    layouts against the host's definition; not a path of the port."""
    for x, regs in ((a, 4), (b, 2)):
        if (x.dtype != torch.int32 or tuple(x.shape) != (32, regs) or x.device.type != "cuda" or x.device != a.device
                or not x.is_contiguous()):
            raise ValueError(f"expected contiguous int32 [32, {regs}] fragments on one card, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    d = torch.zeros((32, 4), dtype=torch.int32, device=a.device)
    lib = mma_library(8).cdll
    err = lib.anemoi_mma_check(a.data_ptr(), b.data_ptr(), d.data_ptr(), k, a.device.index,
                               torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"kernel launch failed: anemoi_mma_check: {lib.anemoi_error_string(err).decode()}")
    return d


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
