"""Fused batched Jive-k on the card: the CUDA kernel ``csrc/jive.cu``.

Counterpart of ``anemoi_tpu/ff/pallas_backend.py:jive_pallas``, with its
I/O contract: int32 [WIDTH*L, N] Montgomery limb states (13-bit limbs,
``R = 2^(13L)``, limb-major) in, canonical int32 [(WIDTH/k)*L, N] out.
Any N is taken; the kernel masks the ragged edge itself.

``jive`` launches the kernel for a tensor on the card, and runs the plain
version (``jive_plain``: the permutation of ``permutation/batched.py`` and
the feed-forward sum over ``limb_ops``) for a tensor on the CPU.  The
kernel covers the 20-limb fields; the 30-limb fields are not ported yet.
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
_MAX_ROUND_COLUMNS = 28  # rounds * columns of the largest 20-limb instance
_CONSTS_WORDS = 8 + 1 + 5 * 8 + 2 + 2 * _MAX_ROUND_COLUMNS * 8


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
    """The kernel's constant struct (``JiveConsts`` in jive.cu) as uint32 words."""
    kc = kernel_consts(inst)
    rc = lambda t: np.concatenate(
        [t.reshape(-1), np.zeros((_MAX_ROUND_COLUMNS - inst.rounds * inst.columns) * 8, np.uint32)]
    )
    return np.concatenate([
        kc.p, [kc.n0], kc.c_in, kc.c_out, kc.beta, kc.delta, kc.inv_alpha,
        [kc.inv_alpha_bits, inst.rounds], rc(kc.C), rc(kc.D),
    ]).astype(np.uint32)


def jive_plain(inst: InstanceParams, k: int, x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device."""
    W, L = inst.width, inst.field.n_limbs
    fc = lo.field_consts(inst.field)
    c = W // k
    states = x.reshape(W, L, -1)
    post = permutation_fn(inst)(states)
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
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != W * L:
        raise ValueError(f"expected an int32 tensor [{W * L}, N], got {getattr(x, 'dtype', type(x))} "
                         f"{tuple(getattr(x, 'shape', ()))}")
    if x.device.type == "cpu":
        return jive_plain(inst, k, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not inst.field.has_kernel_form:
        raise NotImplementedError(f"{inst.field.name}: the kernel covers the 20-limb fields only")
    if not x.is_contiguous():
        raise ValueError("the input must be contiguous")
    n = x.shape[1]
    if n == 0:
        return torch.empty(((W // k) * L, 0), dtype=torch.int32, device=x.device)
    lib = library().cdll
    out = torch.empty(((W // k) * L, n), dtype=torch.int32, device=x.device)
    words = consts_words(inst)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.anemoi_jive(x.data_ptr(), out.data_ptr(), n, W, k, words.ctypes.data, x.device.index, stream)
    if err:
        raise RuntimeError(f"jive kernel launch failed: {lib.anemoi_error_string(err).decode()}")
    jive.launches += 1
    return out


jive.launches = 0


@lru_cache(maxsize=None)
def library() -> _build.Library:
    """jive.cu, built at first use, with its C interface declared."""
    built = _build.load("jive.cu")
    lib = built.cdll
    lib.anemoi_jive.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.anemoi_jive.restype = ctypes.c_int
    lib.anemoi_error_string.argtypes = [ctypes.c_int]
    lib.anemoi_error_string.restype = ctypes.c_char_p
    lib.anemoi_jive_consts_words.argtypes = []
    lib.anemoi_jive_consts_words.restype = ctypes.c_int
    if lib.anemoi_jive_consts_words() != _CONSTS_WORDS:
        raise RuntimeError("JiveConsts in jive.cu and consts_words() disagree on the layout")
    return built
