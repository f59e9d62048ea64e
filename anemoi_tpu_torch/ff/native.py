"""ctypes binding of the native host library: the byte packer and the oracle.

Counterpart of ``anemoi_tpu/ff/native.py``:

  * ``pack_bytes``: message bytes -> 13-bit limb rows, chunked and padded
    exactly like the reference's byte absorb path;
  * ``permute_batch_canonical`` / ``jive_batch_canonical``: a 64-bit-word
    Montgomery permutation on the host's CPU (one core), independent of
    the port's limb arithmetic and kernels, to check device batches at
    rates the golden model over Python ints cannot reach.

It binds the same source, ``native/anemoi_host.cpp``, which stays as it
is; the port builds its own copy with g++ into ``build/anemoi_tpu_torch/``
(``_build.load_host``), keyed by a hash of the source, and never writes
into ``native/``.  Limbs move between the 13-bit form and 64-bit words
in numpy over whole arrays, never one ``ctypes`` call a row.
"""

from __future__ import annotations

import ctypes as ct
from functools import lru_cache

import numpy as np

from .. import _build
from ..fields.params import LIMB_BITS, LIMB_MASK, FieldParams, InstanceParams

SOURCE = _build.ROOT / "native" / "anemoi_host.cpp"
MAX_WORDS = 6  # MAX_LIMBS of anemoi_host.cpp: up to 384-bit fields
MAX_WIDTH = 4


class _FieldCtx(ct.Structure):
    """``FieldCtx`` of anemoi_host.cpp."""

    _fields_ = [
        ("n64", ct.c_int32),
        ("p", ct.c_uint64 * MAX_WORDS),
        ("n0inv", ct.c_uint64),
        ("r2", ct.c_uint64 * MAX_WORDS),
        ("one_mont", ct.c_uint64 * MAX_WORDS),
    ]


class _InstanceCtx(ct.Structure):
    """``InstanceCtx`` of anemoi_host.cpp; its pointers are into numpy
    arrays that ``_Instance`` keeps alive."""

    _fields_ = [
        ("width", ct.c_int32),
        ("columns", ct.c_int32),
        ("rounds", ct.c_int32),
        ("inv_alpha_bits", ct.c_int32),
        ("inv_alpha", ct.c_void_p),
        ("C", ct.c_void_p),
        ("D", ct.c_void_p),
        ("beta_mont", ct.c_void_p),
        ("delta_mont", ct.c_void_p),
    ]


@lru_cache(maxsize=1)
def library() -> ct.CDLL:
    lib = _build.load_host(SOURCE).cdll
    lib.anemoi_num_elements.argtypes = [ct.c_size_t, ct.c_int]
    lib.anemoi_num_elements.restype = ct.c_size_t
    lib.anemoi_pack_bytes.argtypes = [ct.c_void_p, ct.c_size_t, ct.c_int, ct.c_int, ct.c_void_p]
    lib.anemoi_pack_bytes.restype = None
    ctx = [ct.POINTER(_FieldCtx), ct.POINTER(_InstanceCtx)]
    for name, args in (
        ("anemoi_to_mont", [ct.POINTER(_FieldCtx), ct.c_void_p, ct.c_size_t]),
        ("anemoi_from_mont", [ct.POINTER(_FieldCtx), ct.c_void_p, ct.c_size_t]),
        ("anemoi_permute_batch", [*ctx, ct.c_void_p, ct.c_size_t]),
        ("anemoi_jive_batch", [*ctx, ct.c_void_p, ct.c_void_p, ct.c_size_t, ct.c_int]),
    ):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = None
    return lib


def num_elements(n_bytes: int, fp: FieldParams) -> int:
    """Elements a message of n_bytes absorbs to: ceil(n_bytes / byte_chunk)."""
    return int(library().anemoi_num_elements(n_bytes, fp.byte_chunk))


def pack_bytes(data: bytes, fp: FieldParams) -> np.ndarray:
    """Message bytes -> int32 [E, L] canonical (non-Montgomery) 13-bit limbs,
    chunked and padded per the reference sponge byte path."""
    data = bytes(data)
    n = num_elements(len(data), fp)
    out = np.zeros((n, fp.n_limbs), dtype=np.int32)
    if n:
        buf = np.frombuffer(data, dtype=np.uint8)
        library().anemoi_pack_bytes(buf.ctypes.data, len(data), fp.byte_chunk, fp.n_limbs, out.ctypes.data)
    return out


# --------------------------------------------------------------------------
# the oracle: 64-bit Montgomery words on the host
# --------------------------------------------------------------------------


def words64(fp: FieldParams) -> int:
    """64-bit words of an element: 4 up to 256 bits, 6 up to 384."""
    return -(-fp.bits // 64)


def _u64(x: int, n64: int) -> list[int]:
    if x >> (64 * n64):
        raise ValueError("value does not fit in the given word count")
    return [(x >> (64 * i)) & (2**64 - 1) for i in range(n64)]


@lru_cache(maxsize=None)
def _field_ctx(fp: FieldParams) -> _FieldCtx:
    n64 = words64(fp)
    R = pow(2, 64 * n64, fp.p)
    ctx = _FieldCtx()
    ctx.n64 = n64
    ctx.p[:n64] = _u64(fp.p, n64)
    ctx.r2[:n64] = _u64(R * R % fp.p, n64)
    ctx.one_mont[:n64] = _u64(R, n64)
    ctx.n0inv = (-pow(fp.p, -1, 1 << 64)) % (1 << 64)
    return ctx


class _Instance:
    """An instance's constants as the oracle takes them (64-bit Montgomery
    words, the exponent's bits most significant first), and the context
    that points at them."""

    def __init__(self, inst: InstanceParams):
        fp = inst.field
        if inst.width > MAX_WIDTH:
            raise ValueError(f"the oracle takes states of up to {MAX_WIDTH} elements")
        n64 = words64(fp)
        R = pow(2, 64 * n64, fp.p)
        mont = lambda vals: np.array([w for v in vals for w in _u64(v % fp.p * R % fp.p, n64)], dtype=np.uint64)
        self.C, self.D = mont(inst.C), mont(inst.D)
        self.beta, self.delta = mont([fp.beta]), mont([fp.delta])
        self.bits = np.array([int(b) for b in bin(fp.inv_alpha)[2:]], dtype=np.uint8)
        self.ctx = _InstanceCtx(inst.width, inst.columns, inst.rounds, len(self.bits), self.bits.ctypes.data,
                                self.C.ctypes.data, self.D.ctypes.data, self.beta.ctypes.data,
                                self.delta.ctypes.data)


@lru_cache(maxsize=None)
def _instance(inst: InstanceParams) -> _Instance:
    return _Instance(inst)


def limbs_to_words(limbs: np.ndarray, fp: FieldParams) -> np.ndarray:
    """int32 [..., L] 13-bit limbs -> uint64 [..., n64] words, little-endian
    (``anemoi_limbs13_to_64``, over whole arrays): bits past the last word
    are dropped, as the C code drops them."""
    limbs = np.asarray(limbs)
    if limbs.shape[-1] != fp.n_limbs:
        raise ValueError(f"expected {fp.n_limbs} limbs on the last axis, got {limbs.shape}")
    if limbs.size and (limbs.min() < 0 or limbs.max() > LIMB_MASK):
        raise ValueError("limbs must lie in [0, 2^13)")
    n64 = words64(fp)
    v = limbs.astype(np.uint64)
    out = np.zeros((*limbs.shape[:-1], n64), dtype=np.uint64)
    for i in range(fp.n_limbs):
        w, s = divmod(LIMB_BITS * i, 64)
        if w < n64:
            out[..., w] |= v[..., i] << np.uint64(s)
        if s > 64 - LIMB_BITS and w + 1 < n64:
            out[..., w + 1] |= v[..., i] >> np.uint64(64 - s)
    return out


def words_to_limbs(words: np.ndarray, fp: FieldParams) -> np.ndarray:
    """uint64 [..., n64] words -> int32 [..., L] 13-bit limbs
    (``anemoi_limbs64_to_13``, over whole arrays)."""
    words = np.asarray(words, dtype=np.uint64)
    n64 = words64(fp)
    if words.shape[-1] != n64:
        raise ValueError(f"expected {n64} words on the last axis, got {words.shape}")
    out = np.zeros((*words.shape[:-1], fp.n_limbs), dtype=np.int32)
    for i in range(fp.n_limbs):
        w, s = divmod(LIMB_BITS * i, 64)
        if w >= n64:
            continue
        v = words[..., w] >> np.uint64(s)
        if s > 64 - LIMB_BITS and w + 1 < n64:
            v |= words[..., w + 1] << np.uint64(64 - s)
        out[..., i] = (v & np.uint64(LIMB_MASK)).astype(np.int32)
    return out


def _mont_words(inst: InstanceParams, states13: np.ndarray) -> np.ndarray:
    """Canonical int32 [B, WIDTH, L] -> contiguous uint64 [B, WIDTH, n64]
    in the oracle's Montgomery form."""
    states13 = np.asarray(states13)
    if states13.ndim != 3 or states13.shape[1] != inst.width:
        raise ValueError(f"expected states [B, {inst.width}, {inst.field.n_limbs}], got {states13.shape}")
    st = np.ascontiguousarray(limbs_to_words(states13, inst.field))
    library().anemoi_to_mont(_field_ctx(inst.field), st.ctypes.data, st.size // st.shape[-1])
    return st


def _canonical_limbs(inst: InstanceParams, st: np.ndarray) -> np.ndarray:
    library().anemoi_from_mont(_field_ctx(inst.field), st.ctypes.data, st.size // st.shape[-1])
    return words_to_limbs(st, inst.field)


def permute_batch_canonical(inst: InstanceParams, states13: np.ndarray) -> np.ndarray:
    """The permutation of B canonical states, int32 [B, WIDTH, L] 13-bit
    limbs -> the same shape, on the host's CPU."""
    st = _mont_words(inst, states13)
    library().anemoi_permute_batch(_field_ctx(inst.field), _instance(inst).ctx, st.ctypes.data, st.shape[0])
    return _canonical_limbs(inst, st)


def jive_batch_canonical(inst: InstanceParams, states13: np.ndarray, k: int = 2) -> np.ndarray:
    """Jive-k of B canonical states, int32 [B, WIDTH, L] -> [B, WIDTH/k, L],
    on the host's CPU."""
    if inst.width % k or k % 2:
        raise ValueError(f"{inst.qualified_name} has no Jive-{k}")
    st = _mont_words(inst, states13)
    out = np.zeros((st.shape[0], inst.width // k, st.shape[-1]), dtype=np.uint64)
    library().anemoi_jive_batch(_field_ctx(inst.field), _instance(inst).ctx, st.ctypes.data, out.ctypes.data,
                                st.shape[0], k)
    return _canonical_limbs(inst, out)
