"""ctypes binding of the native host library's byte packer.

Counterpart of ``anemoi_tpu/ff/native.py:pack_bytes``: message bytes ->
13-bit limb rows, chunked and padded exactly like the reference's byte
absorb path.  It binds the same source, ``native/anemoi_host.cpp``, which
stays as it is; the port builds its own copy with g++ into
``build/anemoi_tpu_torch/`` (``_build.load_host``), keyed by a hash of the
source, and never writes into ``native/``.
"""

from __future__ import annotations

import ctypes as ct
from functools import lru_cache

import numpy as np

from .. import _build
from ..fields.params import FieldParams

SOURCE = _build.ROOT / "native" / "anemoi_host.cpp"


@lru_cache(maxsize=1)
def library() -> ct.CDLL:
    lib = _build.load_host(SOURCE).cdll
    lib.anemoi_num_elements.argtypes = [ct.c_size_t, ct.c_int]
    lib.anemoi_num_elements.restype = ct.c_size_t
    lib.anemoi_pack_bytes.argtypes = [ct.c_void_p, ct.c_size_t, ct.c_int, ct.c_int, ct.c_void_p]
    lib.anemoi_pack_bytes.restype = None
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
