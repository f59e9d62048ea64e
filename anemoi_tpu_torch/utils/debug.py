"""Range checks of the limb representation, for tests and debug runs.

Counterpart of ``anemoi_tpu/utils/debug.py``: ``check_limbs`` asserts the
invariants every limb tensor of the port keeps, on a tensor on either
device or an array; ``maybe_check`` does so only when the environment sets
``ANEMOI_DEBUG``.  The value check runs over whole arrays in numpy, so it
takes 2^20 columns in well under a second.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..fields.params import LIMB_BITS, LIMB_MASK, FieldParams, limbs_from_int

DEBUG = bool(os.environ.get("ANEMOI_DEBUG"))


def _below(digits: np.ndarray, bound: int, fp: FieldParams) -> np.ndarray:
    """Whether each column of int64 [L, N] non-negative digits is below
    `bound`: the digits are carried into 13 bits, then compared with the
    bound's limbs from the top one down."""
    L = fp.n_limbs
    norm = np.empty_like(digits)
    carry = np.zeros(digits.shape[1], dtype=np.int64)
    for i in range(L):
        v = digits[i] + carry
        norm[i], carry = v & LIMB_MASK, v >> LIMB_BITS
    b = limbs_from_int(bound, L)
    less = np.zeros(digits.shape[1], dtype=bool)
    equal = np.ones(digits.shape[1], dtype=bool)
    for i in range(L - 1, -1, -1):
        less |= equal & (norm[i] < b[i])
        equal &= norm[i] == b[i]
    return less & (carry == 0)


def check_limbs(arr, fp: FieldParams, *, lazy: bool = False, relaxed: bool = False, what: str = "value") -> None:
    """Raises AssertionError unless `arr` (int32 [L, N], or [K, L, B] with
    the limbs on the middle axis; a tensor on any device, or an array) has
    13-bit digits (``relaxed``: up to 2^13 + 2^5, a lazy carry sweep's
    residue) and values below p (``lazy``: below 2p)."""
    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if a.dtype != np.int32:
        raise AssertionError(f"{what}: dtype {a.dtype}")
    if a.size == 0:
        return
    digit_max = LIMB_MASK + (1 << 5) if relaxed else LIMB_MASK
    if a.min() < 0 or a.max() > digit_max:
        raise AssertionError(f"{what}: digit out of range [{a.min()}, {a.max()}]")
    if a.ndim == 3:
        a = a.transpose(1, 0, 2)
    flat = a.reshape(fp.n_limbs, -1).astype(np.int64)
    bound = 2 * fp.p if lazy else fp.p
    bad = int((~_below(flat, bound, fp)).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} values exceed {'2p' if lazy else 'p'}")


def maybe_check(arr, fp: FieldParams, **kw) -> None:
    """``check_limbs`` when ``ANEMOI_DEBUG`` is set, else nothing."""
    if DEBUG:
        check_limbs(arr, fp, **kw)
