"""Multi-limb Montgomery arithmetic as plain PyTorch: the port's plain path.

Counterpart of ``anemoi_tpu/ff/limb_ops.py`` in the same representation: a
batch of N field elements is an int32 tensor of shape [L, N], limb-major,
little-endian 13-bit limbs, Montgomery form with ``R = 2^(13L)``, canonical
(below p) between operations.

This is the plain version of the CUDA kernels (``cuda_backend.py``): the
CPU tests run it against the JAX package, and ``chip_smoke.py`` holds the
kernels against it on the card.  It is written for few tensor calls,
not for speed: every operation works on all limbs and lanes at once.

  * A product is an int64 outer product [L, L, N] summed onto its
    anti-diagonals in one reduction (``_product``).
  * Montgomery reduction is the parallel form: ``M = (T mod R) * p' mod R``,
    then ``(T + M*p) / R``, which lies in [0, 3p), then a choice among
    r, r - p and r - 2p.
  * Carries move by a fixed number of shift / mask / add rounds over all
    limbs at once, then one carry-lookahead step; a subtraction is an
    addition of a complement, so no digit is ever negative.  Nothing waits
    on the device, so on the card the cost is the number of launches.

Internally values travel as int64 digits; each public function returns
the dtype it was given.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..fields.params import (
    LIMB_BITS,
    LIMB_MASK,
    FieldParams,
    inv_alpha_chain,
    limbs_from_int,
)


class FieldConsts:
    """Limb-form constants of one field (numpy int32[L]), with a cache of
    their tensor copies per device."""

    def __init__(self, fp: FieldParams, *, p, one_mont, r2, beta_mont, delta_mont):
        self.field = fp
        self.n_limbs = L = fp.n_limbs
        self.p_limbs = np.asarray(p, dtype=np.int32)
        self.one_mont = np.asarray(one_mont, dtype=np.int32)
        self.r2_limbs = np.asarray(r2, dtype=np.int32)
        self.beta_mont = np.asarray(beta_mont, dtype=np.int32)
        self.delta_mont = np.asarray(delta_mont, dtype=np.int32)
        R = 1 << (LIMB_BITS * L)
        self.pprime_limbs = limbs_from_int(-pow(fp.p, -1, R) % R, L)
        self.chain = inv_alpha_chain(fp.name)
        self._on: dict = {}

    def arrays(self) -> dict:
        return {
            "p": self.p_limbs,
            "one_mont": self.one_mont,
            "r2": self.r2_limbs,
            "beta_mont": self.beta_mont,
            "delta_mont": self.delta_mont,
        }

    def on(self, device) -> SimpleNamespace:
        """The constants as int64 [L, 1] columns on `device`."""
        device = torch.device(device)
        if device not in self._on:
            L, p = self.n_limbs, self.field.p
            R = 1 << (LIMB_BITS * L)
            col = lambda v: torch.as_tensor(np.asarray(v, dtype=np.int64).reshape(-1, L, 1), device=device)
            self._on[device] = SimpleNamespace(
                p=col(self.p_limbs)[0],
                pprime=col(self.pprime_limbs)[0],
                beta=col(self.beta_mont)[0],
                delta=col(self.delta_mont)[0],
                r2=col(self.r2_limbs)[0],
                unit=col(limbs_from_int(1, L))[0],
                # r + (R - j*p) carries out of the top limb iff r >= j*p
                reduce=col([limbs_from_int(R - j * p if j else 0, L) for j in range(3)]),
                sub=col([limbs_from_int(j * p, L) for j in range(2)]),
                rows=torch.arange(L, device=device).reshape(L, 1),
            )
        return self._on[device]


_FIELD_CONSTS: dict = {}


def field_consts(fp: FieldParams) -> FieldConsts:
    """The port's own derivation of the limb constants, from its JSON copy."""
    if fp.name not in _FIELD_CONSTS:
        L = fp.n_limbs
        _FIELD_CONSTS[fp.name] = FieldConsts(
            fp,
            p=fp.p_limbs,
            one_mont=limbs_from_int(fp.R, L),
            r2=limbs_from_int(fp.R2, L),
            beta_mont=limbs_from_int(fp.to_mont(fp.beta), L),
            delta_mont=limbs_from_int(fp.to_mont(fp.delta), L),
        )
    return _FIELD_CONSTS[fp.name]


# --------------------------------------------------------------------------
# carries: every function below works on int64 digits [..., K, N] with the
# limb axis second to last, and knows a bound 2^bits on its digits, so the
# number of carry rounds is fixed and nothing waits on the device
# --------------------------------------------------------------------------


def _carry_round(x):
    """Move each digit's bits above 13 one limb up; returns the new digits
    and what left the top limb."""
    c = x >> LIMB_BITS
    x = x & LIMB_MASK
    x[..., 1:, :] += c[..., :-1, :]
    return x, c[..., -1, :]


def _relax(x, bits: int):
    """Carry rounds until every digit is at most 2^13, from non-negative
    digits below 2^bits; returns (digits, carry out of the top limb)."""
    carry = 0
    while True:
        x, c = _carry_round(x)
        carry = carry + c
        if bits <= LIMB_BITS + 1:
            return x, carry
        bits = max(bits - LIMB_BITS, LIMB_BITS) + 1


def _normalize(x, bits: int, rows):
    """Non-negative digits below 2^bits -> (13-bit digits, carry out).

    After the carry rounds each digit is at most 2^13, so what is left are
    carries of one that ripple through runs of 8191.  Carry lookahead: the
    carry out of limb i is set iff the last limb at or below i that is not
    8191 holds 2^13."""
    x, carry = _relax(x, bits)
    stop = x != LIMB_MASK
    last = torch.where(stop, rows, -1).cummax(dim=-2).values
    out = torch.where(last >= 0, torch.gather(x >> LIMB_BITS, -2, last.clamp(min=0)), 0)
    x[..., 1:, :] += out[..., :-1, :]
    return x & LIMB_MASK, carry + out[..., -1, :]


def _select_reduce(r, d, k: int, bits: int):
    """r < k*p (k <= 3) with non-negative digits below 2^bits -> r mod p."""
    x, carry = _normalize(r[None] + d.reduce[:k], max(bits, LIMB_BITS) + 1, d.rows)
    out = x[0]
    for j in range(1, k):
        out = torch.where(carry[j] > 0, x[j], out)
    return out


def _product(a, b):
    """Column sums of the schoolbook product of [L, *] digit tensors: [2L, N].

    The outer product [L, L, N] is padded to [L, 2L+1, N]; read back as
    [L, 2L, N] with the padding dropped, row i starts i places later, so
    the sum over the first axis adds a_i*b_j onto row i+j."""
    P = a[:, None] * b[None]
    L, N = P.shape[0], P.shape[-1]
    Q = torch.nn.functional.pad(P, (0, 0, 0, L + 1))
    return Q.reshape(L * (2 * L + 1), N)[: 2 * L * L].reshape(L, 2 * L, N).sum(0)


def _mont_mul64(a, b, d):
    """a * b / R mod p on int64 digits; a, b canonical (b may be a [L, 1] column).

    Parallel Montgomery reduction: M = (T mod R) * p' mod R, where the
    digits of M are left relaxed (at most 2^13, so M < 1.0002 R), and
    S = T + M*p is divisible by R with S / R < 2.0002 p."""
    L = a.shape[0]
    lg = L.bit_length()
    T = _product(a, b)  # digits < L * 2^26
    M, _ = _relax(_product(T[:L], d.pprime)[:L], 26 + lg + LIMB_BITS + lg)
    S, _ = _relax(T + _product(M, d.p), 27 + lg)
    # S's low half is now 0 or R (digits <= 2^13): one carry into the high half
    r = S[L:].clone()
    r[0] += (S[:L] != 0).any(dim=0)
    return _select_reduce(r, d, 3, LIMB_BITS + 1)


def _add64(a, b, d):
    return _select_reduce(a + b, d, 2, LIMB_BITS + 1)


def _sub64(a, b, d):
    r = a + (LIMB_MASK - b)  # a - b + R - 1
    r[0] += 1
    x, carry = _normalize(r[None] + d.sub, LIMB_BITS + 2, d.rows)
    return torch.where(carry[0] > 0, x[0], x[1])  # a >= b ? a - b : a - b + p


def _exp_inv_alpha64(x, fc: FieldConsts, d):
    """x^(1/alpha) by the reference's addition chain (``inv_alpha_chain``)."""
    regs = {0: x}
    for op in fc.chain:
        regs[op[1]] = _mont_mul64(regs[op[2]], regs[op[-1]], d)
    return regs[fc.chain[-1][1]]


# --------------------------------------------------------------------------
# public operations on [L, N] limb tensors (canonical in, canonical out)
# --------------------------------------------------------------------------


def _binary(fn, a, b, fc):
    return fn(a.long(), b.long(), fc.on(a.device)).to(a.dtype)


def mont_mul(a, b, fc: FieldConsts):
    """Montgomery product a*b*R^-1 mod p."""
    return _binary(_mont_mul64, a, b, fc)


def mont_sqr(a, fc: FieldConsts):
    return mont_mul(a, a, fc)


def add_mod(a, b, fc: FieldConsts):
    return _binary(_add64, a, b, fc)


def double_mod(a, fc: FieldConsts):
    return add_mod(a, a, fc)


def sub_mod(a, b, fc: FieldConsts):
    return _binary(_sub64, a, b, fc)


def canonicalize(a, fc: FieldConsts):
    """A value below 3p with non-negative digits below 2^14 -> [0, p)."""
    return _select_reduce(a.long(), fc.on(a.device), 3, LIMB_BITS + 1).to(a.dtype)


def exp_inv_alpha(x, fc: FieldConsts):
    return _exp_inv_alpha64(x.long(), fc, fc.on(x.device)).to(x.dtype)


# Columns per product in to_mont / from_mont, which take whole messages:
# the product's int64 outer product [L, 2L+1, N] of 2^18 columns is 1.7 GB
# for L = 20.
_CONVERT_COLUMNS = 1 << 18


def _mul_by_column(a, name: str, fc: FieldConsts):
    d = fc.on(a.device)
    parts = [_mont_mul64(part.long(), getattr(d, name), d).to(a.dtype) for part in a.split(_CONVERT_COLUMNS, dim=1)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def to_mont(a, fc: FieldConsts):
    """Canonical plain limbs -> Montgomery form: a product by R^2."""
    return _mul_by_column(a, "r2", fc)


def from_mont(a, fc: FieldConsts):
    """Montgomery form -> canonical plain limbs: a product by 1."""
    return _mul_by_column(a, "unit", fc)


def _const_column(const_limbs: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(const_limbs, dtype=np.int64).reshape(-1, 1), device=device)


def add_const(a, const_limbs: np.ndarray, fc: FieldConsts):
    """a + c mod p for a host constant c of canonical limbs (int32 [L])."""
    return _add64(a.long(), _const_column(const_limbs, a.device), fc.on(a.device)).to(a.dtype)


def mul_const(a, const_limbs: np.ndarray, fc: FieldConsts):
    """a * c for a host constant c already in Montgomery form (int32 [L])."""
    return _mont_mul64(a.long(), _const_column(const_limbs, a.device), fc.on(a.device)).to(a.dtype)


def exp_alpha(x, fc: FieldConsts, alpha: int):
    """The forward S-box power x^alpha for the small static alpha (5 or 11),
    by square-and-multiply from the top bit."""
    d = fc.on(x.device)
    base = acc = x.long()
    for bit in bin(alpha)[3:]:  # the leading 1 is the starting x
        acc = _mont_mul64(acc, acc, d)
        if bit == "1":
            acc = _mont_mul64(acc, base, d)
    return acc.to(x.dtype)


# The JAX package's TPU schedules (anemoi_tpu/ff/limb_ops.py:field_consts):
# the port accepts the same names and runs its own arithmetic for all of them.
MUL_IMPLS = ("cios", "cios2", "cios2s", "parallel", "mxu", "mxu2", "mxu3", "mxus", "mxuf")
LADDERS = ("fixed4", "sw4", "chain", "chain2", "chain3")


def check_tuning(mul_impl: str | None = None, ladder: str | None = None) -> None:
    """Raises ValueError for a mul_impl or ladder name the JAX package
    rejects; None stands for its per-instance default."""
    if ladder is not None and ladder not in LADDERS and not (
        ladder.startswith("chainseg") and (ladder[8:] == "" or (ladder[8:].isdigit() and int(ladder[8:]) >= 1))
    ):
        raise ValueError(f"unknown ladder {ladder!r}; expected one of {', '.join(LADDERS)} or 'chainseg[N]'")
    if mul_impl is not None and mul_impl not in MUL_IMPLS and not (
        mul_impl.startswith("cios") and mul_impl[4:].isdigit()
    ):
        raise ValueError(f"unknown mul_impl {mul_impl!r}; expected one of {', '.join(MUL_IMPLS)} or 'cios<k>'")


# --------------------------------------------------------------------------
# host-side encode / decode
# --------------------------------------------------------------------------


def encode_ints(values, fp: FieldParams, *, mont: bool = True) -> torch.Tensor:
    """Python ints -> int32 [L, B] limbs on the CPU (Montgomery form by default)."""
    L = fp.n_limbs
    out = np.zeros((L, len(values)), dtype=np.int32)
    for b, v in enumerate(values):
        out[:, b] = limbs_from_int(fp.to_mont(v) if mont else v % fp.p, L)
    return torch.from_numpy(out)


def decode_ints(arr, fp: FieldParams, *, mont: bool = True) -> list:
    """int32 [L, B] limbs (tensor on any device, or array) -> Python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    out = []
    for b in range(arr.shape[1]):
        v = sum(int(arr[i, b]) << (LIMB_BITS * i) for i in range(arr.shape[0]))
        out.append(fp.from_mont(v) if mont else v % fp.p)
    return out


def random_canonical(fp: FieldParams, shape, rng: np.random.Generator) -> np.ndarray:
    """int32 [L, *shape] random limbs whose values are canonical: every bit
    from 2^(bits(p)-1) up is cleared, so each value is below p."""
    L = fp.n_limbs
    arr = rng.integers(0, 1 << LIMB_BITS, size=(L, *shape), dtype=np.int32)
    keep = np.clip(fp.p.bit_length() - 1 - LIMB_BITS * np.arange(L), 0, LIMB_BITS)
    return arr & ((1 << keep) - 1).astype(np.int32).reshape(L, *([1] * len(shape)))
