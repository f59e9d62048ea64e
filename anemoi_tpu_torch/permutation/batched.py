"""Batched Anemoi permutation over [WIDTH, L, B] limb states, plain PyTorch.

Counterpart of ``anemoi_tpu/permutation/batched.py``: the same layers
over ``ff/limb_ops``, for one to six columns and an explicit MDS matrix, on
Montgomery limb states (int32 [WIDTH, L, B], canonical).  It runs on any
device; the main path on the card goes through the CUDA kernel instead
(``ff/cuda_backend.py``), and this is the kernel's plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff import limb_ops as lo
from ..fields.params import InstanceParams, limbs_from_int


def round_constant_limbs(inst: InstanceParams) -> tuple[np.ndarray, np.ndarray]:
    """C and D as (rounds, columns, L) int32 Montgomery limb arrays."""
    fp = inst.field

    def conv(table):
        return np.stack(
            [limbs_from_int(fp.to_mont(v), fp.n_limbs) for v in table]
        ).reshape(inst.rounds, inst.columns, fp.n_limbs)

    return conv(inst.C), conv(inst.D)


def _ark_layer(state, Cr, Dr, cols, fc):
    """state[i] += C[r][i]; state[cols+i] += D[r][i]; Cr, Dr: [cols, L, 1]."""
    s = list(state)
    for i in range(cols):
        s[i] = lo.add_mod(s[i], Cr[i], fc)
        s[cols + i] = lo.add_mod(s[cols + i], Dr[i], fc)
    return s


def _mul_g(a, d, fc):
    return lo.mont_mul(a, d.beta, fc)


def _mds_internal(s, cols, d, fc):
    """The half-state MDS product of 3 or 4 columns (reference traits.rs:298-323)."""
    s = list(s)
    if cols == 3:
        tmp = lo.add_mod(s[0], _mul_g(s[2], d, fc), fc)
        s[2] = lo.add_mod(lo.add_mod(s[2], s[1], fc), _mul_g(s[0], d, fc), fc)
        s[0] = lo.add_mod(tmp, s[2], fc)
        s[1] = lo.add_mod(s[1], tmp, fc)
    else:
        s[0] = lo.add_mod(s[0], s[1], fc)
        s[2] = lo.add_mod(s[2], s[3], fc)
        s[3] = lo.add_mod(s[3], _mul_g(s[0], d, fc), fc)
        s[1] = _mul_g(lo.add_mod(s[1], s[2], fc), d, fc)
        s[0] = lo.add_mod(s[0], s[1], fc)
        s[2] = lo.add_mod(s[2], _mul_g(s[3], d, fc), fc)
        s[1] = lo.add_mod(s[1], s[2], fc)
        s[3] = lo.add_mod(s[3], s[0], fc)
    return s


def _mds_circulant(x, cols, fc):
    """The circulant products of 5 or 6 columns (reference traits.rs:188-246),
    by additions and doublings."""
    add = lambda *vs: functools.reduce(lambda a, b: lo.add_mod(a, b, fc), vs)
    total = add(*x)
    out = []
    for i in range(cols):
        at = lambda j: x[(i + j) % cols]
        if cols == 5:
            inner = add(at(2), at(3), lo.double_mod(at(4), fc))
            out.append(add(total, at(3), lo.double_mod(inner, fc)))
        else:
            inner = add(at(2), at(3), lo.double_mod(add(at(4), at(5)), fc))
            out.append(add(total, at(3), at(5), lo.double_mod(inner, fc)))
    return out


def _mds_matrix(x, mds, fc):
    """The generic fallback (reference traits.rs:272-293): x <- M x for an
    explicit row-major matrix of plain integers."""
    fp = fc.field
    cols = len(x)
    consts = [limbs_from_int(fp.to_mont(m), fp.n_limbs) for m in mds]
    out = []
    for i in range(cols):
        terms = [lo.mul_const(x[j], consts[i * cols + j], fc) for j in range(cols)]
        out.append(functools.reduce(lambda a, b: lo.add_mod(a, b, fc), terms))
    return out


def _pht(s, cols, fc):
    """The pseudo-Hadamard transform: y += x, then x += y."""
    for i in range(cols):
        s[cols + i] = lo.add_mod(s[cols + i], s[i], fc)
    for i in range(cols):
        s[i] = lo.add_mod(s[i], s[cols + i], fc)
    return s


def _mds_layer(state, cols, fc, mds=None):
    """The linear layer and the PHT (reference traits.rs:129-294).

    The shipped instances have one or two columns; 3 to 6 columns take the
    reference's wider fast paths, and more need an explicit matrix
    (``InstanceParams.mds``), as in the golden model.  The y half is
    rotated left by one cell before its product."""
    d = fc.on(state[0].device)
    s = list(state)
    if cols == 1:
        s[1] = lo.add_mod(s[1], s[0], fc)
        s[0] = lo.add_mod(s[0], s[1], fc)
        return s
    if cols == 2:
        s[0] = lo.add_mod(s[0], _mul_g(s[1], d, fc), fc)
        s[1] = lo.add_mod(s[1], _mul_g(s[0], d, fc), fc)
        s[3] = lo.add_mod(s[3], _mul_g(s[2], d, fc), fc)
        s[2] = lo.add_mod(s[2], _mul_g(s[3], d, fc), fc)
        s[2], s[3] = s[3], s[2]
        return _pht(s, 2, fc)
    x, y = s[:cols], s[cols + 1 :] + s[cols : cols + 1]
    if cols in (3, 4):
        return _pht(_mds_internal(x, cols, d, fc) + _mds_internal(y, cols, d, fc), cols, fc)
    if cols in (5, 6):
        return _pht(_mds_circulant(x, cols, fc) + _mds_circulant(y, cols, fc), cols, fc)
    if mds is None:
        raise NotImplementedError("columns > 6 need an explicit MDS matrix (InstanceParams.mds)")
    return _pht(_mds_matrix(x, mds, fc) + _mds_matrix(y, mds, fc), cols, fc)


def _sbox_layer(state, cols, fc):
    """Open Flystel: x -= g*y^2 ; y -= x^(1/alpha) ; x += g*y^2 + delta.

    The columns are laid side by side along the batch axis, so every
    column shares one ladder (as the TPU kernel does)."""
    d = fc.on(state[0].device)
    x = torch.cat(state[:cols], dim=1)
    y = torch.cat(state[cols:], dim=1)
    x = lo.sub_mod(x, _mul_g(lo.mont_sqr(y, fc), d, fc), fc)
    y = lo.sub_mod(y, lo.exp_inv_alpha(x, fc), fc)
    x = lo.add_mod(x, _mul_g(lo.mont_sqr(y, fc), d, fc), fc)
    x = lo.add_mod(x, d.delta, fc)
    return list(x.chunk(cols, dim=1)) + list(y.chunk(cols, dim=1))


def permutation_fn(inst: InstanceParams, *, unroll: bool = False):
    """Returns permute(state: int32 [WIDTH, L, B] Montgomery) -> same shape.

    NUM_ROUNDS x (ark -> mds -> sbox), then a final mds.  ``unroll``, the
    JAX package's choice between a rolled and an unrolled XLA graph, is
    accepted and ignored: PyTorch runs the layers eagerly either way."""
    fc = lo.field_consts(inst.field)
    cols = inst.columns
    C, D = round_constant_limbs(inst)
    tables: dict = {}

    def permute(states):
        dev = states.device
        if dev not in tables:
            tables[dev] = tuple(torch.as_tensor(t[..., None], dtype=torch.int64, device=dev) for t in (C, D))
        Ct, Dt = tables[dev]
        parts = list(states.long().unbind(0))
        for r in range(inst.rounds):
            parts = _ark_layer(parts, Ct[r], Dt[r], cols, fc)
            parts = _mds_layer(parts, cols, fc, inst.mds)
            parts = _sbox_layer(parts, cols, fc)
        parts = _mds_layer(parts, cols, fc, inst.mds)
        return torch.stack(parts).to(states.dtype)

    return permute
