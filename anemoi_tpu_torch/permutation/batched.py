"""Batched Anemoi permutation over [WIDTH, L, B] limb states, plain PyTorch.

Counterpart of ``anemoi_tpu/permutation/batched.py`` for the shipped
instances (one or two columns): the same layers over ``ff/limb_ops``, on
Montgomery limb states (int32 [WIDTH, L, B], canonical).  It runs on any
device; the main path on the card goes through the CUDA kernel instead
(``ff/cuda_backend.py``), and this is the kernel's plain version.
"""

from __future__ import annotations

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


def _mds_layer(state, cols, fc):
    """Linear layer and PHT for one or two columns (the shipped instances)."""
    d = fc.on(state[0].device)
    s = list(state)
    if cols == 1:
        s[1] = lo.add_mod(s[1], s[0], fc)
        s[0] = lo.add_mod(s[0], s[1], fc)
        return s
    if cols != 2:
        raise NotImplementedError("the port has the 1- and 2-column MDS layers only")
    s[0] = lo.add_mod(s[0], _mul_g(s[1], d, fc), fc)
    s[1] = lo.add_mod(s[1], _mul_g(s[0], d, fc), fc)
    s[3] = lo.add_mod(s[3], _mul_g(s[2], d, fc), fc)
    s[2] = lo.add_mod(s[2], _mul_g(s[3], d, fc), fc)
    s[2], s[3] = s[3], s[2]
    for i in range(2):
        s[2 + i] = lo.add_mod(s[2 + i], s[i], fc)
    for i in range(2):
        s[i] = lo.add_mod(s[i], s[2 + i], fc)
    return s


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


def permutation_fn(inst: InstanceParams):
    """Returns permute(state: int32 [WIDTH, L, B] Montgomery) -> same shape.

    NUM_ROUNDS x (ark -> mds -> sbox), then a final mds."""
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
            parts = _mds_layer(parts, cols, fc)
            parts = _sbox_layer(parts, cols, fc)
        parts = _mds_layer(parts, cols, fc)
        return torch.stack(parts).to(states.dtype)

    return permute
