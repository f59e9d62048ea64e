"""Carrying the reference's parameter tables across to the port.

``from_reference_arrays`` builds the port's tables for one instance from
the numpy arrays the JAX package derives (``round_constant_limbs`` and the
limb constants of ``limb_ops.field_consts``), so the two derivations can be
held against each other: ``derive_tables`` is the port's own, from its
JSON copy.  Both give the plain path's limb tables and the CUDA kernels'
word tables (8 words for a 20-limb field, 12 for a 30-limb one).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ff.limb_ops import FieldConsts, field_consts
from ..permutation.batched import round_constant_limbs
from .params import InstanceParams, KernelConsts, int_from_limbs, kernel_consts, kernel_consts_from_ints


@dataclass(frozen=True, eq=False)
class InstanceTables:
    limbs: FieldConsts  # plain path, R = 2^(13L)
    C: np.ndarray  # (rounds, columns, L) int32, R form
    D: np.ndarray
    kernel: KernelConsts

    def arrays(self) -> dict:
        out = {f"limbs.{k}": v for k, v in self.limbs.arrays().items()}
        out.update(C=self.C, D=self.D)
        out.update({f"kernel.{k}": v for k, v in self.kernel.arrays().items()})
        return out


def derive_tables(inst: InstanceParams) -> InstanceTables:
    C, D = round_constant_limbs(inst)
    return InstanceTables(field_consts(inst.field), C, D, kernel_consts(inst))


def from_reference_arrays(inst: InstanceParams, *, C, D, p, one_mont, r2, beta_mont, delta_mont) -> InstanceTables:
    """The port's tables from the reference's arrays: C and D as
    (rounds, columns, L) Montgomery limbs, the rest as (L,) limbs."""
    fp = inst.field
    if int_from_limbs(p) != fp.p:
        raise ValueError(f"the reference's p is not {fp.name}'s")
    C = np.asarray(C, dtype=np.int32)
    D = np.asarray(D, dtype=np.int32)
    if C.shape != (inst.rounds, inst.columns, fp.n_limbs) or D.shape != C.shape:
        raise ValueError(f"round constants of shape {C.shape}, {D.shape} for {inst.qualified_name}")
    limbs = FieldConsts(fp, p=p, one_mont=one_mont, r2=r2, beta_mont=beta_mont, delta_mont=delta_mont)
    plain = lambda arr: fp.from_mont(int_from_limbs(arr))
    kernel = kernel_consts_from_ints(
        inst,
        [plain(c) for c in C.reshape(-1, fp.n_limbs)],
        [plain(d) for d in D.reshape(-1, fp.n_limbs)],
        plain(beta_mont),
        plain(delta_mont),
        plain(one_mont),
    )
    return InstanceTables(limbs, C, D, kernel)
