"""Merkle-tree roots over Jive compression.

Counterpart of ``anemoi_tpu/merkle/tree.py`` (``_level_fn`` on its kernel
branch, and ``MerkleTree.root``): a level is one batched Jive call, with
child j of node i gathered from column arity*i + j; levels iterate on the
host, and digests stay in Montgomery limb form throughout.  On the card
every level is exactly one launch of the Jive kernel.

Proofs, checkpoints and ``return_levels`` are not ported yet.
"""

from __future__ import annotations

import torch

from ..ff import cuda_backend
from ..fields.params import InstanceParams


def level_states(digests: torch.Tensor, arity: int) -> torch.Tensor:
    """int32 [L, N] digests -> int32 [arity*L, N/arity] Jive inputs: row
    w*L + l of node i is limb l of child w, which sits at column arity*i + w."""
    L, n = digests.shape
    return digests.reshape(L, n // arity, arity).permute(2, 0, 1).reshape(arity * L, n // arity)


class MerkleTree:
    """Merkle tree builder for one instantiation: arity 2 for anemoi_2_1
    (Jive 2-to-1), arity 4 for anemoi_4_3 (Jive 4-to-1)."""

    def __init__(self, inst: InstanceParams, *, device=None):
        self.inst = inst
        self.arity = inst.width
        self.k = inst.width // inst.digest_size
        self.device = cuda_backend.resolve_device(device)

    def num_levels(self, n_leaves: int) -> int:
        levels = 0
        while n_leaves > 1:
            if n_leaves % self.arity:
                raise ValueError("the leaf count must be a power of the arity")
            n_leaves //= self.arity
            levels += 1
        return levels

    def _level(self, digests: torch.Tensor) -> torch.Tensor:
        return cuda_backend.jive(self.inst, self.k, level_states(digests, self.arity))

    def root(self, leaves) -> torch.Tensor:
        """leaves: int32 [L, N] canonical Montgomery digests (tensor or array),
        N a power of the arity; returns the int32 [L, 1] root on the tree's device."""
        level = torch.as_tensor(leaves, dtype=torch.int32, device=self.device)
        L = self.inst.field.n_limbs
        if level.dim() != 2 or level.shape[0] != L:
            raise ValueError(f"expected leaves [{L}, N], got {tuple(level.shape)}")
        for _ in range(self.num_levels(int(level.shape[1]))):
            level = self._level(level)
        return level
