"""A Merkle forest over the ranks of a mesh: a subtree a rank, then the top.

Counterpart of ``anemoi_tpu/dist/forest.py``.  With N leaves over D ranks
(N/D and D powers of the arity), each rank reduces its contiguous N/D
leaves to a root on its own chip with the Jive kernel (one launch a
level, no communication), one ``all_gather_into_tensor`` brings every
rank the D roots (L int32 each), and every rank reduces them to the same
root: exactly the root of the one-chip tree over all N leaves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ff import cuda_backend
from ..fields.params import InstanceParams
from ..merkle.tree import MerkleTree
from .mesh import CHIPS_AXIS, collective_record, mesh_device


def sharded_merkle_root_fn(
    inst: InstanceParams, mesh: DeviceMesh, n_leaves: int, *, backend: str = "jit", chunk_b: int | None = None
):
    """Returns f(leaves: this rank's int32 [L, n_leaves / D] canonical
    Montgomery leaves, from ``shard_batch``) -> the int32 [L, 1] root, the
    same on every rank.  A collective call: every rank of the mesh makes
    it.  ``f.collectives`` records the collectives of the last call
    (``mesh.collective_traffic``).  ``backend`` and ``chunk_b`` are
    accepted and change nothing, as in ``MerkleTree``: the mesh's device
    picks the route."""
    ranks = mesh.size()
    device = mesh_device(mesh)
    tree = MerkleTree(inst, backend=backend, chunk_b=chunk_b, device=device)
    if n_leaves % ranks:
        raise ValueError(f"{n_leaves} leaves do not split evenly over {ranks} chips")
    # each rank's subtree and the top tree must have a power of the arity of leaves
    tree.num_levels(n_leaves // ranks)
    tree.num_levels(ranks)
    group = mesh.get_group(CHIPS_AXIS)
    L = inst.field.n_limbs

    def forest(leaves_local: torch.Tensor) -> torch.Tensor:
        forest.collectives = []
        if tuple(leaves_local.shape) != (L, n_leaves // ranks):
            raise ValueError(f"expected this rank's leaves [{L}, {n_leaves // ranks}], got {tuple(leaves_local.shape)}")
        root = tree.root(leaves_local)  # [L, 1]
        if ranks == 1:
            return root
        roots = torch.empty(ranks * L, dtype=torch.int32, device=device)  # rank r's root at r*L
        dist.all_gather_into_tensor(roots, root[:, 0].contiguous(), group=group)
        roots = roots.reshape(ranks, L)
        forest.collectives.append(collective_record("all-gather", roots))
        return tree.root(roots.T.contiguous())

    forest.collectives = []
    return forest


def sharded_jive_fn(inst: InstanceParams, mesh: DeviceMesh, k: int = 2, *, backend: str = "jit"):
    """Returns f(states: this rank's int32 [WIDTH*L, n] columns) -> int32
    [(WIDTH/k)*L, n]: Jive-k of each rank's own columns on its chip, with
    no communication (``f.collectives`` stays empty).  Every ``backend``
    name gives the same outputs: the mesh's device picks the route."""
    rows = inst.width * inst.field.n_limbs

    def jive(states: torch.Tensor) -> torch.Tensor:
        if states.dim() != 2 or states.shape[0] != rows:
            raise ValueError(f"expected states [{rows}, n], got {tuple(states.shape)}")
        return cuda_backend.jive(inst, k, states.to(mesh_device(mesh)).contiguous())

    jive.collectives = []
    return jive
