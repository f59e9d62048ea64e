"""The port's flagship entry point and its multi-chip dry run.

Counterpart of ``__graft_entry__.py``:

  * ``entry()``: the flagship operation, batched Vesta Anemoi-2-1 Jive
    2-to-1 compression (``jive_compress_batch_fn``, one launch of the Jive
    kernel on the card), and an example input, int32 [2, 20, 256] on the
    same device.  The example is canonical (``limb_ops.random_canonical``,
    seed 0): ``__graft_entry__.py:28-31`` draws random 12-bit limbs in all
    20 rows, whose values lie far above p, where two correct
    implementations may return different representatives of the same
    residue, so its outputs cannot be compared across implementations.
  * ``dryrun_multichip(n)``: batch-parallel Jive and the sharded Merkle
    forest (``dist/forest.py``: a subtree a rank and one all-gather of
    the roots) over n ranks on tiny shapes, with ``__graft_entry__.py``'s
    asserts.  Inside a process group it runs on that group's ranks;
    otherwise it starts n gloo processes on the CPU (``dist.ranks``).
    Every rank's root must equal the one-process ``MerkleTree`` root over
    the same leaves.

    python3 -m anemoi_tpu_torch.graft_entry     # on the card: "entry runs", "dryrun_multichip(4) ok"
"""

from __future__ import annotations

import numpy as np
import torch

from .ff.cuda_backend import resolve_device
from .ff.limb_ops import random_canonical
from .fields.params import get_instance
from .modes.batched import jive_compress_batch_fn

BATCH = 256
PER_RANK = 8  # states and leaves a rank, as __graft_entry__.py:55 and :64


def entry(device=None):
    """Returns (fn, (example,)): fn(states int32 [2, 20, B]) -> int32 [1, 20, B]
    on ``device`` (None: the card), and a canonical example of B = 256
    states on it."""
    device = resolve_device(device)
    inst = get_instance("vesta", "anemoi_2_1")
    fn = jive_compress_batch_fn(inst, 2, device=device)
    example = random_canonical(inst.field, (inst.width, BATCH), np.random.default_rng(0)).transpose(1, 0, 2)
    return fn, (torch.from_numpy(example.copy()).to(device),)


def _dryrun_inputs(n: int):
    """The dry run's instance, Jive states int32 [2, 20, 8n] and leaves
    int32 [20, 8n], the same on every rank and in the parent."""
    inst = get_instance("vesta", "anemoi_2_1")
    rng = np.random.default_rng(0)
    states = random_canonical(inst.field, (inst.width, PER_RANK * n), rng).transpose(1, 0, 2)
    return inst, states, random_canonical(inst.field, (PER_RANK * n,), rng)


def _dryrun_rank(chips) -> dict:
    """One rank's part of ``dryrun_multichip``: returns its root as ints."""
    from .dist.forest import sharded_jive_fn, sharded_merkle_root_fn
    from .dist.mesh import shard_batch

    n = chips.size()
    inst, states, leaves = _dryrun_inputs(n)  # each rank takes its slice
    L = inst.field.n_limbs

    # 1) batch-parallel Jive over the chips axis (pure data parallel)
    out = sharded_jive_fn(inst, chips)(shard_batch(states.reshape(inst.width * L, -1), chips))
    if out.shape != (L, PER_RANK):
        raise AssertionError(f"sharded Jive: shape {tuple(out.shape)}")

    # 2) the sharded Merkle forest: a subtree a rank and the all-gathered top tree
    root = sharded_merkle_root_fn(inst, chips, PER_RANK * n)(shard_batch(leaves, chips))
    if root.shape != (L, 1):
        raise AssertionError(f"sharded forest: root of shape {tuple(root.shape)}")
    return {"root": root[:, 0].tolist()}


def dryrun_multichip(n_devices: int) -> None:
    """Runs ``_dryrun_rank`` on every rank of the process group, which must
    have n_devices ranks, or without a group on n_devices gloo processes on
    the CPU; every rank's root must equal the one-process
    ``MerkleTree(device="cpu")`` root over the same leaves."""
    import torch.distributed as dist

    from .merkle.tree import MerkleTree

    if dist.is_initialized():
        from .dist.mesh import chip_mesh

        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        roots = [_dryrun_rank(chip_mesh(n_devices, device=device))["root"]]
    else:
        from .dist.ranks import run_ranks

        roots = [r["root"] for r in run_ranks("anemoi_tpu_torch.graft_entry:_dryrun_rank", n_devices)]
    inst, _, leaves = _dryrun_inputs(n_devices)
    want = MerkleTree(inst, device="cpu").root(torch.from_numpy(leaves))[:, 0].tolist()
    if any(r != want for r in roots):
        raise AssertionError(f"dryrun_multichip({n_devices}): a rank's root differs from the one-process root")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    if tuple(out.shape) != (1, 20, BATCH):
        raise AssertionError(f"entry: output of shape {tuple(out.shape)}, not (1, 20, {BATCH})")
    print("entry runs")
    dryrun_multichip(4)
    print("dryrun_multichip(4) ok")
