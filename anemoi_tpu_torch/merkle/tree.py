"""Merkle trees over Jive compression: roots, levels, checkpoints and proofs.

Counterpart of ``anemoi_tpu/merkle/tree.py`` (``_level_fn`` on its kernel
branch, and ``MerkleTree``): a level is one batched Jive call, with child j
of node i gathered from column arity*i + j; levels iterate on the host, and
digests stay in Montgomery limb form throughout.  On the card every level
is exactly one launch of the Jive kernel, and levels stay on the card.

Checkpoints are the JAX tree's: ``level_{lv}.npy`` written by ``np.save``
as each level completes (int32 [L, N / arity^lv]), so a directory written
by either tree resumes in the other.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ff import cuda_backend, golden
from ..ff.limb_ops import check_tuning, decode_ints
from ..fields.params import InstanceParams


def level_states(digests: torch.Tensor, arity: int) -> torch.Tensor:
    """int32 [L, N] digests -> int32 [arity*L, N/arity] Jive inputs: row
    w*L + l of node i is limb l of child w, which sits at column arity*i + w."""
    L, n = digests.shape
    return digests.reshape(L, n // arity, arity).permute(2, 0, 1).reshape(arity * L, n // arity)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MerkleTree:
    """Merkle tree builder for one instantiation: arity 2 for anemoi_2_1
    (Jive 2-to-1), arity 4 for anemoi_4_3 (Jive 4-to-1).

    The JAX package's keyword arguments change no root.  The device picks
    the route, not ``backend``: every name and the port's "cuda" give one
    Jive launch a level on the card and the plain version on the CPU.
    ``chunk_b`` is accepted and ignored: a level is one launch whatever its
    size.  ``mul_impl`` and ``ladder`` name the JAX package's TPU schedules:
    a name it rejects raises ``ValueError`` here too; the others run the
    port's own arithmetic."""

    def __init__(
        self,
        inst: InstanceParams,
        *,
        backend: str = "jit",
        chunk_b: int | None = None,
        mul_impl: str | None = None,
        ladder: str | None = None,
        device=None,
    ):
        check_tuning(mul_impl, ladder)
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

    def _load_level(self, path: Path, n_leaves: int, lv: int) -> torch.Tensor:
        arr = np.load(path)
        want = (self.inst.field.n_limbs, n_leaves // self.arity**lv)
        if arr.dtype != np.int32 or arr.shape != want:
            raise ValueError(f"{path}: expected int32 {want}, got {arr.dtype} {arr.shape}")
        return torch.from_numpy(arr).to(self.device)

    def root(self, leaves, *, return_levels: bool = False, checkpoint_dir=None):
        """leaves: int32 [L, N] canonical Montgomery digests (tensor or
        array), N a power of the arity; returns the int32 [L, 1] root on the
        tree's device.

        With ``return_levels`` also returns every level, leaves first and
        root last, on the tree's device (what ``prove`` walks).  With
        ``checkpoint_dir`` each completed level is saved there as
        ``level_{lv}.npy``, and a run resumes from the deepest level file it
        finds; a resumed run with ``return_levels`` needs every level file
        up to that point and raises ``FileNotFoundError`` without one."""
        level = torch.as_tensor(leaves, dtype=torch.int32, device=self.device)
        L = self.inst.field.n_limbs
        if level.dim() != 2 or level.shape[0] != L:
            raise ValueError(f"expected leaves [{L}, N], got {tuple(level.shape)}")
        n_leaves = int(level.shape[1])
        n_levels = self.num_levels(n_leaves)
        levels = [level]
        start = 0
        ckpt = None if checkpoint_dir is None else Path(checkpoint_dir)
        if ckpt is not None:
            ckpt.mkdir(parents=True, exist_ok=True)
            start = next((lv for lv in range(n_levels, 0, -1) if (ckpt / f"level_{lv}.npy").exists()), 0)
            if start:
                level = self._load_level(ckpt / f"level_{start}.npy", n_leaves, start)
            if return_levels and start:
                # a resumed run returns the same levels a fresh one would
                for lv in range(1, start + 1):
                    f = ckpt / f"level_{lv}.npy"
                    if not f.exists():
                        raise FileNotFoundError(f"checkpoint resume with return_levels=True needs every level "
                                                f"file up to the resume point; missing {f}")
                    levels.append(level if lv == start else self._load_level(f, n_leaves, lv))
        for lv in range(start, n_levels):
            level = self._level(level)
            if return_levels:
                levels.append(level)
            if ckpt is not None:
                np.save(ckpt / f"level_{lv + 1}.npy", level.cpu().numpy())
        return (level, levels) if return_levels else level

    def prove(self, levels: list, index: int) -> list:
        """The authentication path of leaf `index` from the levels ``root``
        returned: [(int32 [L, arity] host array, child position)] per level
        below the root.  As in the JAX tree, each entry holds all `arity`
        children of the node, the path's own included.  Only those columns
        are copied to the host."""
        n = int(levels[0].shape[1])
        if not 0 <= index < n:
            raise ValueError(f"leaf index {index} outside [0, {n})")
        path = []
        idx = index
        for level in levels[:-1]:
            base = idx - idx % self.arity
            path.append((_host(level[:, base:base + self.arity]), idx % self.arity))
            idx //= self.arity
        return path

    def verify(self, root, leaf, index: int, path: list) -> bool:
        """Recomputes the root from a leaf (int32 [L] or [L, 1]) and its
        path with the golden model, one Jive per level.  Unlike the JAX
        tree, the path's child positions must spell `index`."""
        fp = self.inst.field
        cur = decode_ints(_host(leaf).reshape(-1, 1), fp)[0]
        idx = index
        for sibs, pos in path:
            if pos != idx % self.arity:
                return False
            children = decode_ints(_host(sibs), fp)
            children[pos] = cur
            cur = golden.jive_compress_k(self.inst, children, self.k)[0]
            idx //= self.arity
        return idx == 0 and cur == decode_ints(_host(root).reshape(-1, 1), fp)[0]


def check_levels(inst: InstanceParams, levels: list, per_level: int = 4) -> int:
    """Recomputes up to ``per_level`` nodes of every level above the leaves
    (half at each end) with the golden model from their children in the
    level below, as ``MerkleTree.root(..., return_levels=True)`` returns
    them; returns the count held, or raises ``golden.ParityError``.  This
    checks a tree of any size in milliseconds."""
    arity, k, fp = inst.width, inst.width // inst.digest_size, inst.field
    held = 0
    for lv in range(1, len(levels)):
        n = int(levels[lv].shape[1])
        for j in sorted(set(range(min(n, per_level // 2))) | set(range(max(n - per_level // 2, 0), n))):
            children = decode_ints(levels[lv - 1][:, arity * j:arity * (j + 1)], fp)
            if decode_ints(levels[lv][:, j:j + 1], fp) != golden.jive_compress_k(inst, children, k):
                raise golden.ParityError(f"{inst.qualified_name} root: node {j} of level {lv} differs from the "
                                         f"golden model")
            held += 1
    return held
