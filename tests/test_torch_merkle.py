"""Merkle trees of the port against the JAX package, on the CPU.

Tolerance: exact.  The 2-to-1 cases are tests/test_merkle.py's: canonical
Vesta leaves against ``MerkleTree(inst, chunk_b=8)`` (the same compiled
shape): roots, ``return_levels``, ``prove`` / ``verify`` round trips and a
tampered leaf, checkpoint directories written by one tree and resumed by
the other, and the missing-level error.  The 4-to-1 root and the same
cases for BLS12-381 are held against the golden model.
"""

from functools import lru_cache

import numpy as np
import pytest

from anemoi_tpu.ff import golden
from anemoi_tpu.ff.limb_ops import encode_ints as j_encode_ints
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.merkle.tree import MerkleTree as JMerkleTree
from anemoi_tpu_torch.ff.limb_ops import decode_ints, encode_ints
from anemoi_tpu_torch.fields.params import get_instance
from anemoi_tpu_torch.merkle.tree import MerkleTree, level_states


def _leaves(n, seed):
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, 2**62)) for _ in range(n)]


def test_root_matches_jax():
    inst = get_instance("vesta", "anemoi_2_1")
    leaves = _leaves(16, 3)
    arr = encode_ints(leaves, inst.field)
    want = JMerkleTree(jparams.get_instance("vesta", "anemoi_2_1"), chunk_b=8).root(
        j_encode_ints(leaves, jparams.get_field("vesta")))
    got = MerkleTree(inst, device="cpu").root(arr)
    assert tuple(got.shape) == (20, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_arity_4_root_matches_golden():
    inst = get_instance("vesta", "anemoi_4_3")
    ref = jparams.get_instance("vesta", "anemoi_4_3")
    leaves = _leaves(16, 4)
    level = list(leaves)
    while len(level) > 1:
        level = [golden.jive_compress_k(ref, level[i : i + 4], 4)[0] for i in range(0, len(level), 4)]
    got = MerkleTree(inst, device="cpu").root(encode_ints(leaves, inst.field).numpy())
    assert decode_ints(got, inst.field) == level


def test_check_levels_holds_nodes_against_golden():
    """``check_levels`` on a 32-leaf tree's levels built by the golden
    model: 2 nodes at each end of every level, 15 in all; a flipped limb
    in a checked node raises, one in a node that is neither checked nor
    the child of a checked node does not."""
    from anemoi_tpu_torch.ff.golden import ParityError
    from anemoi_tpu_torch.merkle.tree import check_levels

    inst = get_instance("vesta", "anemoi_2_1")
    level = _leaves(32, 5)
    levels = [encode_ints(level, inst.field)]
    while len(level) > 1:
        level = [golden.jive_compress(inst, level[i : i + 2])[0] for i in range(0, len(level), 2)]
        levels.append(encode_ints(level, inst.field))
    assert check_levels(inst, levels) == 4 + 4 + 4 + 2 + 1
    levels[1][0, 5] ^= 1  # node 5 of 16, a child of node 2 of 8: neither is checked
    assert check_levels(inst, levels) == 15
    levels[2][0, 1] ^= 1  # node 1 of 8
    with pytest.raises(ParityError, match="node 1 of level 2"):
        check_levels(inst, levels)


def test_level_states_gathers_children():
    digests = np.arange(3 * 8, dtype=np.int32).reshape(3, 8)  # L = 3, 8 digests
    import torch

    got = level_states(torch.from_numpy(digests), 2).numpy()
    # node i's child w is column 2i + w; its limb l lands in row w*3 + l
    for i in range(4):
        for w in range(2):
            np.testing.assert_array_equal(got[w * 3 : w * 3 + 3, i], digests[:, 2 * i + w])


def test_root_rejects_bad_leaf_counts():
    tree = MerkleTree(get_instance("vesta", "anemoi_2_1"), device="cpu")
    assert tree.num_levels(1 << 20) == 20
    with pytest.raises(ValueError):
        tree.root(np.zeros((20, 6), np.int32))
    with pytest.raises(ValueError):
        tree.root(np.zeros((19, 8), np.int32))


# --------------------------------------------------------------------------
# levels, proofs and checkpoints (anemoi_tpu/merkle/tree.py:154-247)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _jax_tree():
    """One JAX tree for the file: its jitted level compiles once."""
    return JMerkleTree(jparams.get_instance("vesta", "anemoi_2_1"), chunk_b=8)


def _vesta_leaves(seed):
    """8 canonical Vesta leaves, as tests/test_merkle.py makes them."""
    return encode_ints(_leaves(8, seed), get_instance("vesta", "anemoi_2_1").field).numpy()


def _golden_levels(ref, leaves):
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        lv = levels[-1]
        levels.append([golden.jive_compress_k(ref, lv[i : i + ref.width], ref.width)[0]
                       for i in range(0, len(lv), ref.width)])
    return levels


def test_levels_and_proofs_match_jax():
    """return_levels, prove and verify against the JAX tree on Vesta 2_1
    (tests/test_merkle.py's 8 leaves from seed 4): the same levels, the same
    paths (all `arity` children of each node, as the JAX code returns them),
    proofs that verify in both trees, and a tampered leaf that fails."""
    arr = _vesta_leaves(4)
    jtree, tree = _jax_tree(), MerkleTree(get_instance("vesta", "anemoi_2_1"), device="cpu")
    jroot, jlevels = jtree.root(arr, return_levels=True)
    root, levels = tree.root(arr, return_levels=True)
    assert len(levels) == len(jlevels) == 4
    for got, want in zip(levels, jlevels):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(root.numpy(), np.asarray(jroot))
    jlevels = [np.asarray(lv) for lv in jlevels]
    for idx in (0, 3, 5, 7):
        path, jpath = tree.prove(levels, idx), jtree.prove(jlevels, idx)
        assert [pos for _, pos in path] == [pos for _, pos in jpath]
        for (sibs, _), (jsibs, _) in zip(path, jpath):
            assert sibs.shape == (20, 2)
            np.testing.assert_array_equal(sibs, jsibs)
        leaf = levels[0][:, idx : idx + 1]
        assert tree.verify(root, leaf, idx, path)
        assert jtree.verify(jroot, leaf.numpy(), idx, path)
    path = tree.prove(levels, 2)
    assert not tree.verify(root, levels[0][:, 5:6], 2, path)
    assert not jtree.verify(jroot, jlevels[0][:, 5:6], 2, jtree.prove(jlevels, 2))
    # the port also holds the path's positions to the index
    assert not tree.verify(root, levels[0][:, 2:3], 3, path)
    with pytest.raises(ValueError):
        tree.prove(levels, 8)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_trees(tmp_path, writer):
    """A checkpoint directory written by one tree resumes in the other:
    the same file names and contents, and the resumed root and levels equal
    the fresh ones."""
    arr = _vesta_leaves(5)
    jtree, tree = _jax_tree(), MerkleTree(get_instance("vesta", "anemoi_2_1"), device="cpu")
    fresh_root, fresh = jtree.root(arr, return_levels=True)
    fresh = [np.asarray(lv) for lv in fresh]
    first, second = (jtree, tree) if writer == "jax" else (tree, jtree)
    ckpt = tmp_path / "ckpt"
    first.root(arr, checkpoint_dir=ckpt)
    assert sorted(f.name for f in ckpt.iterdir()) == ["level_1.npy", "level_2.npy", "level_3.npy"]
    for lv in (1, 2, 3):
        saved = np.load(ckpt / f"level_{lv}.npy")
        assert saved.dtype == np.int32
        np.testing.assert_array_equal(saved, fresh[lv])
    for lv in (2, 3):  # the run stopped after level 1
        (ckpt / f"level_{lv}.npy").unlink()
    root, levels = second.root(arr, return_levels=True, checkpoint_dir=ckpt)
    np.testing.assert_array_equal(np.asarray(root), np.asarray(fresh_root))
    assert len(levels) == len(fresh)
    for got, want in zip(levels, fresh):
        np.testing.assert_array_equal(np.asarray(got), want)
    for lv in (2, 3):
        np.testing.assert_array_equal(np.load(ckpt / f"level_{lv}.npy"), fresh[lv])


def test_checkpoint_resume_missing_level_raises(tmp_path):
    """As in the JAX tree: a resume with return_levels needs every level
    file up to the resume point.  A level file of the wrong shape raises."""
    arr = _vesta_leaves(6)
    tree = MerkleTree(get_instance("vesta", "anemoi_2_1"), device="cpu")
    ckpt = tmp_path / "ckpt"
    root = tree.root(arr, checkpoint_dir=ckpt)
    np.testing.assert_array_equal(tree.root(arr, checkpoint_dir=ckpt).numpy(), root.numpy())  # resumes at the root
    (ckpt / "level_1.npy").unlink()  # deepest (level_3) still present
    with pytest.raises(FileNotFoundError):
        tree.root(arr, return_levels=True, checkpoint_dir=ckpt)
    with pytest.raises(FileNotFoundError):
        _jax_tree().root(arr, return_levels=True, checkpoint_dir=ckpt)
    np.save(ckpt / "level_3.npy", np.zeros((20, 2), np.int32))
    with pytest.raises(ValueError):
        tree.root(arr, checkpoint_dir=ckpt)


def test_bls12_381_tree_against_golden(tmp_path):
    """The same cases for a 30-limb field, against the golden model: 4
    BLS12-381 leaves, levels, proofs, a tampered leaf, a resume and the
    missing-level error."""
    inst = get_instance("bls12_381", "anemoi_2_1")
    ref = jparams.get_instance("bls12_381", "anemoi_2_1")
    rng = np.random.default_rng(7)
    leaves = [int.from_bytes(rng.bytes(48), "little") % inst.field.p for _ in range(4)]
    want = _golden_levels(ref, leaves)
    tree = MerkleTree(inst, device="cpu")
    ckpt = tmp_path / "ckpt"
    root, levels = tree.root(encode_ints(leaves, inst.field), return_levels=True, checkpoint_dir=ckpt)
    assert [decode_ints(lv, inst.field) for lv in levels] == want
    assert tuple(root.shape) == (30, 1)
    for idx in range(4):
        path = tree.prove(levels, idx)
        assert [sibs.shape for sibs, _ in path] == [(30, 2), (30, 2)]
        assert tree.verify(root, levels[0][:, idx], idx, path)
        assert not tree.verify(root, levels[0][:, idx ^ 1], idx, path)
    (ckpt / "level_2.npy").unlink()
    root2, levels2 = tree.root(encode_ints(leaves, inst.field), return_levels=True, checkpoint_dir=ckpt)
    np.testing.assert_array_equal(root2.numpy(), root.numpy())
    assert [decode_ints(lv, inst.field) for lv in levels2] == want
    (ckpt / "level_1.npy").unlink()
    with pytest.raises(FileNotFoundError):
        tree.root(encode_ints(leaves, inst.field), return_levels=True, checkpoint_dir=ckpt)
