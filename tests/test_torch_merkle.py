"""Merkle roots of the port against the JAX package, on the CPU.

Tolerance: exact.  The 2-to-1 case is tests/test_merkle.py's: 16 canonical
leaves from seed 3, against ``MerkleTree(inst, chunk_b=8).root`` (the same
compiled shape).  The 4-to-1 case is held against the golden model.
"""

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
