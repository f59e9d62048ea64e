"""The arity-4 Vesta commitment (Anemoi-4-3, Jive 4-to-1) of the port
against the benchmark's plain reference (``benchmark/reference``: Python
integers, independent of the port and of the JAX package), on the CPU.

Tolerance: exact.  256 seeded canonical leaves, four levels: the returned
root against the reference's whole tree, and every node of every level
against the reference's Jive-4 of its four children.  Jive-2 and Jive-4 of
the same width-4 states through ``cuda_backend.jive_plain``.  The
benchmark cell's configuration and traffic files load, and its leaf count
is a power of 4 with 12 levels.
"""

import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.fields.params import get_instance
from anemoi_tpu_torch.merkle.tree import MerkleTree
from benchmark.reference import anemoi as ref
from benchmark.reference import work

FIELD, NAME = "vesta", "anemoi_4_3"
BENCH = Path(__file__).resolve().parent.parent / "benchmark"
N_LEAVES = 4**4


def _mont_limbs(defn, values) -> torch.Tensor:
    """Plain integers below p -> int32 [L, n] 13-bit limbs of x R mod p."""
    mont = [ref.to_mont(defn, v) for v in values]
    limbs = [[(m >> (ref.LIMB_BITS * i)) & ((1 << ref.LIMB_BITS) - 1) for m in mont] for i in range(defn.n_limbs)]
    return torch.tensor(limbs, dtype=torch.int32)


def _random(defn, n, seed) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % defn.p for _ in range(n)]


def _ints(x) -> list:
    return ref.limbs_to_ints(x.numpy())


@lru_cache(maxsize=None)
def _tree():
    """(leaves as Montgomery ints, the root, every level) of the port's tree."""
    defn = ref.instance(FIELD, NAME)
    leaves = _mont_limbs(defn, _random(defn, N_LEAVES, 22))
    root, levels = MerkleTree(get_instance(FIELD, NAME), device="cpu").root(leaves, return_levels=True)
    return _ints(leaves), root, levels


def test_root_matches_the_reference_tree():
    leaves, root, levels = _tree()
    assert tuple(root.shape) == (ref.instance(FIELD, NAME).n_limbs, 1) and len(levels) == 5
    ((want, _lazy),) = work.run(("tree", FIELD, NAME, 4, 4, leaves))
    assert _ints(root) == want == _ints(levels[-1])


@pytest.mark.parametrize("lv", [1, 2, 3, 4])
def test_every_node_is_the_jive4_of_its_children(lv):
    _, _, levels = _tree()
    below, got = _ints(levels[lv - 1]), _ints(levels[lv])
    assert len(got) == N_LEAVES // 4**lv
    states = [below[4 * j:4 * j + 4] for j in range(len(got))]
    assert [want for want, _lazy in work.run(("jive", FIELD, NAME, 4, states))] == [[g] for g in got]


@pytest.mark.parametrize("k", [2, 4])
def test_jive_plain_matches_the_reference_at_width_4(k):
    defn = ref.instance(FIELD, NAME)
    n = 8
    elems = _random(defn, 4 * n, 40 + k)  # element w of state i at 4 i + w
    x = torch.cat([_mont_limbs(defn, elems[w::4]) for w in range(4)], dim=0)
    out = cuda_backend.jive_plain(get_instance(FIELD, NAME), k, x)
    L, c = defn.n_limbs, 4 // k
    assert tuple(out.shape) == (c * L, n)
    got = [_ints(out[i * L:(i + 1) * L]) for i in range(c)]
    want = work.run(("jive", FIELD, NAME, k, [[ref.to_mont(defn, e) for e in elems[4 * i:4 * i + 4]]
                                              for i in range(n)]))
    assert [[got[i][s] for i in range(c)] for s in range(n)] == [w for w, _lazy in want]


def test_the_benchmark_cell_files_load():
    cfg = json.loads((BENCH / "configs" / "vesta_4_3.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "root_2p24_arity4.json").read_text())
    assert (cfg["field"], cfg["instance"], cfg["reduced"]) == (FIELD, NAME, [])
    defn = ref.instance(cfg["field"], cfg["instance"])
    assert (defn.width, defn.columns, defn.rounds, defn.digest_size) == (4, 2, 14, 1)
    assert traffic["entry"] == "merkle_root" and traffic["input_sets"] == 2 and traffic["warmup_calls"] == 1
    n, sub = traffic["leaves"], traffic["check"]["subtree_leaves"]
    assert n == 16_777_216 == 4**12 and sub == 4**5
    tree = MerkleTree(get_instance(FIELD, NAME), device="cpu")
    assert (tree.arity, tree.k) == (4, 4)
    assert tree.num_levels(n) == 12 and tree.num_levels(sub) == 5
