"""``MerkleTree(inst).root(leaves, return_levels=True)`` over ``leaves``
canonical Montgomery leaves.  The check recomputes ``check.nodes_per_level``
nodes of every level (the first and last 8 among them) from their children
in the level below: level 1 from the benchmark's own leaves, above it from
the program's level; the root the call returns, from the top level's
children; and two whole subtrees of ``check.subtree_leaves`` leaves at
both ends, from the leaves alone."""

import numpy as np

from benchmark import roofline
from benchmark.generator import Entry, canonical, generator, host_ints, sample, sample_rng

CHUNK = 64  # nodes a reference task


def build(torch, att, defn, traffic, seed, device) -> Entry:
    tree = att.MerkleTree(att.get_instance(defn.field, defn.name), device=device)
    L, n, sets = defn.n_limbs, traffic["leaves"], traffic["input_sets"]
    arity, k = defn.width, defn.width // defn.digest_size
    n_levels = tree.num_levels(n)
    leaves = [canonical(torch, generator(torch, seed, i, device), (L, n), L, defn.bits, device)
              for i in range(sets)]
    check = traffic["check"]
    rng = sample_rng(seed, 1 << 21)
    nodes = [[sample(rng, n // arity**lv, 8, check["nodes_per_level"]) for lv in range(n_levels + 1)]
             for _ in range(sets)]
    sub = check["subtree_leaves"]
    sub_level = tree.num_levels(sub)
    if sub > n:
        raise ValueError("subtree_leaves must not pass the leaves")
    names = (defn.field, defn.name)

    def tasks(i, out):
        root, levels = out
        ts, answers = [], []
        below = leaves[i]
        for lv in range(1, n_levels + 1):
            js = nodes[i][lv]
            kids = host_ints(below, (arity * js[:, None] + np.arange(arity)).reshape(-1))
            got = host_ints(levels[lv], js)
            for a in range(0, len(js), CHUNK):
                ts.append(("jive", *names, k, [kids[arity * b:arity * (b + 1)] for b in range(a, min(a + CHUNK, len(js)))]))
                answers.append([[g] for g in got[a:a + CHUNK]])
            below = levels[lv]
        # the returned root, apart from the kept top level
        ts.append(("jive", *names, k, [host_ints(levels[n_levels - 1], np.arange(arity))]))
        answers.append([[host_ints(root, [0])[0]]])
        top = levels[sub_level]
        for first, node in ((0, 0), (n - sub, top.shape[1] - 1)):
            ts.append(("tree", *names, arity, k, host_ints(leaves[i], np.arange(first, first + sub))))
            answers.append([[host_ints(top, [node])[0]]])
        return ts, answers

    hashes = (n - 1) // (arity - 1)
    return Entry(sets, lambda i: tree.root(leaves[i], return_levels=True), {"roots": 1, "hashes": hashes},
                 {"jive": roofline.jive(defn, hashes, k)}, tasks, "nodes")
