"""The port's sharded Merkle forest and Jive over two gloo ranks, on the CPU.

Tolerance: exact.  Two processes (each imports only the port) join a
gloo group through a ``file://`` store in a temporary directory, with a
timeout of their own.  Over the 16 leaves of tests/test_dist.py's forest
(8 a rank) their root must equal the JAX package's ``MerkleTree.root``
(``chunk_b=8``, the shape tests/test_torch_merkle.py compiles) and a
golden reduction, on both ranks; ``sharded_jive_fn`` over 16 states (8 a
rank) must equal the golden model's Jive; ``collective_traffic`` of a
2-leaf forest must count one all-gather of the two roots.  The argument
checks run in the test's own process.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.ff.limb_ops import encode_ints as j_encode_ints
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.merkle.tree import MerkleTree as JMerkleTree
from anemoi_tpu_torch.ff.limb_ops import decode_ints, encode_ints
from anemoi_tpu_torch.fields.params import get_instance
from anemoi_tpu_torch.modes.batched import decode_states, encode_states

ROOT = Path(__file__).resolve().parent.parent
RANKS = 2
TIMEOUT = 240  # seconds for the two ranks together

RANK_CODE = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    from anemoi_tpu_torch.dist import forest, mesh
    from anemoi_tpu_torch.fields.params import get_instance

    store, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    mesh.initialize_distributed(init_method=store, world_size=world, rank=rank, device="cpu", timeout=120)
    m = mesh.chip_mesh(world, device="cpu")
    inst = get_instance("vesta", "anemoi_2_1")
    leaves = np.load(f"{tmp}/leaves.npy")
    root = forest.sharded_merkle_root_fn(inst, m, leaves.shape[1], chunk_b=8)(mesh.shard_batch(leaves, m))
    states = np.load(f"{tmp}/states.npy")
    jive = forest.sharded_jive_fn(inst, m)(mesh.shard_batch(states, m))
    pair = np.load(f"{tmp}/pair.npy")
    traffic = mesh.collective_traffic(forest.sharded_merkle_root_fn(inst, m, 2), mesh.shard_batch(pair, m))
    np.save(f"{tmp}/root_{rank}.npy", root.numpy())
    np.save(f"{tmp}/jive_{rank}.npy", jive.numpy())
    with open(f"{tmp}/traffic_{rank}.json", "w") as f:
        json.dump(traffic, f)
    import torch.distributed as dist
    dist.destroy_process_group()
    """
)


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, 2**62)) for _ in range(n)]


def _golden_root(ref, leaves):
    level = list(leaves)
    while len(level) > 1:
        level = [jgolden.jive_compress(ref, level[i : i + 2])[0] for i in range(0, len(level), 2)]
    return level[0]


def test_two_rank_forest_and_jive(tmp_path):
    inst, ref = get_instance("vesta", "anemoi_2_1"), jparams.get_instance("vesta", "anemoi_2_1")
    fp = inst.field
    leaves, pair = _ints(16, 1), _ints(2, 2)
    states = [_ints(2, 10 + i) for i in range(16)]
    np.save(tmp_path / "leaves.npy", encode_ints(leaves, fp).numpy())
    np.save(tmp_path / "pair.npy", encode_ints(pair, fp).numpy())
    np.save(tmp_path / "states.npy", encode_states(inst, states, device="cpu").reshape(2 * 20, 16).numpy())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("WORLD_SIZE", None)
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, store, str(r), str(RANKS), str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(RANKS)]
    try:
        # the references, while the ranks run
        want_root = _golden_root(ref, leaves)
        jax_root = np.asarray(JMerkleTree(ref, chunk_b=8).root(j_encode_ints(leaves, jparams.get_field("vesta"))))
        want_jive = [jgolden.jive_compress(ref, s) for s in states]
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    for r in range(RANKS):
        root = np.load(tmp_path / f"root_{r}.npy")
        assert root.shape == (20, 1)
        np.testing.assert_array_equal(root, jax_root)
        assert decode_ints(root, fp) == [want_root]
    jive = np.concatenate([np.load(tmp_path / f"jive_{r}.npy") for r in range(RANKS)], axis=1)
    assert decode_states(inst, jive.reshape(1, 20, 16)) == want_jive
    traffic = json.loads((tmp_path / "traffic_0.json").read_text())
    assert traffic == {"ops": [{"op": "all-gather", "shape": "s32[2,20]", "bytes_per_device": 2 * 20 * 4}],
                       "total_bytes_per_device": 160, "counts": {"all-gather": 1}}
    assert json.loads((tmp_path / "traffic_1.json").read_text()) == traffic


def test_forest_argument_checks(tmp_path):
    """One gloo rank in this process: the reference's checks (the leaves
    split evenly, each rank's count a power of the arity), the leaves'
    shape, and a one-rank forest, which issues no collective."""
    import torch.distributed as dist

    from anemoi_tpu_torch.dist import forest, mesh

    inst = get_instance("vesta", "anemoi_2_1")
    mesh.initialize_distributed(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0, device="cpu",
                                timeout=60)
    try:
        m = mesh.chip_mesh(device="cpu")
        assert m.size() == 1 and m.mesh_dim_names == ("chips",) and mesh.batch_sharding(m)[0].dim == 1
        with pytest.raises(ValueError):
            mesh.chip_mesh(2, device="cpu")
        with pytest.raises(ValueError):
            forest.sharded_merkle_root_fn(inst, m, 6)  # 6 leaves: not a power of 2
        leaves = mesh.shard_batch(encode_ints(_ints(2, 3), inst.field), m)
        with pytest.raises(ValueError):
            forest.sharded_merkle_root_fn(inst, m, 2)(leaves[:, :1])
        one = forest.sharded_merkle_root_fn(inst, m, 1)
        assert mesh.collective_traffic(one, leaves[:, :1]) == {"ops": [], "total_bytes_per_device": 0, "counts": {}}
        assert (one(leaves[:, 1:]) == leaves[:, 1:]).all()
    finally:
        dist.destroy_process_group()
