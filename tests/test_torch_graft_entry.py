"""The port's entry point and dry run (``anemoi_tpu_torch/graft_entry.py``) on the CPU.

Tolerance: exact.  ``entry(device="cpu")``'s function runs the plain
PyTorch Jive on its canonical example of 256 Vesta 2_1 states; all 256
lanes must equal the JAX package's golden model.  Its first 4 lanes go
through the JAX package's compiled ``jive_compress_batch_fn`` in
tests/test_torch_jive.py, which compiles that shape already.
``dryrun_multichip`` runs on two gloo ranks of their own, whose root must
equal the one-process root, and on a one-rank group of this process, with
the plain versions replaced by the native oracle (test_torch_bench.py).
"""

import pytest
import torch

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.fields import params as jparams
from anemoi_tpu_torch import graft_entry
from anemoi_tpu_torch.modes.batched import decode_states

from .test_torch_bench import oracle_plain, oracle_ranks  # noqa: F401  (fixtures)


def test_entry_matches_golden_and_jax_on_the_cpu():
    """The JAX side of the name: tests/test_torch_jive.py::test_plain_jive_matches_jax."""
    fn, (example,) = graft_entry.entry(device="cpu")
    assert example.dtype == torch.int32 and tuple(example.shape) == (2, 20, 256) and example.device.type == "cpu"
    inst = jparams.get_instance("vesta", "anemoi_2_1")
    states = decode_states(inst, example)
    assert all(0 <= v < inst.field.p for s in states for v in s)  # canonical, unlike __graft_entry__.py's limbs
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the suite's workers share the host's cores: many threads a worker oversubscribe them
    try:
        out = fn(example)
    finally:
        torch.set_num_threads(threads)
    assert tuple(out.shape) == (1, 20, 256)
    assert decode_states(inst, out) == [jgolden.jive_compress(inst, s) for s in states]


def test_entry_needs_a_card_or_the_cpu():
    with pytest.raises(RuntimeError):
        graft_entry.entry()


def test_dryrun_multichip_two_gloo_ranks(oracle_plain, oracle_ranks):
    graft_entry.dryrun_multichip(2)


def test_dryrun_multichip_inside_a_group(tmp_path, oracle_plain):
    """In a process group, the dry run runs on its ranks: here one gloo rank."""
    import torch.distributed as dist

    from anemoi_tpu_torch.dist import mesh

    mesh.initialize_distributed(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0, device="cpu",
                                timeout=60)
    try:
        graft_entry.dryrun_multichip(1)
        with pytest.raises(ValueError):
            graft_entry.dryrun_multichip(2)  # a mesh of 2 needs 2 ranks
    finally:
        dist.destroy_process_group()
