"""The port's spans (``utils/profiling.span``) on the CPU: none built
without a profiler, and under one the names and nesting the benchmark's
readers count on.

The kernels' plain versions are replaced by the native oracle
(``test_torch_bench.ORACLE``), so a root or a byte batch takes
milliseconds; the spans are the same on the plain path.  One test runs a
root on the card and skips without one.
"""

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.fields.params import get_instance
from anemoi_tpu_torch.merkle.tree import MerkleTree
from anemoi_tpu_torch.modes.async_pipeline import AsyncByteHasher
from anemoi_tpu_torch.modes.bytes_pipeline import hash_bytes_mixed
from anemoi_tpu_torch.utils import profiling
from tests.test_torch_bench import ORACLE

INST = get_instance("vesta", "anemoi_2_1")


@pytest.fixture
def oracle(monkeypatch):
    for name, fn in ORACLE.items():
        monkeypatch.setattr(cuda_backend, name, fn)


def _leaves(n, device="cpu"):
    # canonical Montgomery limbs of small values: only the spans are checked
    leaves = torch.zeros((INST.field.n_limbs, n), dtype=torch.int32)
    leaves[0] = torch.arange(n, dtype=torch.int32)
    return leaves.to(device)


def _spans(activities, fn):
    """The host's ``anemoi.*`` spans recorded while `fn` runs under the
    profiler (not their copies on the card's timeline): (name, start, end),
    in order of start."""
    with torch.profiler.profile(activities=activities) as prof:
        fn()
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith("anemoi.") and e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_builds_no_record_function(oracle, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("anemoi.a") is profiling.span("anemoi.b")
    with profiling.span("anemoi.a"):
        pass
    MerkleTree(INST, device="cpu").root(_leaves(4))
    hash_bytes_mixed(INST, [b"ab", bytes(40)], device="cpu")


def test_a_root_holds_a_level_span_a_level(oracle):
    spans = _spans([torch.profiler.ProfilerActivity.CPU],
                   lambda: MerkleTree(INST, device="cpu").root(_leaves(16), return_levels=True))
    roots = [s for s in spans if s[0] == "anemoi.merkle.root"]
    levels = [s for s in spans if s[0] == "anemoi.merkle.level"]
    assert len(roots) == 1 and len(levels) == 4
    assert all(_inside(lv, roots[0]) for lv in levels)
    assert all(a[2] <= b[1] for a, b in zip(levels, levels[1:]))  # one after another
    assert {s[0] for s in spans} == {"anemoi.merkle.root", "anemoi.merkle.level"}  # no launch on the CPU


def test_mixed_bytes_spans_a_layout_and_upload_a_bucket(oracle):
    msgs = [b"ab", bytes(range(40)), b"cd"]  # 1 and 2 elements of 31 bytes: two buckets
    spans = _spans([torch.profiler.ProfilerActivity.CPU], lambda: hash_bytes_mixed(INST, msgs, device="cpu"))
    names = [s[0] for s in spans]
    assert names == ["anemoi.bytes.hash", "anemoi.bytes.pack", "anemoi.bytes.layout", "anemoi.bytes.upload",
                     "anemoi.bytes.layout", "anemoi.bytes.upload"]
    assert all(_inside(s, spans[0]) for s in spans[1:])


def test_async_hasher_spans_a_byte_call_a_batch(oracle):
    """AsyncByteHasher takes the byte route of every byte call: a batch is
    one ``anemoi.bytes.hash`` span holding ``pack``, ``layout`` and
    ``upload``, one after another."""
    msgs = [np.random.default_rng(3).bytes(100) for _ in range(3)]
    pipe = AsyncByteHasher(INST, device="cpu")
    spans = _spans([torch.profiler.ProfilerActivity.CPU], lambda: (list(pipe.feed(msgs)), list(pipe.drain())))
    assert [s[0] for s in spans] == ["anemoi.bytes.hash", "anemoi.bytes.pack", "anemoi.bytes.layout",
                                     "anemoi.bytes.upload"]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert all(a[2] <= b[1] for a, b in zip(spans[1:], spans[2:]))


@pytest.mark.cuda
def test_a_root_on_the_card_spans_a_launch_a_level():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tree = MerkleTree(INST)
    tree.root(_leaves(1 << 10, "cuda"))  # builds and loads the library outside the trace
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    spans = _spans(acts, lambda: (tree.root(_leaves(1 << 10, "cuda")), torch.cuda.synchronize()))
    launches = [s for s in spans if s[0] == "anemoi.launch"]
    levels = [s for s in spans if s[0] == "anemoi.merkle.level"]
    assert len(launches) == len(levels) == 10
    assert all(_inside(a, lv) for a, lv in zip(launches, levels))
