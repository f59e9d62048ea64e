"""The port's AsyncByteHasher against the golden model and the JAX package's
AsyncByteHasher, on the CPU.

Tolerance: exact.  The inputs are tests/test_async_pipeline.py's (three
batches of three 70-byte Vesta 2_1 messages, the JAX jit sponge of the
same shape); the port runs its plain path (``device="cpu"``).  Results
come one batch behind the dispatch front, as canonical [DIGEST, L, B]
arrays, and in Montgomery form without ``export``.  AsyncByteHasher takes
the byte route of ``hash_bytes_mixed``, and gives its digests at 8 and 12
words (the sponge's plain version replaced by the native oracle there).
"""

import numpy as np
import pytest
import torch

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.modes.async_pipeline import AsyncByteHasher as JAsyncByteHasher
from anemoi_tpu_torch.fields.params import get_instance
from anemoi_tpu_torch.modes.async_pipeline import AsyncByteHasher
from anemoi_tpu_torch.modes.batched import digest_export_fn, digests_to_bytes
from anemoi_tpu_torch.modes.bytes_pipeline import hash_bytes_mixed

from .test_torch_bench import oracle_plain  # noqa: F401  (a fixture)


def _batches():
    rng = np.random.default_rng(9)
    return [[rng.bytes(70) for _ in range(3)] for _ in range(3)]


def _run(pipe, batches, per_feed=None):
    got = []
    for batch in batches:
        out = list(pipe.feed(batch))
        if per_feed is not None:
            per_feed.append(len(out))
        got.extend(out)
    got.extend(pipe.drain())
    return got


def test_async_pipeline_matches_golden_and_jax():
    inst, ref = get_instance("vesta", "anemoi_2_1"), jparams.get_instance("vesta", "anemoi_2_1")
    batches = _batches()
    per_feed = []
    got = _run(AsyncByteHasher(inst, device="cpu"), batches, per_feed)
    assert per_feed == [0, 1, 1]  # depth 1: each feed yields the batch it overtook
    assert len(got) == len(batches)
    for out, batch in zip(got, batches):
        assert isinstance(out, np.ndarray) and out.dtype == np.int32 and out.shape == (1, 20, 3)
        assert digests_to_bytes(inst, out) == [jgolden.digest_to_bytes(ref, jgolden.hash_bytes(ref, m))
                                               for m in batch]
    want = _run(JAsyncByteHasher(ref), batches)
    for out, w in zip(got, want):
        np.testing.assert_array_equal(out, np.asarray(w))


def test_async_pipeline_without_export():
    """export=False gives Montgomery digests; an empty batch (no element,
    no permutation) and a one-element one."""
    inst, ref = get_instance("vesta", "anemoi_2_1"), jparams.get_instance("vesta", "anemoi_2_1")
    batches = [[b"", b""], [b"a" * 31, b"b" * 31]]
    got = _run(AsyncByteHasher(inst, backend="pallas", export=False, device="cpu"), batches)
    export = digest_export_fn(inst)
    for out, batch in zip(got, batches):
        assert out.shape == (1, 20, 2)
        assert digests_to_bytes(inst, export(torch.from_numpy(out))) == [
            jgolden.digest_to_bytes(ref, jgolden.hash_bytes(ref, m)) for m in batch]


@pytest.mark.parametrize("field,iname", [("vesta", "anemoi_2_1"), ("bls12_381", "anemoi_4_3")])  # 8 and 12 words
def test_async_pipeline_matches_hash_bytes_mixed(field, iname, oracle_plain):  # noqa: F811
    """Two batches whose messages end mid-chunk (3 and 7 whole elements and
    a part of one), in Montgomery form, against ``hash_bytes_mixed`` over
    the same messages."""
    inst = get_instance(field, iname)
    c = inst.field.byte_chunk
    rng = np.random.default_rng(10)
    batches = [[rng.bytes(n * c + c // 2) for _ in range(5)] for n in (3, 7)]
    got = _run(AsyncByteHasher(inst, export=False, device="cpu"), batches)
    assert len(got) == len(batches)
    for out, batch in zip(got, batches):
        np.testing.assert_array_equal(out, hash_bytes_mixed(inst, batch, device="cpu"))
