"""The unpack kernel (``csrc/unpack.cu``) on the card: against its plain
version at 8 and 12 words, its launch count, and ``hash_bytes_mixed`` on
the card against the CPU route and the port's golden model.  Skips without
a card; imports no JAX, so it runs on the chip as
``python3 -m pytest -o addopts="" --noconftest -q tests/test_torch_unpack_card.py``.
"""

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.ff import cuda_backend, golden
from anemoi_tpu_torch.fields.params import get_instance
from anemoi_tpu_torch.modes.batched import decode_states
from anemoi_tpu_torch.modes.bytes_pipeline import bucket_messages, gather_messages, hash_bytes_mixed
from tests.test_torch_bench import ORACLE


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["vesta", "bls12_381"])  # 8 and 12 words
def test_unpack_kernel_matches_plain_on_card(card, field):
    """E = 331 over 517 messages (not a multiple of the 256-thread block),
    their lengths spread over every length of the last chunk."""
    inst = get_instance(field, "anemoi_2_1")
    c, E, B = inst.field.byte_chunk, 331, 517
    rng = np.random.default_rng(71)
    msgs = [rng.bytes((E - 1) * c + 1 + i % c) for i in range(B)]
    lengths, buckets = bucket_messages(inst, msgs)
    assert list(buckets) == [E]
    data, spans = gather_messages(msgs, lengths, buckets[E])
    before = cuda_backend.unpack.launches
    got = cuda_backend.unpack(inst, E, data.to(card), spans.to(card))
    assert cuda_backend.unpack.launches == before + 1
    assert got.is_contiguous() and got.shape == (E, inst.field.n_limbs, B)
    np.testing.assert_array_equal(got.cpu().numpy(), cuda_backend.unpack_plain(inst, E, data, spans).numpy())


@pytest.mark.cuda
def test_mixed_buckets_on_card_match_the_cpu(card, monkeypatch):
    """Buckets of E = 0, 1, 2, 4 and 7 in one call: one unpack launch a
    bucket with elements, and the CPU route's digests (its gather and plain
    unpack, the sponge's plain version replaced by the native oracle, which
    the card's route never calls)."""
    for name, fn in ORACLE.items():
        monkeypatch.setattr(cuda_backend, name, fn)
    inst = get_instance("vesta", "anemoi_2_1")
    rng = np.random.default_rng(72)
    msgs = [rng.bytes(n) for n in (100, 5, 0, 40, 31, 200, 97, 62)]
    buckets = bucket_messages(inst, msgs)[1]
    assert sorted(buckets) == [0, 1, 2, 4, 7]
    before = cuda_backend.launch_counts()
    got = hash_bytes_mixed(inst, msgs)
    after = cuda_backend.launch_counts()
    assert after["unpack"] - before["unpack"] == 4 and after["sponge"] - before["sponge"] == 4
    np.testing.assert_array_equal(got, hash_bytes_mixed(inst, msgs, device="cpu"))
    assert decode_states(inst, got) == [golden.hash_bytes(inst, m) for m in msgs]
