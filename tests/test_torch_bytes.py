"""Byte hashing and streaming of the port on the CPU against the JAX
package: the native packer, equal-length and ragged batches of byte
messages, digest export and serialization, and the streaming sponge.

Tolerance: exact (integer arithmetic, canonical int32 arrays, bytes).
Messages come from numpy seeds; the references are the JAX package's golden
model and its ``digests_to_bytes``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.modes import batched as jbm
from anemoi_tpu_torch import _build
from anemoi_tpu_torch.ff import native
from anemoi_tpu_torch.ff.limb_ops import random_canonical
from anemoi_tpu_torch.fields.params import get_instance, int_from_limbs
from anemoi_tpu_torch.modes.batched import (
    decode_states,
    digest_export_fn,
    digests_to_bytes,
    encode_states,
    sponge_hash_batch_fn,
)
from anemoi_tpu_torch.modes.bytes_pipeline import hash_bytes_batch, hash_bytes_mixed, pack_messages
from anemoi_tpu_torch.modes.streaming import BatchedSponge

HELLO_WORLD = "25e16af3f140fc8b2b6456efb0e221d83338a6fe3fc53703cfa7de2bb09c903d"  # Vesta 2_1


def _msgs(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in lens]


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_pack_bytes_matches_golden(field):
    inst, ref = get_instance(field, "anemoi_2_1"), jparams.get_instance(field, "anemoi_2_1")
    chunk = inst.field.byte_chunk
    for data in _msgs([0, 1, chunk - 1, chunk, chunk + 1, 3 * chunk, 1000], 51):
        packed = native.pack_bytes(data, inst.field)
        assert packed.shape == (native.num_elements(len(data), inst.field), inst.field.n_limbs)
        assert [int_from_limbs(row) for row in packed] == jgolden.bytes_to_elements(ref, data)


def test_port_builds_its_own_packer():
    """The packer is the port's own build of native/anemoi_host.cpp, under
    build/; the JAX package's library in native/ is neither built nor read."""
    jax_lib = _build.ROOT / "native" / "libanemoi_host.so"
    before = jax_lib.stat().st_mtime_ns if jax_lib.exists() else None
    assert _build.BUILD_DIR in Path(native.library()._name).parents
    assert (jax_lib.stat().st_mtime_ns if jax_lib.exists() else None) == before


def test_hash_bytes_batch_matches_golden():
    inst, ref = get_instance("vesta", "anemoi_2_1"), jparams.get_instance("vesta", "anemoi_2_1")
    msgs = _msgs([40] * 3, 52)
    assert pack_messages(inst, msgs).shape == (2, 20, 3)
    got = hash_bytes_batch(inst, msgs, device="cpu")
    assert decode_states(inst, got) == [jgolden.hash_bytes(ref, m) for m in msgs]
    with pytest.raises(ValueError):
        pack_messages(inst, _msgs([40, 41], 53))


def test_hash_bytes_mixed_ragged_lengths():
    """A ragged batch in one call, the empty message among it: buckets of
    E = 0, 1 and 4, digests in input order."""
    inst, ref = get_instance("vesta", "anemoi_4_3"), jparams.get_instance("vesta", "anemoi_4_3")
    msgs = _msgs([5, 97, 100, 0, 97, 100], 54)
    out = hash_bytes_mixed(inst, msgs, device="cpu")
    assert isinstance(out, np.ndarray) and out.shape == (1, 20, 6)
    assert decode_states(inst, out) == [jgolden.hash_bytes(ref, m) for m in msgs]
    assert not out[:, :, 3].any()  # the empty message: no permutation, digest 0


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_digests_to_bytes_matches_jax(field):
    inst = get_instance(field, "anemoi_4_3")
    canon = random_canonical(inst.field, (1, 9), np.random.default_rng(55))  # (L, DIGEST, B)
    canon = np.ascontiguousarray(canon.transpose(1, 0, 2))
    canon[:, :, 0] = 0
    want = jbm.digests_to_bytes(jparams.get_instance(field, "anemoi_4_3"), canon)
    assert digests_to_bytes(inst, canon) == want
    assert digests_to_bytes(inst, torch.from_numpy(canon)) == want
    assert {len(b) for b in want} == {inst.field.digest_bytes}


def test_digest_export_and_hello_world():
    """vesta.anemoi_2_1 over b"hello world", through the batched byte path,
    the export out of Montgomery form and the serialization."""
    inst = get_instance("vesta", "anemoi_2_1")
    digests = hash_bytes_mixed(inst, [b"hello world", b""], device="cpu")
    canon = digest_export_fn(inst)(digests)
    assert canon.dtype == torch.int32 and tuple(canon.shape) == (1, 20, 2)
    assert decode_states(inst, canon, mont=False) == decode_states(inst, digests)
    got = digests_to_bytes(inst, canon)
    assert got[0].hex() == HELLO_WORLD
    assert got[1] == bytes(32)


@pytest.mark.parametrize("iname,chunks,tail", [("anemoi_4_3", [3], 1), ("anemoi_4_3", [3], 0),
                                               ("anemoi_2_1", [1, 1], 0)])
def test_streaming_matches_one_shot(iname, chunks, tail):
    """BatchedSponge over rate-aligned chunks and a tail against the one-shot
    sponge of the whole message: tail 1 (sigma at row 1, one more
    permutation), a total the rate divides (sigma in the capacity, none),
    and rate 1, which takes no tail."""
    inst, ref = get_instance("vesta", iname), jparams.get_instance("vesta", iname)
    E = sum(chunks) + tail
    rng = np.random.default_rng(56 + E)
    msgs = [[int.from_bytes(rng.bytes(40), "little") % inst.field.p for _ in range(E)] for _ in range(3)]
    x = encode_states(inst, msgs, device="cpu")  # (E, L, 3)
    sponge = BatchedSponge(inst, 3, device="cpu")
    start = 0
    for n in chunks:
        sponge.absorb(x[start:start + n])
        start += n
    got = sponge.finalize(x[start:] if tail else None)
    assert decode_states(inst, got) == [jgolden.hash_field(ref, m) for m in msgs]
    if (iname, tail) == ("anemoi_4_3", 1):
        torch.testing.assert_close(got, sponge_hash_batch_fn(inst, E, device="cpu")(x), rtol=0, atol=0)
    if inst.rate == 1:
        with pytest.raises(ValueError, match="no tail"):
            sponge.finalize(x[:1])
    else:
        with pytest.raises(ValueError, match="rate-aligned"):
            BatchedSponge(inst, 3, device="cpu").absorb(x[:1])
