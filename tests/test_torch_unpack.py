"""The byte route of the port on the CPU: the host's buckets and gather
(``modes/bytes_pipeline.py``) and the unpack of joined bytes into
Montgomery limbs (``cuda_backend.unpack``: its plain version here, and the
kernel's per-thread code from ``csrc/unpack.cu`` built with g++), for all
seven fields.

Tolerance: exact.  The reference for the limbs is the native packer
(``native.pack_bytes``, ``native/anemoi_host.cpp``) followed by
``limb_ops.to_mont``; for the digests, the JAX package's golden model, with
the sponge's plain version replaced by the native oracle
(``test_torch_bench.ORACLE``) so that 10 KB messages take milliseconds.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.fields import params as jparams
from anemoi_tpu_torch._build import CSRC
from anemoi_tpu_torch.ff import cuda_backend, native
from anemoi_tpu_torch.ff import limb_ops as lo
from anemoi_tpu_torch.fields.params import FIELD_NAMES, INSTANCE_NAMES, get_instance
from anemoi_tpu_torch.modes.batched import decode_states
from anemoi_tpu_torch.modes.bytes_pipeline import (
    bucket_messages,
    gather_messages,
    hash_bytes_batch,
    hash_bytes_mixed,
)
from tests.test_torch_bench import ORACLE

LENGTHS = {"0": lambda c: 0, "1": lambda c: 1, "chunk-1": lambda c: c - 1, "chunk": lambda c: c,
           "chunk+1": lambda c: c + 1, "10240": lambda c: 10_240}

_SHIM = r"""
#include "unpack.cu"
// the kernel's per-thread work over every (element, message) of a bucket
template <int NW> void unpack_n(int32_t* out, const uint8_t* data, const long long* spans, long long n,
                                long long elements, int chunk, int limbs, const uint32_t* consts) {
    const UnpackConsts<NW>& c = *(const UnpackConsts<NW>*)consts;
    for (long long e = 0; e < elements; ++e)
        for (long long b = 0; b < n; ++b) {
            const long long pos = e * chunk, rest = spans[n + b] - pos;
            unpack_element<NW>(out + e * limbs * n + b, (size_t)n, data + spans[b] + pos, rest < chunk ? rest : chunk,
                               chunk, limbs, c);
        }
}
extern "C" void t_unpack(int32_t* out, const uint8_t* data, const long long* spans, long long n, long long elements,
                         int chunk, int limbs, int words, const uint32_t* consts) {
    if (words == 8) unpack_n<8>(out, data, spans, n, elements, chunk, limbs, consts);
    else unpack_n<12>(out, data, spans, n, elements, chunk, limbs, consts);
}
extern "C" int t_consts_words(int words) {
    return words == 8 ? (int)(sizeof(UnpackConsts<8>) / 4) : (int)(sizeof(UnpackConsts<12>) / 4);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("unpack")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libunpack.so"
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "shim.cpp")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.fixture
def oracle(monkeypatch):
    for name, fn in ORACLE.items():
        monkeypatch.setattr(cuda_backend, name, fn)


def _msgs(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in lens]


def _native(inst, messages) -> np.ndarray:
    """The reference: the native packer, stacked to [E, L, B], then to_mont."""
    packed = np.stack([native.pack_bytes(m, inst.field) for m in messages])  # [B, E, L]
    B, E, L = packed.shape
    x = torch.from_numpy(np.ascontiguousarray(packed.transpose(2, 1, 0).reshape(L, E * B)))
    return lo.to_mont(x, lo.field_consts(inst.field)).numpy().reshape(L, E, B).transpose(1, 0, 2)


def _unpacked(inst, messages) -> dict:
    """The route's host half on the CPU: bucket, gather, plain unpack; E ->
    (the bucket's indices, int32 [E, L, B])."""
    lengths, buckets = bucket_messages(inst, messages)
    out = {}
    for E, idxs in buckets.items():
        data, spans = gather_messages(messages, lengths, idxs)
        out[E] = idxs, cuda_backend.unpack(inst, E, data, spans).numpy()
    return out


@pytest.mark.parametrize("length", list(LENGTHS))
@pytest.mark.parametrize("field", FIELD_NAMES)
def test_unpack_matches_native(field, length):
    inst = get_instance(field, "anemoi_2_1")
    msgs = _msgs([LENGTHS[length](inst.field.byte_chunk)] * 3, 61)
    (E, (idxs, got)), = _unpacked(inst, msgs).items()
    assert E == native.num_elements(len(msgs[0]), inst.field) and list(idxs) == [0, 1, 2]
    assert got.dtype == np.int32 and got.flags.c_contiguous and got.shape == (E, inst.field.n_limbs, 3)
    np.testing.assert_array_equal(got, _native(inst, msgs))


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_unpack_one_bucket_of_mixed_lengths(field):
    """Lengths 2c + 1 to 3c share E = 3; only the message of 3c bytes ends
    in a full chunk, the others in the pad byte."""
    inst = get_instance(field, "anemoi_2_1")
    c = inst.field.byte_chunk
    msgs = _msgs([2 * c + 1, 3 * c, 2 * c + 7, 3 * c - 1, 2 * c + 1], 62)
    (E, (idxs, got)), = _unpacked(inst, msgs).items()
    assert E == 3
    np.testing.assert_array_equal(got, _native(inst, msgs))


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_unpack_out_of_bucket_order(field):
    """Messages of E = 4, 1, 0, 2, 1, 4 in that order: each bucket gathers
    its messages in input order, whatever lies between them."""
    inst = get_instance(field, "anemoi_2_1")
    c = inst.field.byte_chunk
    msgs = _msgs([4 * c, 3, 0, c + 2, c, 3 * c + 1], 63)
    got = _unpacked(inst, msgs)
    assert {E: list(idxs) for E, (idxs, _) in got.items()} == {0: [2], 1: [1, 4], 2: [3], 4: [0, 5]}
    for E, (idxs, elems) in got.items():
        np.testing.assert_array_equal(elems, _native(inst, [msgs[i] for i in idxs]))


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_kernel_code_matches_plain(lib, field):
    """csrc/unpack.cu's unpack_element, the kernel's per-thread work, over
    buckets of mixed lengths (the pad byte at every offset of the last
    chunk, and none) against the plain version, with the constants as
    ``cuda_backend.unpack_consts`` lays them out."""
    inst = get_instance(field, "anemoi_2_1")
    fp = inst.field
    c, L, nw = fp.byte_chunk, fp.n_limbs, fp.kernel_words
    assert lib.t_consts_words(nw) == len(cuda_backend.unpack_consts(fp)) == 2 * nw + 1
    for E in (1, 2, 331):
        msgs = _msgs([(E - 1) * c + t for t in range(1, c + 1)], 64 + E)
        lengths, buckets = bucket_messages(inst, msgs)
        assert list(buckets) == [E]
        data, spans = gather_messages(msgs, lengths, buckets[E])
        B = len(msgs)
        out = np.full((E, L, B), -1, dtype=np.int32)
        lib.t_unpack(out.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p(data.data_ptr()),
                     ctypes.c_void_p(spans.data_ptr()), ctypes.c_longlong(B), ctypes.c_longlong(E), c, L, nw,
                     cuda_backend.unpack_consts(fp).ctypes.data_as(ctypes.c_void_p))
        np.testing.assert_array_equal(out, cuda_backend.unpack(inst, E, data, spans).numpy())
        np.testing.assert_array_equal(out, _native(inst, msgs))


@pytest.mark.parametrize("iname", INSTANCE_NAMES)
@pytest.mark.parametrize("field", FIELD_NAMES)
def test_hash_bytes_digests_match_golden(oracle, field, iname):
    """``hash_bytes_mixed`` over buckets of E = 0, 1, 2, 3 and 331, given out
    of bucket order, and ``hash_bytes_batch`` over one of them, against the
    JAX package's golden model; no unpack launch on the CPU."""
    inst, ref = get_instance(field, iname), jparams.get_instance(field, iname)
    c = inst.field.byte_chunk
    msgs = _msgs([2 * c + 3, 10_240 if c == 31 else 331 * c - 5, 0, 1, c, c + 1, 2 * c + 3, 3 * c], 65)
    before = cuda_backend.launch_counts()
    want = [jgolden.hash_bytes(ref, m) for m in msgs]
    assert decode_states(inst, hash_bytes_mixed(inst, msgs, device="cpu")) == want
    batch = [m for m in msgs if len(m) == 2 * c + 3]
    assert decode_states(inst, hash_bytes_batch(inst, batch, device="cpu")) == [want[0], want[6]]
    assert cuda_backend.launch_counts() == before
    with pytest.raises(ValueError):
        hash_bytes_batch(inst, msgs[:2], device="cpu")
