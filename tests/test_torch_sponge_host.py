"""The permutation and sponge kernels' own per-lane code, built for the host
with g++: csrc/sponge.cu's permute_lane and sponge_lane against the port's
golden model and the SAGE hash_field / hash_bytes vectors of all seven
fields, at 8 and 12 words, including whole 10 KB messages (331 elements of
31 bytes for Vesta, 218 of 47 bytes for BLS12-381).  The sponge kernel runs
sponge_group, each message on a group of four lanes, and the four-lane
permutation kernel permute_group: here the same templates over the
HostLanes policy (field32_group.cuh), which holds the four lanes in one
object, are held against the same vectors and messages, the golden model's
permutation of all 14 instances and, for Vesta and BLS12-381 anemoi_4_3,
the JAX package (Vesta's through its jit-compiled permutation_fn).

sponge.cu is __host__ __device__ outside its kernels, so this checks the
very code the kernels are compiled from, without a card, with the
constants as ``cuda_backend.consts_words`` lays them out.  Tolerance:
exact (integer arithmetic, canonical limbs).
"""

import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.permutation.batched import permutation_fn as jax_permutation_fn
from anemoi_tpu_torch.ff import cuda_backend, golden, native
from anemoi_tpu_torch.ff.limb_ops import decode_ints, encode_ints, random_canonical
from anemoi_tpu_torch.fields.params import FIELD_NAMES, INSTANCE_NAMES, get_instance, int_from_limbs

from .vector_loader import load_vectors

_SHIM = r"""
#include <stddef.h>
#include "sponge.cu"
// the kernels' per-thread work, lane by lane, on limb-major int32 arrays
// x^(1/alpha)'s window table: a local array with stride 1, where the
// kernel gives each thread its shared-memory slots with stride BLOCK
template <int NW> void permute_n(int32_t* out, const int32_t* in, int n, int width, const uint32_t* consts) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    uint32_t tab[INV_ALPHA_TABLE * NW];
    for (int i = 0; i < n; ++i) {
        if (width == 2) permute_lane<2, NW>(out + i, in + i, (size_t)n, c, tab, 1);
        else permute_lane<4, NW>(out + i, in + i, (size_t)n, c, tab, 1);
    }
}
template <int NW> void sponge_n(int32_t* out, const int32_t* in, int n, int width, int E, const uint32_t* consts) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    uint32_t tab[INV_ALPHA_TABLE * NW];
    for (int i = 0; i < n; ++i) {
        if (width == 2) sponge_lane<2, NW>(out + i, in + i, (size_t)n, E, c, tab, 1);
        else sponge_lane<4, NW>(out + i, in + i, (size_t)n, E, c, tab, 1);
    }
}
template <int NW> void gpermute_n(int32_t* out, const int32_t* in, int n, int width, const uint32_t* consts,
                                  int store) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    for (int i = 0; i < n; ++i) {
        if (width == 2) permute_group<2, NW, HostLanes>(out + i, in + i, (size_t)n, store != 0, c);
        else permute_group<4, NW, HostLanes>(out + i, in + i, (size_t)n, store != 0, c);
    }
}
template <int NW> void gsponge_n(int32_t* out, const int32_t* in, int n, int width, int E, const uint32_t* consts,
                                int store) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    for (int i = 0; i < n; ++i) {
        if (width == 2) sponge_group<2, NW, HostLanes>(out + i, in + i, (size_t)n, E, store != 0, c);
        else sponge_group<4, NW, HostLanes>(out + i, in + i, (size_t)n, E, store != 0, c);
    }
}
extern "C" {
void t_permute(int32_t* out, const int32_t* in, int n, int width, int words, const uint32_t* consts) {
    if (words == 8) permute_n<8>(out, in, n, width, consts);
    else permute_n<12>(out, in, n, width, consts);
}
void t_sponge(int32_t* out, const int32_t* in, int n, int width, int E, int words, const uint32_t* consts) {
    if (words == 8) sponge_n<8>(out, in, n, width, E, consts);
    else sponge_n<12>(out, in, n, width, E, consts);
}
// permute_group over HostLanes: one group of four lanes per state; a group
// with store == 0 writes nothing
void t_gpermute(int32_t* out, const int32_t* in, int n, int width, int words, const uint32_t* consts, int store) {
    if (words == 8) gpermute_n<8>(out, in, n, width, consts, store);
    else gpermute_n<12>(out, in, n, width, consts, store);
}
// sponge_group over HostLanes: one group of four lanes per message; a
// group with store == 0 writes nothing
void t_gsponge(int32_t* out, const int32_t* in, int n, int width, int E, int words, const uint32_t* consts, int store) {
    if (words == 8) gsponge_n<8>(out, in, n, width, E, consts, store);
    else gsponge_n<12>(out, in, n, width, E, consts, store);
}
int t_consts_words(int words) {
    return words == 8 ? (int)(sizeof(AnemoiConsts<8>) / 4) : (int)(sizeof(AnemoiConsts<12>) / 4);
}
}
"""

FULL_BYTES = 10 * 1024  # bench.py's 10 KB message: 331 elements of 31 bytes, or 218 of 47


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("sponge")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libsponge.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(cuda_backend._build.CSRC), "-o", str(so),
         str(d / "shim.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.t_permute.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.t_sponge.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p]
    lib.t_gsponge.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.t_gpermute.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int]
    lib.t_consts_words.argtypes = [ctypes.c_int]
    return lib


def _host_sponge(lib, inst, msgs, group=False):
    """sponge_lane (or, with `group`, sponge_group over four host lanes) over
    equal-length messages of plain ints -> digests as ints."""
    E, B = len(msgs[0]), len(msgs)
    L = inst.field.n_limbs
    x = np.zeros((E, L, B), np.int32)
    for e in range(E):
        x[e] = encode_ints([m[e] for m in msgs], inst.field).numpy()
    out = np.zeros((L, B), np.int32)
    words = cuda_backend.consts_words(inst)
    args = (out.ctypes.data, np.ascontiguousarray(x.reshape(E * L, B)).ctypes.data, B, inst.width, E,
            inst.field.kernel_words, words.ctypes.data)
    if group:
        lib.t_gsponge(*args, 1)
    else:
        lib.t_sponge(*args)
    assert out.min() >= 0 and out.max() < 1 << 13
    return decode_ints(out, inst.field)


def _message_ints(inst, data):
    return [int_from_limbs(row) for row in native.pack_bytes(data, inst.field)]


def test_consts_layout(lib):
    for nw, field in ((8, "vesta"), (12, "bls12_381")):
        assert lib.t_consts_words(nw) == len(cuda_backend.consts_words(get_instance(field, "anemoi_4_3")))


@pytest.mark.parametrize("field", FIELD_NAMES)
@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_sponge_vectors(lib, field, iname):
    """Every length of the vectors, E < rate among them: sponge_lane takes
    any E, though the wrappers send it E >= rate only."""
    inst = get_instance(field, iname)
    vec = load_vectors(field, iname)
    for elems, want in zip(vec["hash_field"]["input"], vec["hash_field"]["output"]):
        assert _host_sponge(lib, inst, [[e % inst.field.p for e in elems]]) == [want[0]], elems
    chunk = inst.field.byte_chunk
    for elems, want in zip(vec["hash_bytes"]["input"], vec["hash_bytes"]["output"]):
        data = b"".join(int(e).to_bytes(chunk, "little") for e in elems)
        assert _host_sponge(lib, inst, [_message_ints(inst, data)]) == [want[0]]


@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_sponge_matches_golden(lib, iname):
    """Lengths 0 to 7 (tail 0, 1 and 2, sigma on either side), a few lanes
    each, and the empty message, whose digest is 0."""
    inst = get_instance("pallas", iname)
    rng = np.random.default_rng(21)
    for E in range(8):
        msgs = [[int.from_bytes(rng.bytes(40), "little") % inst.field.p for _ in range(E)] for _ in range(3)]
        if E == 0:
            out = np.zeros((20, 3), np.int32)
            lib.t_sponge(out.ctypes.data, out.ctypes.data, 3, inst.width, 0, 8,
                         cuda_backend.consts_words(inst).ctypes.data)
            assert decode_ints(out, inst.field) == [0, 0, 0]
            continue
        assert _host_sponge(lib, inst, msgs) == [golden.hash_field(inst, m)[0] for m in msgs], E


@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_sponge_full_message(lib, iname):
    """A whole 10 KB message, the bench's size: 331 elements."""
    inst = get_instance("vesta", iname)
    data = np.random.default_rng(22).bytes(FULL_BYTES)
    elems = _message_ints(inst, data)
    assert len(elems) == 331
    assert _host_sponge(lib, inst, [elems]) == golden.hash_bytes(inst, data)


@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_sponge_full_message_12_words(lib, iname):
    """A whole 10 KB BLS12-381 message at 12 words: 218 elements of 47
    bytes (73 permutations for 4_3, 218 for 2_1)."""
    inst = get_instance("bls12_381", iname)
    data = np.random.default_rng(24).bytes(FULL_BYTES)
    elems = _message_ints(inst, data)
    assert len(elems) == 218
    assert _host_sponge(lib, inst, [elems]) == golden.hash_bytes(inst, data)


@pytest.mark.parametrize("field", ["vesta", "bn_254", "bls12_377", "bls12_381"])
@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_permute_matches_golden(lib, field, iname):
    inst = get_instance(field, iname)
    W, L = inst.width, inst.field.n_limbs
    x = random_canonical(inst.field, (W, 5), np.random.default_rng(23)).transpose(1, 0, 2)  # (W, L, 5)
    x[:, :, 0] = 0
    x = np.ascontiguousarray(x.reshape(W * L, 5))
    out = np.zeros_like(x)
    lib.t_permute(out.ctypes.data, x.ctypes.data, 5, W, inst.field.kernel_words,
                  cuda_backend.consts_words(inst).ctypes.data)
    states = [decode_ints(x.reshape(W, L, 5)[w], inst.field) for w in range(W)]
    got = [decode_ints(out.reshape(W, L, 5)[w], inst.field) for w in range(W)]
    for b in range(5):
        assert [got[w][b] for w in range(W)] == golden.permutation(inst, [states[w][b] for w in range(W)])


@pytest.mark.parametrize("field", FIELD_NAMES)
@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_group_sponge_vectors(lib, field, iname):
    """sponge_group, the code of the four-lane sponge kernel, on every SAGE
    hash_field and hash_bytes vector of all seven fields."""
    inst = get_instance(field, iname)
    vec = load_vectors(field, iname)
    for elems, want in zip(vec["hash_field"]["input"], vec["hash_field"]["output"]):
        assert _host_sponge(lib, inst, [[e % inst.field.p for e in elems]], group=True) == [want[0]], elems
    chunk = inst.field.byte_chunk
    for elems, want in zip(vec["hash_bytes"]["input"], vec["hash_bytes"]["output"]):
        data = b"".join(int(e).to_bytes(chunk, "little") for e in elems)
        assert _host_sponge(lib, inst, [_message_ints(inst, data)], group=True) == [want[0]]


@pytest.mark.parametrize("field", ["pallas", "bls12_377"])
@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_group_sponge_matches_golden(lib, field, iname):
    """sponge_group at 8 and 12 words, lengths 1 to 7 (tail 0, 1 and 2,
    sigma on either side) on a few messages; a group that must not store
    (a group past the ragged edge on the card) leaves the output alone."""
    inst = get_instance(field, iname)
    rng = np.random.default_rng(25)
    nbytes = 8 * inst.field.kernel_words
    for E in range(1, 8):
        msgs = [[int.from_bytes(rng.bytes(nbytes), "little") % inst.field.p for _ in range(E)] for _ in range(3)]
        assert _host_sponge(lib, inst, msgs, group=True) == [golden.hash_field(inst, m)[0] for m in msgs], E
    L = inst.field.n_limbs
    x = random_canonical(inst.field, (4, 2), rng).transpose(1, 0, 2).reshape(4 * L, 2).copy()
    out = np.full((L, 2), -1, np.int32)
    lib.t_gsponge(out.ctypes.data, x.ctypes.data, 2, inst.width, 4, inst.field.kernel_words,
                  cuda_backend.consts_words(inst).ctypes.data, 0)
    assert (out == -1).all()


@pytest.mark.parametrize("field,iname,elements", [("vesta", "anemoi_4_3", 331), ("vesta", "anemoi_2_1", 331),
                                                  ("bls12_381", "anemoi_4_3", 218)])
def test_host_group_sponge_full_message(lib, field, iname, elements):
    """sponge_group over a whole 10 KB message, the bench's size, exact
    against the golden model: 111, 331 and 73 permutations."""
    inst = get_instance(field, iname)
    data = np.random.default_rng(26).bytes(FULL_BYTES)
    elems = _message_ints(inst, data)
    assert len(elems) == elements
    assert _host_sponge(lib, inst, [elems], group=True) == golden.hash_bytes(inst, data)


def _host_group_permute(lib, inst, x, store=1, out=None):
    """permute_group over four host lanes, the code of the four-lane
    permutation kernel, on int32 [WIDTH*L, N] limbs."""
    x = np.ascontiguousarray(x, dtype=np.int32)
    out = np.zeros_like(x) if out is None else out
    lib.t_gpermute(out.ctypes.data, x.ctypes.data, x.shape[1], inst.width, inst.field.kernel_words,
                   cuda_backend.consts_words(inst).ctypes.data, store)
    return out


@pytest.mark.parametrize("field", FIELD_NAMES)
@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_group_permute_matches_golden(lib, field, iname):
    """permute_group on 8 states of every instance (the zero state among
    them) against the golden model; a group that must not store (past the
    ragged edge on the card) leaves the output alone."""
    inst = get_instance(field, iname)
    W, L = inst.width, inst.field.n_limbs
    x = random_canonical(inst.field, (W, 8), np.random.default_rng(27)).transpose(1, 0, 2)  # (W, L, 8)
    x[:, :, 0] = 0
    x = x.reshape(W * L, 8)
    out = _host_group_permute(lib, inst, x)
    assert out.min() >= 0 and out.max() < 1 << 13
    states = [decode_ints(x.reshape(W, L, 8)[w], inst.field) for w in range(W)]
    got = [decode_ints(out.reshape(W, L, 8)[w], inst.field) for w in range(W)]
    for b in range(8):
        assert [got[w][b] for w in range(W)] == golden.permutation(inst, [states[w][b] for w in range(W)])
    untouched = np.full_like(x, -1)
    assert (_host_group_permute(lib, inst, x, store=0, out=untouched) == -1).all()


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_host_permutations_match_jax(lib, field):
    """permute_group (the four-lane kernel's code) and permute_lane (the
    one-thread kernel's, with the window) on the same 8 random canonical
    anemoi_4_3 states, made with numpy, against the JAX package: for Vesta
    its permutation_fn, jit-compiled on the CPU as its own tests run it
    (about 95 s of XLA compile, cold); for BLS12-381 its golden model, since
    XLA takes about 250 s to compile the 30-limb permutation_fn."""
    inst = get_instance(field, "anemoi_4_3")
    ref = jparams.get_instance(field, "anemoi_4_3")
    W, L = inst.width, inst.field.n_limbs
    x = np.ascontiguousarray(random_canonical(inst.field, (W, 8), np.random.default_rng(28)).transpose(1, 0, 2))
    if field == "vesta":
        want = np.asarray(jax.jit(jax_permutation_fn(ref))(x)).reshape(W * L, 8)
    else:
        states = [decode_ints(x[w], inst.field) for w in range(W)]
        after = [jgolden.permutation(ref, [states[w][b] for w in range(W)]) for b in range(8)]
        want = np.stack([encode_ints([after[b][w] for b in range(8)], inst.field).numpy() for w in range(W)])
        want = want.reshape(W * L, 8)
    x = x.reshape(W * L, 8)
    np.testing.assert_array_equal(_host_group_permute(lib, inst, x), want)
    out = np.zeros_like(x)
    lib.t_permute(out.ctypes.data, x.ctypes.data, 8, W, inst.field.kernel_words,
                  cuda_backend.consts_words(inst).ctypes.data)
    np.testing.assert_array_equal(out, want)
