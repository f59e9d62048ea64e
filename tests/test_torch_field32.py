"""The CUDA kernels' arithmetic, built for the host with g++: the field
operations of csrc/field32.cuh at 8 and 12 words against Python ints, and
the per-state Jive of csrc/jive.cu against the SAGE vectors and the plain
path, for all seven fields.

Both sources are __host__ __device__ outside the kernel itself, so this
checks the very code the kernels are compiled from, without a card:
Montgomery product and square, add, sub, the conversions between the
13-bit-limb form (R = 2^260 or 2^390) and the kernel's word form (R' =
2^256 or 2^384), and the rounds, ladder and feed-forward sum with the
constants as ``cuda_backend.consts_words`` lays them out.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from anemoi_tpu_torch._build import CSRC
from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.ff.limb_ops import random_canonical
from anemoi_tpu_torch.fields.params import (
    FIELD_NAMES,
    FIELDS_20,
    FIELDS_30,
    INSTANCE_NAMES,
    get_field,
    get_instance,
    int_from_limbs,
    limbs_from_int,
    words_from_int,
)
from anemoi_tpu_torch.modes.batched import decode_states, encode_states

from .vector_loader import load_vectors

_SHIM = r"""
#include <stddef.h>
#include "jive.cu"
// each function takes the word count of its field (8 or 12) and runs the
// template of that count over n values
#define BY_WORDS(f, ...) (words == 8 ? f<8>(__VA_ARGS__) : f<12>(__VA_ARGS__))
template <int W> void mul_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p, uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_mont_mul<W>(r + W * i, a + W * i, b + W * i, p, n0);
}
template <int W> void sqr_n(uint32_t* r, const uint32_t* a, int n, const uint32_t* p, uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_mont_sqr<W>(r + W * i, a + W * i, p, n0);
}
template <int W> void add_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p) {
    for (int i = 0; i < n; ++i) f32_add<W>(r + W * i, a + W * i, b + W * i, p);
}
template <int W> void sub_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p) {
    for (int i = 0; i < n; ++i) f32_sub<W>(r + W * i, a + W * i, b + W * i, p);
}
template <int W> void from_limbs_n(uint32_t* r, const int32_t* limbs, int n, const uint32_t* c_in, const uint32_t* p,
                                   uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_from_limbs<W>(r + W * i, limbs + i, (size_t)n, c_in, p, n0);
}
template <int W> void to_limbs_n(int32_t* limbs, const uint32_t* a, int n, const uint32_t* c_out, const uint32_t* p,
                                 uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_to_limbs<W>(limbs + i, (size_t)n, a + W * i, c_out, p, n0);
}
// the window table of x^(1/alpha): a local array with stride 1, where the
// kernel gives each thread its shared-memory slots with stride BLOCK
template <int NW> void jive_n(int32_t* out, const int32_t* in, int n, int width, int k, const uint32_t* consts) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    uint32_t tab[INV_ALPHA_TABLE * NW];
    for (int i = 0; i < n; ++i) {
        if (width == 2) jive_lane<2, 2, NW>(out + i, in + i, (size_t)n, c, tab, 1);
        else if (k == 2) jive_lane<4, 2, NW>(out + i, in + i, (size_t)n, c, tab, 1);
        else jive_lane<4, 4, NW>(out + i, in + i, (size_t)n, c, tab, 1);
    }
}
template <int NW> void pow_n(uint32_t* r, const uint32_t* x, int n, const uint32_t* consts) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    uint32_t tab[INV_ALPHA_TABLE * NW];
    const ThreadArith<NW> ar{c, tab, 1};
    for (int i = 0; i < n; ++i)
        exp_inv_alpha<1>(ar, (uint32_t(*)[NW])(r + NW * i), (const uint32_t(*)[NW])(x + NW * i));
}
extern "C" {
void t_mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p, uint32_t n0) {
    BY_WORDS(mul_n, r, a, b, n, p, n0);
}
void t_sqr(uint32_t* r, const uint32_t* a, int n, int words, const uint32_t* p, uint32_t n0) {
    BY_WORDS(sqr_n, r, a, n, p, n0);
}
void t_add(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p) {
    BY_WORDS(add_n, r, a, b, n, p);
}
void t_sub(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p) {
    BY_WORDS(sub_n, r, a, b, n, p);
}
// limbs: int32 [L, n] limb-major, as the kernels read and write them
void t_from_limbs(uint32_t* r, const int32_t* limbs, int n, int words, const uint32_t* c_in, const uint32_t* p,
                  uint32_t n0) {
    BY_WORDS(from_limbs_n, r, limbs, n, c_in, p, n0);
}
void t_to_limbs(int32_t* limbs, const uint32_t* a, int n, int words, const uint32_t* c_out, const uint32_t* p,
                uint32_t n0) {
    BY_WORDS(to_limbs_n, limbs, a, n, c_out, p, n0);
}
// the kernel's per-thread work, lane by lane: [width*L, n] -> [(width/k)*L, n]
void t_jive(int32_t* out, const int32_t* in, int n, int width, int k, int words, const uint32_t* consts) {
    BY_WORDS(jive_n, out, in, n, width, k, consts);
}
// x^(1/alpha) in R' form through ThreadArith's window, n values
void t_exp_inv_alpha(uint32_t* r, const uint32_t* x, int n, int words, const uint32_t* consts) {
    BY_WORDS(pow_n, r, x, n, consts);
}
int t_consts_words(int words) {
    return words == 8 ? (int)(sizeof(AnemoiConsts<8>) / 4) : (int)(sizeof(AnemoiConsts<12>) / 4);
}
int t_one_offset(int words) {
    return words == 8 ? (int)(offsetof(AnemoiConsts<8>, one) / 4) : (int)(offsetof(AnemoiConsts<12>, one) / 4);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("field32")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libfield32.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(so))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _words(vals, nw):
    return np.stack([words_from_int(v, nw) for v in vals]).astype(np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in words]


def _values(p, n, seed, *, below=None):
    """Corner values and random ones below `below` (default p)."""
    below = below or p
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(40), "little") % below for _ in range(n)]
    return [v % below for v in (0, 1, p - 1, p // 2, p - 2, 2)] + rand


# The five 20-limb fields' p are below 2^255, so their sums never carry out
# of the eighth word; 2^256 - 189, the largest 256-bit prime, makes them
# carry.  BLS12-377 and BLS12-381 leave three bits spare in 12 words;
# 2^384 - 317, the largest 384-bit prime, leaves none.
PRIMES = [get_field(f).p for f in FIELDS_20] + [2**256 - 189] + [get_field(f).p for f in FIELDS_30] + [2**384 - 317]


@pytest.mark.parametrize("prime", PRIMES, ids=list(FIELDS_20) + ["p256"] + list(FIELDS_30) + ["p384"])
def test_word_arithmetic(lib, prime):
    nw = 8 if prime < 1 << 256 else 12
    r_words = 1 << (32 * nw)
    p, n0 = _words([prime], nw)[0], ctypes.c_uint32(-pow(prime, -1, 2**32) % 2**32)
    a_vals, b_vals = _values(prime, 250, 1), _values(prime, 250, 2)[::-1]
    a, b = _words(a_vals, nw), _words(b_vals, nw)
    n = len(a_vals)
    r = np.zeros_like(a)
    rinv = pow(r_words, -1, prime)

    lib.t_mul(_ptr(r), _ptr(a), _ptr(b), n, nw, _ptr(p), n0)
    assert _ints(r) == [x * y * rinv % prime for x, y in zip(a_vals, b_vals)]
    lib.t_sqr(_ptr(r), _ptr(a), n, nw, _ptr(p), n0)
    assert _ints(r) == [x * x * rinv % prime for x in a_vals]
    lib.t_add(_ptr(r), _ptr(a), _ptr(b), n, nw, _ptr(p))
    assert _ints(r) == [(x + y) % prime for x, y in zip(a_vals, b_vals)]
    lib.t_sub(_ptr(r), _ptr(a), _ptr(b), n, nw, _ptr(p))
    assert _ints(r) == [(x - y) % prime for x, y in zip(a_vals, b_vals)]

    # the product's first operand may be any value below R' (the entry
    # conversion feeds it raw words); the second stays below p
    big = _values(prime, 100, 3, below=r_words) + [r_words - 1, r_words - prime] + [r_words - 1] * 4
    small = b_vals[: len(big) - 4] + [prime - 1, prime - 2, prime - 2**32, prime // 2]
    r = np.zeros((len(big), nw), np.uint32)
    lib.t_mul(_ptr(r), _ptr(_words(big, nw)), _ptr(_words(small, nw)), len(big), nw, _ptr(p), n0)
    assert _ints(r) == [x * y * rinv % prime for x, y in zip(big, small)]


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_limb_boundary(lib, field):
    fp = get_field(field)
    nw, L = fp.kernel_words, fp.n_limbs
    r_words = 1 << (32 * nw)
    p, n0 = _words([fp.p], nw)[0], ctypes.c_uint32(fp.kernel_n0)
    c_in, c_out = _words([fp.c_in], nw)[0], _words([fp.c_out], nw)[0]
    # canonical rows, rows from p up to R', which the entry reduces, and
    # rows up to R = 2^(13L), whose bits from R' up the entry drops
    vals = (_values(fp.p, 200, 4) + _values(fp.p, 50, 5, below=r_words)
            + _values(fp.p, 50, 6, below=1 << (13 * L)) + [r_words - 1, (1 << (13 * L)) - 1, r_words])
    limbs = np.stack([limbs_from_int(v, L) for v in vals], axis=1)
    n = len(vals)
    words = np.zeros((n, nw), np.uint32)
    lib.t_from_limbs(_ptr(words), _ptr(limbs), n, nw, _ptr(c_in), _ptr(p), n0)
    # in R' form, a value x in R form is x * R' / R mod p
    shift = pow(2, 13 * L - 32 * nw, fp.p)
    assert _ints(words) == [v % r_words * pow(shift, -1, fp.p) % fp.p for v in vals]

    back = np.zeros_like(limbs)
    lib.t_to_limbs(_ptr(back), _ptr(words), n, nw, _ptr(c_out), _ptr(p), n0)
    assert [int_from_limbs(back[:, i]) for i in range(n)] == [v % r_words % fp.p for v in vals]
    assert back.min() >= 0 and back.max() < (1 << 13)


def _host_jive(lib, inst, k, x):
    """jive.cu's per-state code over int32 [WIDTH*L, N] on the host."""
    x = np.ascontiguousarray(x, dtype=np.int32)
    out = np.zeros(((inst.width // k) * inst.field.n_limbs, x.shape[1]), np.int32)
    words = cuda_backend.consts_words(inst)
    lib.t_jive(_ptr(out), _ptr(x), x.shape[1], inst.width, k, inst.field.kernel_words, _ptr(words))
    return out


def test_consts_layout(lib):
    """Both word counts: the struct's size, and the sponge's sigma (1 in R'
    form) where the struct keeps it."""
    for nw, field in ((8, "vesta"), (12, "bls12_381")):
        assert lib.t_consts_words(nw) == len(cuda_backend.consts_words(get_instance(field, "anemoi_4_3")))
        assert lib.t_consts_words(nw) == cuda_backend.consts_len(nw)
    for field in FIELD_NAMES:
        fp = get_field(field)
        nw = fp.kernel_words
        off = lib.t_one_offset(nw)
        words = cuda_backend.consts_words(get_instance(field, "anemoi_2_1"))
        assert _ints([words[off:off + nw]]) == [(1 << (32 * nw)) % fp.p]


@pytest.mark.parametrize("field", FIELD_NAMES)
@pytest.mark.parametrize("iname", INSTANCE_NAMES)
def test_host_jive_vectors(lib, field, iname):
    inst = get_instance(field, iname)
    W, L = inst.width, inst.field.n_limbs
    for pair, k in zip(load_vectors(field, iname)["jive"], [2, 4]):
        states = encode_states(inst, pair["input"], device="cpu").numpy()
        out = _host_jive(lib, inst, k, states.reshape(W * L, -1))
        assert decode_states(inst, out.reshape(W // k, L, -1)) == pair["output"]


@pytest.mark.parametrize("iname,k", [("anemoi_2_1", 2), ("anemoi_4_3", 2), ("anemoi_4_3", 4)])
def test_host_jive_matches_plain(lib, iname, k):
    inst = get_instance("vesta", iname)
    W, L = inst.width, inst.field.n_limbs
    x = random_canonical(inst.field, (W, 5), np.random.default_rng(11)).transpose(1, 0, 2).reshape(W * L, 5)
    plain = cuda_backend.jive(inst, k, torch.from_numpy(np.ascontiguousarray(x)))
    np.testing.assert_array_equal(_host_jive(lib, inst, k, x), plain.numpy())


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_host_exp_inv_alpha_window(lib, field):
    """x^(1/alpha) through ThreadArith's 4-bit sliding window, the code of the
    Jive and one-thread permutation kernels, against Python's pow over every
    field's own exponent: 0, 1, p - 1, the generator beta and 16 random
    canonical bases, in and out in R' form."""
    fp = get_field(field)
    nw = fp.kernel_words
    r_words = 1 << (32 * nw)
    rng = np.random.default_rng(12)
    bases = [0, 1, fp.p - 1, fp.beta] + [int.from_bytes(rng.bytes(56), "little") % fp.p for _ in range(16)]
    x = _words([b * r_words % fp.p for b in bases], nw)
    r = np.zeros_like(x)
    consts = cuda_backend.consts_words(get_instance(field, "anemoi_2_1"))
    lib.t_exp_inv_alpha(_ptr(r), _ptr(x), len(bases), nw, _ptr(consts))
    assert _ints(r) == [pow(b, fp.inv_alpha, fp.p) * r_words % fp.p for b in bases]
