"""The CUDA kernel's arithmetic, built for the host with g++: the 8-word
field operations of csrc/field32.cuh against Python ints, and the
per-state Jive of csrc/jive.cu against the SAGE vectors and the plain path,
for the five 20-limb fields.

Both sources are __host__ __device__ outside the kernel itself, so this
checks the very code the kernel is compiled from, without a card:
Montgomery product and square, add, sub, the conversions between the
13-bit-limb form (R = 2^260) and the kernel's word form (R' = 2^256), and
the rounds, ladder and feed-forward sum with the constants as
``cuda_backend.consts_words`` lays them out.
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
    INSTANCE_NAMES,
    KERNEL_FIELDS,
    get_field,
    get_instance,
    int_from_limbs,
    limbs_from_int,
    words_from_int,
)
from anemoi_tpu_torch.modes.batched import decode_states, encode_states

from .vector_loader import load_vectors

R_WORDS = 1 << 256

_SHIM = r"""
#include <stddef.h>
#include "jive.cu"
#define W F32_WORDS
extern "C" {
void t_mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p, uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_mont_mul(r + W * i, a + W * i, b + W * i, p, n0);
}
void t_sqr(uint32_t* r, const uint32_t* a, int n, const uint32_t* p, uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_mont_sqr(r + W * i, a + W * i, p, n0);
}
void t_add(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p) {
    for (int i = 0; i < n; ++i) f32_add(r + W * i, a + W * i, b + W * i, p);
}
void t_sub(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p) {
    for (int i = 0; i < n; ++i) f32_sub(r + W * i, a + W * i, b + W * i, p);
}
// limbs: int32 [20, n] limb-major, as the kernel reads and writes them
void t_from_limbs(uint32_t* r, const int32_t* limbs, int n, const uint32_t* c_in, const uint32_t* p, uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_from_limbs(r + W * i, limbs + i, (size_t)n, c_in, p, n0);
}
void t_to_limbs(int32_t* limbs, const uint32_t* a, int n, const uint32_t* c_out, const uint32_t* p, uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_to_limbs(limbs + i, (size_t)n, a + W * i, c_out, p, n0);
}
// the kernel's per-thread work, lane by lane: [width*20, n] -> [(width/k)*20, n]
void t_jive(int32_t* out, const int32_t* in, int n, int width, int k, const uint32_t* consts) {
    const AnemoiConsts& c = *(const AnemoiConsts*)consts;
    for (int i = 0; i < n; ++i) {
        if (width == 2) jive_lane<2, 2>(out + i, in + i, (size_t)n, c);
        else if (k == 2) jive_lane<4, 2>(out + i, in + i, (size_t)n, c);
        else jive_lane<4, 4>(out + i, in + i, (size_t)n, c);
    }
}
int t_consts_words(void) { return (int)(sizeof(AnemoiConsts) / 4); }
int t_one_offset(void) { return (int)(offsetof(AnemoiConsts, one) / 4); }
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


def _words(vals):
    return np.stack([words_from_int(v) for v in vals]).astype(np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in words]


def _values(p, n, seed, *, below=None):
    """Corner values and random ones below `below` (default p)."""
    below = below or p
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(40), "little") % below for _ in range(n)]
    return [v % below for v in (0, 1, p - 1, p // 2, p - 2, 2)] + rand


# The five fields' p are below 2^255, so their sums never carry out of the
# eighth word; 2^256 - 189, the largest 256-bit prime, makes them carry.
PRIMES = [get_field(f).p for f in KERNEL_FIELDS] + [2**256 - 189]


@pytest.mark.parametrize("prime", PRIMES, ids=list(KERNEL_FIELDS) + ["p256"])
def test_word_arithmetic(lib, prime):
    p, n0 = _words([prime])[0], ctypes.c_uint32(-pow(prime, -1, 2**32) % 2**32)
    a_vals, b_vals = _values(prime, 250, 1), _values(prime, 250, 2)[::-1]
    a, b = _words(a_vals), _words(b_vals)
    n = len(a_vals)
    r = np.zeros_like(a)
    rinv = pow(R_WORDS, -1, prime)

    lib.t_mul(_ptr(r), _ptr(a), _ptr(b), n, _ptr(p), n0)
    assert _ints(r) == [x * y * rinv % prime for x, y in zip(a_vals, b_vals)]
    lib.t_sqr(_ptr(r), _ptr(a), n, _ptr(p), n0)
    assert _ints(r) == [x * x * rinv % prime for x in a_vals]
    lib.t_add(_ptr(r), _ptr(a), _ptr(b), n, _ptr(p))
    assert _ints(r) == [(x + y) % prime for x, y in zip(a_vals, b_vals)]
    lib.t_sub(_ptr(r), _ptr(a), _ptr(b), n, _ptr(p))
    assert _ints(r) == [(x - y) % prime for x, y in zip(a_vals, b_vals)]

    # the product's first operand may be any value below 2^256 (the entry
    # conversion feeds it raw words); the second stays below p
    big = _values(prime, 100, 3, below=R_WORDS) + [R_WORDS - 1, R_WORDS - prime] + [R_WORDS - 1] * 4
    small = b_vals[: len(big) - 4] + [prime - 1, prime - 2, prime - 2**32, prime // 2]
    r = np.zeros((len(big), 8), np.uint32)
    lib.t_mul(_ptr(r), _ptr(_words(big)), _ptr(_words(small)), len(big), _ptr(p), n0)
    assert _ints(r) == [x * y * rinv % prime for x, y in zip(big, small)]


@pytest.mark.parametrize("field", KERNEL_FIELDS)
def test_limb_boundary(lib, field):
    fp = get_field(field)
    p, n0 = _words([fp.p])[0], ctypes.c_uint32(fp.kernel_n0)
    c_in, c_out = _words([fp.c_in])[0], _words([fp.c_out])[0]
    L = fp.n_limbs
    # canonical rows, rows from p up to 2^256, which the entry reduces, and
    # rows up to 2^260, whose bits from 2^256 up the entry drops
    vals = (_values(fp.p, 200, 4) + _values(fp.p, 50, 5, below=R_WORDS)
            + _values(fp.p, 50, 6, below=1 << (13 * L)) + [R_WORDS - 1, (1 << (13 * L)) - 1, R_WORDS])
    limbs = np.stack([limbs_from_int(v, L) for v in vals], axis=1)
    n = len(vals)
    words = np.zeros((n, 8), np.uint32)
    lib.t_from_limbs(_ptr(words), _ptr(limbs), n, _ptr(c_in), _ptr(p), n0)
    # in R' form, a value x in R form is x * 2^256 / 2^260 = x / 16 mod p
    assert _ints(words) == [v % R_WORDS * pow(16, -1, fp.p) % fp.p for v in vals]

    back = np.zeros_like(limbs)
    lib.t_to_limbs(_ptr(back), _ptr(words), n, _ptr(c_out), _ptr(p), n0)
    assert [int_from_limbs(back[:, i]) for i in range(n)] == [v % R_WORDS % fp.p for v in vals]
    assert back.min() >= 0 and back.max() < (1 << 13)


def _host_jive(lib, inst, k, x):
    """jive.cu's per-state code over int32 [WIDTH*L, N] on the host."""
    x = np.ascontiguousarray(x, dtype=np.int32)
    out = np.zeros(((inst.width // k) * inst.field.n_limbs, x.shape[1]), np.int32)
    words = cuda_backend.consts_words(inst)
    lib.t_jive(_ptr(out), _ptr(x), x.shape[1], inst.width, k, _ptr(words))
    return out


def test_consts_layout(lib):
    assert lib.t_consts_words() == len(cuda_backend.consts_words(get_instance("vesta", "anemoi_4_3")))
    # the sponge's sigma: 1 in R' form, where the struct keeps it
    off = lib.t_one_offset()
    for field in KERNEL_FIELDS:
        words = cuda_backend.consts_words(get_instance(field, "anemoi_2_1"))
        assert _ints([words[off:off + 8]]) == [R_WORDS % get_field(field).p]


@pytest.mark.parametrize("field", KERNEL_FIELDS)
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
