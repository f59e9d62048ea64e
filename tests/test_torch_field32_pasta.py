"""The Montgomery product and squaring of csrc/field32.cuh compiled for the
Pasta moduli's shape (``F32PastaModulus``), built for the host with g++:
against Python ints and against the code for any modulus
(``F32AnyModulus``) word for word, for Vesta and Pallas; the shape test the
Jive launcher picks its kernel by; and the per-state Jive of csrc/jive.cu
under the Pasta shape against the SAGE vectors and the code for any
modulus.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from anemoi_tpu_torch._build import CSRC
from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.ff.limb_ops import random_canonical
from anemoi_tpu_torch.fields.params import FIELD_NAMES, get_field, get_instance, words_from_int
from anemoi_tpu_torch.modes.batched import decode_states, encode_states

from .vector_loader import load_vectors

PASTA = ("vesta", "pallas")

_SHIM = r"""
#include <stddef.h>
#include "jive.cu"
// `pasta` picks the shape the code is compiled for: 1 F32PastaModulus, 0 F32AnyModulus
#define BY_SHAPE(f, ...) (pasta ? f<F32PastaModulus>(__VA_ARGS__) : f<F32AnyModulus>(__VA_ARGS__))
template <class Mod> void mul_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p,
                                uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_mont_mul<8, Mod>(r + 8 * i, a + 8 * i, b + 8 * i, p, n0);
}
template <class Mod> void sqr_n(uint32_t* r, const uint32_t* a, int n, const uint32_t* p, uint32_t n0) {
    for (int i = 0; i < n; ++i) f32_mont_sqr<8, Mod>(r + 8 * i, a + 8 * i, p, n0);
}
template <class Mod> void jive_n(int32_t* out, const int32_t* in, int n, int width, int k, const uint32_t* consts) {
    const AnemoiConsts<8>& c = *(const AnemoiConsts<8>*)consts;
    uint32_t tab[INV_ALPHA_TABLE * 8];
    for (int i = 0; i < n; ++i) {
        if (width == 2) jive_lane<2, 2, 8, Mod>(out + i, in + i, (size_t)n, c, tab, 1);
        else if (k == 2) jive_lane<4, 2, 8, Mod>(out + i, in + i, (size_t)n, c, tab, 1);
        else jive_lane<4, 4, 8, Mod>(out + i, in + i, (size_t)n, c, tab, 1);
    }
}
extern "C" {
void t_mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int pasta, const uint32_t* p, uint32_t n0) {
    BY_SHAPE(mul_n, r, a, b, n, p, n0);
}
void t_sqr(uint32_t* r, const uint32_t* a, int n, int pasta, const uint32_t* p, uint32_t n0) {
    BY_SHAPE(sqr_n, r, a, n, p, n0);
}
// the launcher's test: the constants' p and n0 at the library's word count
int t_has_shape(int words, const uint32_t* p, uint32_t n0) {
    return words == 8 ? f32_has_shape<8, F32PastaModulus>(p, n0) : f32_has_shape<12, F32PastaModulus>(p, n0);
}
void t_jive(int32_t* out, const int32_t* in, int n, int width, int k, int pasta, const uint32_t* consts) {
    BY_SHAPE(jive_n, out, in, n, width, k, consts);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("field32_pasta")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libfield32_pasta.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(so))


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _words(vals, nw=8):
    return np.stack([words_from_int(v, nw) for v in vals]).astype(np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in words]


def _cases(p, n, seed):
    """Canonical values: 0, 1, p - 1 and p - 2; random ones; random ones with
    the low word 0 (m = 0 at the first word step, no carry out of the
    cleared word); and values whose words 4 to 6 are all ones (2^254 - 1,
    2^224 - 1 and random ones), so that the reduction's carries run through
    the words where p is 0."""
    rng = np.random.default_rng(seed)
    rand = lambda: int.from_bytes(rng.bytes(40), "little") % p
    ones = ((1 << 96) - 1) << 128
    vals = [0, 1, p - 1, p - 2, 2**254 - 1, 2**224 - 1]
    vals += [rand() for _ in range(n)]
    vals += [rand() >> 32 << 32 for _ in range(n // 4)]
    vals += [(rand() | ones) % p for _ in range(n // 4)]
    return vals


def _both(lib, fn, field, *args):
    """fn's result words under F32PastaModulus and under F32AnyModulus."""
    fp = get_field(field)
    p, n0 = _words([fp.p])[0], ctypes.c_uint32(fp.kernel_n0)
    outs = []
    for pasta in (1, 0):
        r = np.zeros_like(args[0])
        fn(_ptr(r), *[_ptr(a) for a in args], len(args[0]), pasta, _ptr(p), n0)
        outs.append(r)
    return outs


@pytest.mark.parametrize("field", PASTA)
def test_pasta_product_and_square(lib, field):
    p = get_field(field).p
    rinv = pow(1 << 256, -1, p)
    a_vals, b_vals = _cases(p, 200, 1), _cases(p, 200, 2)[::-1]
    a, b = _words(a_vals), _words(b_vals)

    pasta, generic = _both(lib, lib.t_mul, field, a, b)
    np.testing.assert_array_equal(pasta, generic)
    assert _ints(pasta) == [x * y * rinv % p for x, y in zip(a_vals, b_vals)]
    pasta, generic = _both(lib, lib.t_sqr, field, a)
    np.testing.assert_array_equal(pasta, generic)
    assert _ints(pasta) == [x * x * rinv % p for x in a_vals]

    # the product's first operand may be any value below 2^256: 2^256 - 1
    # and every value from p up; the second stays below p
    big = ([2**256 - 1] * 6 + [2**256 - p, p, 2**255] + [v + p for v in a_vals[:50]]
           + [2**256 - 1 - v for v in a_vals])
    small = [0, 1, p - 1, p - 2, 2**254 - 1, b_vals[10], p - 1, p - 1, p - 1] + (b_vals * 2)[: len(big) - 9]
    pasta, generic = _both(lib, lib.t_mul, field, _words(big), _words(small))
    np.testing.assert_array_equal(pasta, generic)
    assert _ints(pasta) == [x * y * rinv % p for x, y in zip(big, small)]


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_pasta_shape_holds_for_vesta_and_pallas_alone(lib, field):
    fp = get_field(field)
    p = _words([fp.p], fp.kernel_words)[0]
    assert lib.t_has_shape(fp.kernel_words, _ptr(p), ctypes.c_uint32(fp.kernel_n0)) == (field in PASTA)


@pytest.mark.parametrize("word", [4, 5, 6])
def test_pasta_shape_refuses_a_changed_zero_word(lib, word):
    p = _words([get_field("vesta").p])[0]
    n0 = ctypes.c_uint32(0xFFFFFFFF)
    assert lib.t_has_shape(8, _ptr(p), n0) == 1
    p[word] = 1
    assert lib.t_has_shape(8, _ptr(p), n0) == 0


def _host_jive(lib, inst, k, x, pasta):
    x = np.ascontiguousarray(x, dtype=np.int32)
    out = np.zeros(((inst.width // k) * inst.field.n_limbs, x.shape[1]), np.int32)
    lib.t_jive(_ptr(out), _ptr(x), x.shape[1], inst.width, k, pasta, _ptr(cuda_backend.consts_words(inst)))
    return out


@pytest.mark.parametrize("field", PASTA)
@pytest.mark.parametrize("iname,k", [("anemoi_2_1", 2), ("anemoi_4_3", 2), ("anemoi_4_3", 4)])
def test_pasta_jive_lane(lib, field, iname, k):
    """The SAGE vector of (instance, k), and random canonical states against
    jive_lane under F32AnyModulus."""
    inst = get_instance(field, iname)
    W, L = inst.width, inst.field.n_limbs
    pair = load_vectors(field, iname)["jive"][[2, 4].index(k)]
    states = encode_states(inst, pair["input"], device="cpu").numpy()
    out = _host_jive(lib, inst, k, states.reshape(W * L, -1), 1)
    assert decode_states(inst, out.reshape(W // k, L, -1)) == pair["output"]

    x = random_canonical(inst.field, (W, 6), np.random.default_rng(13)).transpose(1, 0, 2).reshape(W * L, 6)
    np.testing.assert_array_equal(_host_jive(lib, inst, k, x, 1), _host_jive(lib, inst, k, x, 0))
