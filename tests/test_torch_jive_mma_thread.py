"""The one-state-a-thread tensor-core product of csrc/field32_mma.cuh and
its x^(1/alpha), jive_mma.cu's arithmetic, built for the host with g++.

On the card a warp holds 32 states, one a thread, and a product is each
thread's bilinear half and the warp's reduction, whose two products by
constants run as mma.sync with the operands moved through shared-memory
rows and ldmatrix; here the header's HostWarp policy holds the whole warp
in one object, computes each mma and each ldmatrix from its definition
over the 32 lanes' registers and addresses, and runs every thread's
statements for each, so the test runs the statements the kernel runs.
Checked: MmaThreadArith's product by a window table entry, squaring and
product by a constant against f32_mont_mul / f32_mont_sqr and Python ints
for the 7 fields and 2^256 - 189 and 2^384 - 317 (no spare top bit), on 0,
1, p - 1, the values whose word slices carry through whole slices, random
canonical values and first operands just below R'; the window's
x^(1/alpha) against the JAX package's golden model for the 7 fields.  The
Jive of jive_mma.cu over the same policy is
tests/test_torch_field32_mma.py's.  Tolerance: exact.
"""

import ctypes

import numpy as np
import pytest

from anemoi_tpu.ff import golden as jax_golden
from anemoi_tpu.fields.params import get_field as jax_field
from anemoi_tpu_torch.ff import cuda_backend, mxu_ops
from anemoi_tpu_torch.fields.params import FIELD_NAMES, get_field, get_instance

from .test_torch_field32 import PRIMES, _ints, _ptr, _values, _words
from .test_torch_field32_group import _edge_values
from .test_torch_field32_mma import build_shim

_SHIM = r"""
#include <stddef.h>
#include <string.h>
#include "jive_mma.cu"
#define BY_WORDS(f, ...) (words == 8 ? f<8>(__VA_ARGS__) : f<12>(__VA_ARGS__))
// one warp's shared memory, as the kernel lays it out: the constants' fragments lane-major
// (mt_frag_word), the warp's scratch rows, its 32 threads' window tables (stride 32)
template <int NW> struct Warp {
    uint32_t frag[mt_frag_words<NW>];
    uint32_t rows[MMA_THREAD_STATES * MMA_ROW_WORDS];
    uint32_t tab[INV_ALPHA_TABLE * NW * MMA_WARP];
    MmaThreadArith<NW, HostWarp> ar;
    Warp(const AnemoiConsts<NW>& c, const uint32_t* f) : ar{c, frag, rows, tab, MMA_WARP} {
        constexpr int R = mma_regs<NW>;
        memset(frag, 0, sizeof frag);
        for (int i = 0; i < mma_frag_words<NW>; ++i)
            frag[mt_frag_word<NW>(i / (R * MMA_WARP), i / MMA_WARP % R, i % MMA_WARP)] = f[i];
    }
};
// op 0: a * b, b from the window table, 1: a^2, 2: a * k for k = b's first value; a, b, r: warps of 32 values of
// NW words
template <int NW> void mul_warps(uint32_t* r, const uint32_t* a, const uint32_t* b, int warps, int op,
                                 const uint32_t* p, const uint32_t* frag) {
    AnemoiConsts<NW> c;
    memset(&c, 0, sizeof c);
    memcpy(c.p, p, sizeof c.p);
    Warp<NW>* w = new Warp<NW>(c, frag);
    using E = uint32_t(*)[NW];
    using CE = const uint32_t(*)[NW];
    for (int k = 0; k < warps; ++k) {
        const size_t at = (size_t)k * MMA_WARP * NW;
        if (op == 0) {
            w->ar.store(3, CE(b + at));
            w->ar.mul_tab(E(r + at), CE(a + at), 3);
        }
        else if (op == 1) w->ar.sqr(E(r + at), CE(a + at));
        else w->ar.mul_k(E(r + at), CE(a + at), b);
    }
    delete w;
}
template <int NW> void f32mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p,
                              uint32_t n0, int sqr) {
    for (int i = 0; i < n; ++i) {
        if (sqr) f32_mont_sqr<NW>(r + NW * i, a + NW * i, p, n0);
        else f32_mont_mul<NW>(r + NW * i, a + NW * i, b + NW * i, p, n0);
    }
}
template <int NW> void pow_warps(uint32_t* r, const uint32_t* x, int warps, const void* consts, const uint32_t* frag) {
    Warp<NW>* w = new Warp<NW>(*(const AnemoiConsts<NW>*)consts, frag);
    using E = uint32_t[MMA_WARP][NW];
    for (int k = 0; k < warps; ++k)
        exp_inv_alpha<1>(w->ar, (E*)(r + (size_t)k * MMA_WARP * NW), (const E*)(x + (size_t)k * MMA_WARP * NW));
    delete w;
}
extern "C" {
void t_mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int warps, int op, int words, const uint32_t* p,
           const uint32_t* frag) {
    BY_WORDS(mul_warps, r, a, b, warps, op, p, frag);
}
void t_f32_mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p, uint32_t n0,
               int sqr) {
    BY_WORDS(f32mul, r, a, b, n, p, n0, sqr);
}
void t_pow(uint32_t* r, const uint32_t* x, int warps, int words, const void* consts, const uint32_t* frag) {
    BY_WORDS(pow_warps, r, x, warps, consts, frag);
}
}
"""

WARP = 32


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_shim(tmp_path_factory, "jive_mma_thread", _SHIM)


def _whole_warps(vals, fill):
    """vals padded with `fill` to a multiple of 32."""
    return vals + [fill] * (-len(vals) % WARP)


@pytest.mark.parametrize("prime", PRIMES, ids=[f"{p.bit_length()}b{i}" for i, p in enumerate(PRIMES)])
def test_thread_product_matches_f32(lib, prime):
    """MmaThreadArith's products, as the kernel runs them (by a window table
    entry, sqr, by a constant), equal f32_mont_mul, f32_mont_sqr and Python
    ints: canonical operands with the slice edges, and a first operand
    anywhere below R' (the entry conversion's raw words)."""
    nw = 8 if prime < 1 << 256 else 12
    r_words = 1 << (32 * nw)
    rinv = pow(r_words, -1, prime)
    edges = _edge_values(prime, nw)
    a_vals = _whole_warps(edges + edges[::-1] + _values(prime, 700, 7), 1)
    b_vals = _whole_warps(edges[::-1] + [prime - 1] * len(edges) + _values(prime, 700, 8)[::-1], prime - 1)
    p, n0 = _words([prime], nw)[0], ctypes.c_uint32(-pow(prime, -1, 2**32) % 2**32)
    frag = mxu_ops.fragment_words(prime)
    a, b = _words(a_vals, nw), _words(b_vals, nw)
    got, want = np.zeros_like(a), np.zeros_like(a)
    lib.t_mul(_ptr(got), _ptr(a), _ptr(b), len(a_vals) // WARP, 0, nw, _ptr(p), _ptr(frag))
    lib.t_f32_mul(_ptr(want), _ptr(a), _ptr(b), len(a_vals), nw, _ptr(p), n0, 0)
    np.testing.assert_array_equal(got, want)
    assert _ints(got) == [x * y * rinv % prime for x, y in zip(a_vals, b_vals)]
    lib.t_mul(_ptr(got), _ptr(a), _ptr(b), len(a_vals) // WARP, 1, nw, _ptr(p), _ptr(frag))
    lib.t_f32_mul(_ptr(want), _ptr(a), _ptr(a), len(a_vals), nw, _ptr(p), n0, 1)
    np.testing.assert_array_equal(got, want)
    assert _ints(got) == [x * x * rinv % prime for x in a_vals]

    # a first operand just below R' (and anywhere below it), times the constant k or canonical values
    big = _whole_warps([r_words - 1, r_words - 2, r_words - prime, r_words - 2**32]
                       + _values(prime, 120, 9, below=r_words), r_words - 1)
    small = _whole_warps([prime - 1, prime - 2, prime // 2] + _values(prime, 125, 10), prime - 1)[:len(big)]
    x, y = _words(big, nw), _words(small, nw)
    got = np.zeros_like(x)
    lib.t_mul(_ptr(got), _ptr(x), _ptr(y), len(big) // WARP, 0, nw, _ptr(p), _ptr(frag))
    assert _ints(got) == [u * v * rinv % prime for u, v in zip(big, small)]
    lib.t_mul(_ptr(got), _ptr(x), _ptr(y), len(big) // WARP, 2, nw, _ptr(p), _ptr(frag))
    assert _ints(got) == [u * small[0] * rinv % prime for u in big]


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_thread_window_matches_golden(lib, field):
    """x^(1/alpha) through MmaThreadArith's 4-bit window (exp_inv_alpha's
    window branch, its table in the warp's 32 tables) against the JAX
    package's golden model: 0, 1, p - 1, beta and random canonical bases,
    in and out in R' form."""
    fp = get_field(field)
    nw = fp.kernel_words
    r_words = 1 << (32 * nw)
    rng = np.random.default_rng(13)
    bases = [0, 1, fp.p - 1, fp.beta] + [int.from_bytes(rng.bytes(56), "little") % fp.p for _ in range(28)]
    x = _words([v * r_words % fp.p for v in bases], nw)
    r = np.zeros_like(x)
    inst = get_instance(field, "anemoi_2_1")
    lib.t_pow(_ptr(r), _ptr(x), 1, nw, _ptr(cuda_backend.consts_words(inst)), _ptr(mxu_ops.fragment_words(fp)))
    want = [jax_golden.exp_inv_alpha(jax_field(field), v) for v in bases]
    assert _ints(r) == [v * r_words % fp.p for v in want]
