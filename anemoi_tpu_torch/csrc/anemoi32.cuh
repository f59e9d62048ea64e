// The Anemoi permutation of one state on NW 32-bit words: the body that
// the Jive kernel (jive.cu) and the permutation and sponge kernels
// (sponge.cu) share, at 8 words for the five 20-limb fields and at 12 for
// the two 30-limb ones.
//
// A state is W field elements in Montgomery form with R' = 2^(32 NW)
// (field32.cuh), held by one thread.  Rounds: ARK, MDS (1 or 2 columns),
// open Flystel; then a final MDS.  x^(1/alpha) is a left-to-right binary
// ladder over the exponent's bits (Vesta: 253 squarings, 124 products;
// BLS12-381: 380 and 193; the reference's addition chains have 293 and 454
// operations, and the result is the same canonical value).  Round and
// ladder loops stay rolled (#pragma unroll 1), which keeps the build to
// seconds.
//
// Constants (field words, round constants, exponent bits, rounds) arrive
// in one struct passed to the kernels by value; one instantiation per
// width and word count serves every field of that word count.  Everything
// here is __host__ __device__, so the host tests build it with g++.
#pragma once

#include <stdint.h>

#include "field32.cuh"

#define MAX_ROUND_COLUMNS 28  // rounds * columns of the largest instance: 14 x 2 (Vesta and BLS12-381 4_3)

// The layout matches anemoi_tpu_torch/ff/cuda_backend.py:consts_words.
template <int NW>
struct AnemoiConsts {
    uint32_t p[NW];
    uint32_t n0;  // -p^-1 mod 2^32
    uint32_t c_in[NW];  // 2^(64 NW - 13 NL) mod p: 2^252 or 2^378
    uint32_t c_out[NW];  // 2^(13 NL) mod p: 2^260 or 2^390
    uint32_t one[NW];  // 1 in R' form: 2^(32 NW) mod p
    uint32_t beta[NW];  // R' form
    uint32_t delta[NW];  // R' form
    uint32_t inv_alpha[NW];  // the exponent 1/alpha mod (p - 1)
    uint32_t inv_alpha_bits;
    uint32_t rounds;
    uint32_t C[MAX_ROUND_COLUMNS][NW];  // [round * columns + column], R' form
    uint32_t D[MAX_ROUND_COLUMNS][NW];
};
static_assert(sizeof(AnemoiConsts<8>) == 507 * 4, "AnemoiConsts<8> layout");
static_assert(sizeof(AnemoiConsts<12>) == 759 * 4, "AnemoiConsts<12> layout");
static_assert(sizeof(AnemoiConsts<12>) <= 4096, "AnemoiConsts must fit the kernel parameter space");

template <int NW>
F32_FN void f32_copy(uint32_t r[NW], const uint32_t a[NW]) {
#pragma unroll
    for (int j = 0; j < NW; ++j) r[j] = a[j];
}

template <int NW>
F32_FN void mul_g(uint32_t r[NW], const uint32_t a[NW], const AnemoiConsts<NW>& c) {
    f32_mont_mul<NW>(r, a, c.beta, c.p, c.n0);
}

// x^(1/alpha): left-to-right binary ladder over the exponent's bits.
template <int NW>
F32_FN void exp_inv_alpha(uint32_t r[NW], const uint32_t x[NW], const AnemoiConsts<NW>& c) {
    uint32_t acc[NW];
    f32_copy<NW>(acc, x);
#pragma unroll 1
    for (int bit = (int)c.inv_alpha_bits - 2; bit >= 0; --bit) {
        f32_mont_sqr<NW>(acc, acc, c.p, c.n0);
        if ((c.inv_alpha[bit >> 5] >> (bit & 31)) & 1u) f32_mont_mul<NW>(acc, acc, x, c.p, c.n0);
    }
    f32_copy<NW>(r, acc);
}

// Open Flystel: x -= g*y^2 ; y -= x^(1/alpha) ; x += g*y^2 + delta.
template <int NW>
F32_FN void flystel(uint32_t x[NW], uint32_t y[NW], const AnemoiConsts<NW>& c) {
    uint32_t t[NW];
    f32_mont_sqr<NW>(t, y, c.p, c.n0);
    mul_g<NW>(t, t, c);
    f32_sub<NW>(x, x, t, c.p);
    exp_inv_alpha<NW>(t, x, c);
    f32_sub<NW>(y, y, t, c.p);
    f32_mont_sqr<NW>(t, y, c.p, c.n0);
    mul_g<NW>(t, t, c);
    f32_add<NW>(x, x, t, c.p);
    f32_add<NW>(x, x, c.delta, c.p);
}

// The linear layer and the pseudo-Hadamard transform.  Width 4 does four
// products by the generator (mul_g); width 2 does none.
template <int W, int NW>
F32_FN void mds(uint32_t s[W][NW], const AnemoiConsts<NW>& c) {
    if constexpr (W == 2) {
        f32_add<NW>(s[1], s[1], s[0], c.p);
        f32_add<NW>(s[0], s[0], s[1], c.p);
    } else {
        uint32_t t[NW];
        mul_g<NW>(t, s[1], c);
        f32_add<NW>(s[0], s[0], t, c.p);
        mul_g<NW>(t, s[0], c);
        f32_add<NW>(s[1], s[1], t, c.p);
        mul_g<NW>(t, s[2], c);
        f32_add<NW>(s[3], s[3], t, c.p);
        mul_g<NW>(t, s[3], c);
        f32_add<NW>(s[2], s[2], t, c.p);
        // swap the two y words, then the pseudo-Hadamard transform
        f32_copy<NW>(t, s[2]);
        f32_copy<NW>(s[2], s[3]);
        f32_copy<NW>(s[3], t);
        f32_add<NW>(s[2], s[2], s[0], c.p);
        f32_add<NW>(s[3], s[3], s[1], c.p);
        f32_add<NW>(s[0], s[0], s[2], c.p);
        f32_add<NW>(s[1], s[1], s[3], c.p);
    }
}

// The permutation, in place: rounds x (ARK, MDS, S-box), then MDS.
template <int W, int NW>
F32_FN void permute_state(uint32_t s[W][NW], const AnemoiConsts<NW>& c) {
    constexpr int COLS = W / 2;
#pragma unroll 1
    for (int r = 0; r < (int)c.rounds; ++r) {
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
            f32_add<NW>(s[i], s[i], c.C[r * COLS + i], c.p);
            f32_add<NW>(s[COLS + i], s[COLS + i], c.D[r * COLS + i], c.p);
        }
        mds<W, NW>(s, c);
#pragma unroll
        for (int i = 0; i < COLS; ++i) flystel<NW>(s[i], s[COLS + i], c);
    }
    mds<W, NW>(s, c);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// The word count of a library's C interface: each of jive.cu and sponge.cu
// is built once with -DANEMOI_WORDS=8 and once with -DANEMOI_WORDS=12
// (_build.py), so the two word counts build in parallel and a library's
// AnemoiConsts layout says which it is.
#ifndef ANEMOI_WORDS
#define ANEMOI_WORDS 8
#endif
static_assert(ANEMOI_WORDS == 8 || ANEMOI_WORDS == 12, "ANEMOI_WORDS is 8 or 12");

// Runs launch() (kernel launches on a stream of `device`) with `device`
// current and returns the first error, with cudaGetLastError() checked
// after the launch.  The calling thread's current device is the same
// afterwards.
template <class Launch>
inline int launch_on(int device, Launch launch) {
    int prev;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    launch();
    err = cudaGetLastError();
    if (prev != device) {
        const cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    return (int)err;
}
#endif  // __CUDACC__
