// The Anemoi permutation of one state on eight 32-bit words: the body that
// the Jive kernel (jive.cu) and the permutation and sponge kernels
// (sponge.cu) share, for the 20-limb fields.
//
// A state is W field elements in Montgomery form with R' = 2^256
// (field32.cuh), held by one thread.  Rounds: ARK, MDS (1 or 2 columns),
// open Flystel; then a final MDS.  x^(1/alpha) is a left-to-right binary
// ladder over the exponent's bits (Vesta: 253 squarings, 124 products; the
// reference's addition chain has 293 operations, and the result is the
// same canonical value).  Round and ladder loops stay rolled
// (#pragma unroll 1), which keeps the build to seconds.
//
// Constants (field words, round constants, exponent bits, rounds) arrive
// in one struct passed to the kernels by value; one instantiation per
// width serves all five 20-limb fields.  Everything here is
// __host__ __device__, so the host tests build it with g++.
#pragma once

#include <stdint.h>

#include "field32.cuh"

#define MAX_ROUND_COLUMNS 28  // rounds * columns of the largest 20-limb instance

// The layout matches anemoi_tpu_torch/ff/cuda_backend.py:consts_words.
struct AnemoiConsts {
    uint32_t p[F32_WORDS];
    uint32_t n0;  // -p^-1 mod 2^32
    uint32_t c_in[F32_WORDS];  // 2^252 mod p
    uint32_t c_out[F32_WORDS];  // 2^260 mod p
    uint32_t one[F32_WORDS];  // 1 in R' form: 2^256 mod p
    uint32_t beta[F32_WORDS];  // R' form
    uint32_t delta[F32_WORDS];  // R' form
    uint32_t inv_alpha[F32_WORDS];  // the exponent 1/alpha mod (p - 1)
    uint32_t inv_alpha_bits;
    uint32_t rounds;
    uint32_t C[MAX_ROUND_COLUMNS][F32_WORDS];  // [round * columns + column], R' form
    uint32_t D[MAX_ROUND_COLUMNS][F32_WORDS];
};
static_assert(sizeof(AnemoiConsts) == 507 * 4, "AnemoiConsts layout");
static_assert(sizeof(AnemoiConsts) <= 4096, "AnemoiConsts must fit the kernel parameter space");

F32_FN void copy8(uint32_t r[F32_WORDS], const uint32_t a[F32_WORDS]) {
#pragma unroll
    for (int j = 0; j < F32_WORDS; ++j) r[j] = a[j];
}

F32_FN void mul_g(uint32_t r[F32_WORDS], const uint32_t a[F32_WORDS], const AnemoiConsts& c) {
    f32_mont_mul(r, a, c.beta, c.p, c.n0);
}

// x^(1/alpha): left-to-right binary ladder over the exponent's bits.
F32_FN void exp_inv_alpha(uint32_t r[F32_WORDS], const uint32_t x[F32_WORDS], const AnemoiConsts& c) {
    uint32_t acc[F32_WORDS];
    copy8(acc, x);
#pragma unroll 1
    for (int bit = (int)c.inv_alpha_bits - 2; bit >= 0; --bit) {
        f32_mont_sqr(acc, acc, c.p, c.n0);
        if ((c.inv_alpha[bit >> 5] >> (bit & 31)) & 1u) f32_mont_mul(acc, acc, x, c.p, c.n0);
    }
    copy8(r, acc);
}

// Open Flystel: x -= g*y^2 ; y -= x^(1/alpha) ; x += g*y^2 + delta.
F32_FN void flystel(uint32_t x[F32_WORDS], uint32_t y[F32_WORDS], const AnemoiConsts& c) {
    uint32_t t[F32_WORDS];
    f32_mont_sqr(t, y, c.p, c.n0);
    mul_g(t, t, c);
    f32_sub(x, x, t, c.p);
    exp_inv_alpha(t, x, c);
    f32_sub(y, y, t, c.p);
    f32_mont_sqr(t, y, c.p, c.n0);
    mul_g(t, t, c);
    f32_add(x, x, t, c.p);
    f32_add(x, x, c.delta, c.p);
}

// The linear layer and the pseudo-Hadamard transform.  Width 4 does four
// products by the generator (mul_g); width 2 does none.
template <int W>
F32_FN void mds(uint32_t s[W][F32_WORDS], const AnemoiConsts& c) {
    if constexpr (W == 2) {
        f32_add(s[1], s[1], s[0], c.p);
        f32_add(s[0], s[0], s[1], c.p);
    } else {
        uint32_t t[F32_WORDS];
        mul_g(t, s[1], c);
        f32_add(s[0], s[0], t, c.p);
        mul_g(t, s[0], c);
        f32_add(s[1], s[1], t, c.p);
        mul_g(t, s[2], c);
        f32_add(s[3], s[3], t, c.p);
        mul_g(t, s[3], c);
        f32_add(s[2], s[2], t, c.p);
        // swap the two y words, then the pseudo-Hadamard transform
        copy8(t, s[2]);
        copy8(s[2], s[3]);
        copy8(s[3], t);
        f32_add(s[2], s[2], s[0], c.p);
        f32_add(s[3], s[3], s[1], c.p);
        f32_add(s[0], s[0], s[2], c.p);
        f32_add(s[1], s[1], s[3], c.p);
    }
}

// The permutation, in place: rounds x (ARK, MDS, S-box), then MDS.
template <int W>
F32_FN void permute_state(uint32_t s[W][F32_WORDS], const AnemoiConsts& c) {
    constexpr int COLS = W / 2;
#pragma unroll 1
    for (int r = 0; r < (int)c.rounds; ++r) {
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
            f32_add(s[i], s[i], c.C[r * COLS + i], c.p);
            f32_add(s[COLS + i], s[COLS + i], c.D[r * COLS + i], c.p);
        }
        mds<W>(s, c);
#pragma unroll
        for (int i = 0; i < COLS; ++i) flystel(s[i], s[COLS + i], c);
    }
    mds<W>(s, c);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

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
