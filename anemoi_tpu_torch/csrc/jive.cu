// Fused batched Jive-k on Hopper (sm_90a), for every field: 8 words for
// the five 20-limb fields, 12 for BLS12-377 and BLS12-381.
//
// Replaces anemoi_tpu/ff/pallas_backend.py:jive_pallas: the whole Anemoi
// permutation of one state, then the Jive-k feed-forward sum
//     out[i] = sum_j x[i + c*j] + P(x)[i + c*j],   c = WIDTH / k,
// with the TPU kernel's I/O contract: int32 [WIDTH*L, N] in, int32
// [(WIDTH/k)*L, N] out, limb-major (limb row r of lane n at r*N + n),
// 13-bit limbs in Montgomery form with R = 2^(13L), canonical output;
// L = 20 or 30.
//
// Design.  One thread per state; neighbouring threads own neighbouring
// lanes, so every limb row is read and written coalesced.  Inside, a field
// element is NW 32-bit words in Montgomery form with R' = 2^(32 NW)
// (field32.cuh): the 13-bit limbs and int8 pieces of the TPU kernel exist
// only because the TPU has no widening multiply.
//   * Entry (f32_from_limbs): the L limbs of an element are repacked into
//     words, and one Montgomery product by c_in = 2^(64 NW - 13L) mod p
//     turns a*2^(13L) into a*2^(32 NW).  Inputs must be canonical, as
//     everywhere in the port: a canonical row is below p.  Each limb is
//     read as its low 13 bits, and the bits of a row from 2^(32 NW) up (the
//     top of its last limb) are dropped, so a larger row is taken mod
//     2^(32 NW).
//   * The permutation (anemoi32.cuh, shared with sponge.cu): rounds of
//     ARK, MDS and open Flystel, then a final MDS; x^(1/alpha) by a binary
//     ladder; loops rolled.  Then the feed-forward sum.
//   * Exit (f32_to_limbs): one Montgomery product by c_out = 2^(13L) mod p,
//     then the words are cut back into 13-bit limbs.
//   * Constants (field words, round constants, exponent bits, rounds)
//     arrive in one struct passed by value; one instantiation per
//     (WIDTH, k) serves every field of the library's word count.  The file
//     is built twice, -DANEMOI_WORDS=8 and 12 (anemoi32.cuh).
//   * Everything but the kernel and its launcher is __host__ __device__,
//     so the host tests build this file with g++ and run jive_lane.
//
// Bound on the card: 32-bit integer multiply-adds, not memory.  A Vesta
// 2_1 Jive moves 240 bytes but needs, with the reference's addition chain,
// 5,250 Montgomery squarings (208 IMADs each, low and high halves) and
// 987 products (264 IMADs each): ~1.35 M IMADs; a BLS12-381 2_1 Jive moves
// 360 bytes and needs 7,980 squarings of 456 IMADs and 1,638 products of
// 588: ~4.6 M.  Compute-bound by three orders of magnitude (chip_smoke.py
// computes it; PERF.md has the numbers).  What the design does about that:
// nothing yet.  The ladder does more products than the addition chain
// (Vesta 29%, BLS12-381 26% more operations), and every product is a
// plain CIOS without Hopper's carry-chained multiply-adds.  At 12 words a
// width-4 state is 48 words, and ptxas spills (PERF.md).

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

#define BLOCK 128

// Jive-k of one state: limb row r of the state at in[r * n], of the result
// at out[r * n].
template <int W, int K, int NW>
F32_FN void jive_lane(int32_t* out, const int32_t* in, size_t n, const AnemoiConsts<NW>& c) {
    constexpr int OUT = W / K, NL = f32_limbs<NW>;
    uint32_t s[W][NW];
#pragma unroll
    for (int w = 0; w < W; ++w) f32_from_limbs<NW>(s[w], in + (size_t)w * NL * n, n, c.c_in, c.p, c.n0);
    // the input half of the feed-forward sum, taken before the permutation
    uint32_t ff[OUT][NW];
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
        f32_copy<NW>(ff[i], s[i]);
#pragma unroll
        for (int j = 1; j < K; ++j) f32_add<NW>(ff[i], ff[i], s[i + OUT * j], c.p);
    }
    permute_state<W>(s, ThreadArith<NW>{c});
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) f32_add<NW>(ff[i], ff[i], s[i + OUT * j], c.p);
        f32_to_limbs<NW>(out + (size_t)i * NL * n, n, ff[i], c.c_out, c.p, c.n0);
    }
}

#ifdef __CUDACC__
using Consts = AnemoiConsts<ANEMOI_WORDS>;

template <int W, int K>
__global__ void __launch_bounds__(BLOCK) jive_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                                     long long n, const __grid_constant__ Consts c) {
    const long long lane = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (lane >= n) return;  // the ragged edge
    jive_lane<W, K, ANEMOI_WORDS>(out + lane, in + lane, (size_t)n, c);
}

extern "C" {

// Launches Jive-k on `stream` of `device`; returns the launch's cudaError_t.
// The calling thread's current device is the same afterwards.
int anemoi_jive(const void* in, void* out, long long n, int width, int k, const void* consts, int device,
                void* stream) {
    if (!((width == 2 && k == 2) || (width == 4 && (k == 2 || k == 4)))) return (int)cudaErrorInvalidValue;
    Consts c;
    memcpy(&c, consts, sizeof c);
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK)), block(BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    return launch_on(device, [&] {
        if (width == 2)
            jive_kernel<2, 2><<<grid, block, 0, s>>>(x, y, n, c);
        else if (k == 2)
            jive_kernel<4, 2><<<grid, block, 0, s>>>(x, y, n, c);
        else
            jive_kernel<4, 4><<<grid, block, 0, s>>>(x, y, n, c);
    });
}

const char* anemoi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The layout of the constants this library takes: 507 words at 8, 759 at 12.
int anemoi_jive_consts_words(void) { return (int)(sizeof(Consts) / 4); }
}
#endif  // __CUDACC__
