// Batched Anemoi permutation and fused fixed-length sponge on Hopper
// (sm_90a), for every field: 8 words for the five 20-limb fields, 12 for
// BLS12-377 and BLS12-381.
//
// permute_kernel<W> replaces anemoi_tpu/ff/pallas_backend.py:
// permutation_pallas: int32 [W*L, N] -> int32 [W*L, N], the permutation
// of every state.  sponge_kernel<W> replaces pallas_backend.py:sponge_pallas:
// int32 [E*L, N] messages of E >= rate elements -> int32 [L, N] digests
// (both shipped widths have a digest of one element).  Both keep the TPU
// kernels' I/O contract: limb-major (limb row r of lane n at r*N + n), 13-bit
// limbs in Montgomery form with R = 2^(13L), canonical in and out; L = 20
// or 30.
//
// Design.  One thread per state (permutation) or per message (sponge);
// neighbouring threads own neighbouring lanes, so every limb row is read and
// written coalesced.  The entry and exit conversions are jive.cu's
// (f32_from_limbs: one Montgomery product into R' = 2^(32 NW) words;
// f32_to_limbs: one product back), and the permutation is the body that
// jive.cu runs (anemoi32.cuh).  Like jive.cu, the file is built twice,
// -DANEMOI_WORDS=8 and 12.
//   * The sponge keeps its state in registers for all ceil(E / rate)
//     permutations of a message.  Element j is read as a coalesced limb
//     row, converted on entry and added into rate word j % rate.  Blocks
//     run as one rolled loop over one permutation body: in the last block
//     of a message whose length is not a multiple of the rate, the word
//     after the last element (row `tail`) takes sigma = 1 in place of an
//     element.  When the rate divides E, the reference adds sigma to the
//     last capacity word after the last permutation: it never reaches the
//     digest (pallas_backend.py:554-558), so it is not added.
//   * The TPU kernel's 8-row padding of rate, tail and output rows and its
//     grid / pl.when staging exist for Mosaic's tiling; here a loop inside
//     the thread takes the place of the sequential grid axis.
//   * E is a runtime argument and loops stay rolled, so four
//     instantiations (permutation and sponge, width 2 and 4) build in
//     seconds.  The ragged edge of N is masked in the kernel.
//   * Everything but the kernels and their launchers is __host__ __device__,
//     so the host tests build this file with g++ and run permute_lane and
//     sponge_lane.
//
// Bound on the card: 32-bit integer multiply-adds.  A Vesta 4_3 permutation
// is 28 Flystels of 250 squarings (208 IMADs) and 47 products (264 IMADs)
// with the reference's addition chain, plus 15 MDS layers of 4 products by
// the generator: ~1.82 M IMADs; a 10 KB message (331 elements) takes 111 of
// them and reads 26,480 bytes, so the sponge is compute-bound by four orders
// of magnitude.  A BLS12-381 4_3 permutation is ~6.17 M IMADs (12-word
// squarings of 456 IMADs, products of 588), and a 10 KB message (218
// elements of 47 bytes) takes 73 of them.  chip_smoke.py computes the
// bound; PERF.md has the numbers.  What the design does about that: nothing
// yet, as in jive.cu.  At 4,096 messages the grid is 32 blocks of 128
// threads, a quarter of the 132 SMs.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

#define BLOCK 128

// The permutation of one state: limb row r of the state at in[r * n] and
// out[r * n].  out may equal in.
template <int W, int NW>
F32_FN void permute_lane(int32_t* out, const int32_t* in, size_t n, const AnemoiConsts<NW>& c) {
    constexpr int NL = f32_limbs<NW>;
    uint32_t s[W][NW];
#pragma unroll
    for (int w = 0; w < W; ++w) f32_from_limbs<NW>(s[w], in + (size_t)w * NL * n, n, c.c_in, c.p, c.n0);
    permute_state<W, NW>(s, c);
#pragma unroll
    for (int w = 0; w < W; ++w) f32_to_limbs<NW>(out + (size_t)w * NL * n, n, s[w], c.c_out, c.p, c.n0);
}

// The sponge over one message of E elements (E >= 0; the wrappers send
// E >= rate): limb row r of the message at in[r * n], of the digest at
// out[r * n].  rate = W - 1 for both shipped widths.
template <int W, int NW>
F32_FN void sponge_lane(int32_t* out, const int32_t* in, size_t n, int E, const AnemoiConsts<NW>& c) {
    constexpr int RATE = W - 1, NL = f32_limbs<NW>;
    uint32_t s[W][NW];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
        for (int j = 0; j < NW; ++j) s[w][j] = 0;
    // the last block holds the tail and sigma when RATE does not divide E
    const int blocks = (E + RATE - 1) / RATE;
#pragma unroll 1
    for (int b = 0; b < blocks; ++b) {
#pragma unroll
        for (int i = 0; i < RATE; ++i) {
            const int j = b * RATE + i;
            if (j < E) {
                uint32_t e[NW];
                f32_from_limbs<NW>(e, in + (size_t)j * NL * n, n, c.c_in, c.p, c.n0);
                f32_add<NW>(s[i], s[i], e, c.p);
            } else if (j == E) {
                f32_add<NW>(s[i], s[i], c.one, c.p);
            }
        }
        permute_state<W, NW>(s, c);
    }
    f32_to_limbs<NW>(out, n, s[0], c.c_out, c.p, c.n0);
}

#ifdef __CUDACC__
using Consts = AnemoiConsts<ANEMOI_WORDS>;

template <int W>
__global__ void __launch_bounds__(BLOCK) permute_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                                        long long n, const __grid_constant__ Consts c) {
    const long long lane = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (lane >= n) return;  // the ragged edge
    permute_lane<W, ANEMOI_WORDS>(out + lane, in + lane, (size_t)n, c);
}

template <int W>
__global__ void __launch_bounds__(BLOCK) sponge_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                                       long long n, int E, const __grid_constant__ Consts c) {
    const long long lane = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (lane >= n) return;  // the ragged edge
    sponge_lane<W, ANEMOI_WORDS>(out + lane, in + lane, (size_t)n, E, c);
}

extern "C" {

// Launches the permutation of n states of `width` on `stream` of `device`;
// returns the launch's cudaError_t.
int anemoi_permute(const void* in, void* out, long long n, int width, const void* consts, int device, void* stream) {
    if (width != 2 && width != 4) return (int)cudaErrorInvalidValue;
    Consts c;
    memcpy(&c, consts, sizeof c);
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK)), block(BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    return launch_on(device, [&] {
        if (width == 2)
            permute_kernel<2><<<grid, block, 0, s>>>(x, y, n, c);
        else
            permute_kernel<4><<<grid, block, 0, s>>>(x, y, n, c);
    });
}

// Launches the sponge over n messages of E >= width - 1 elements on
// `stream` of `device`; returns the launch's cudaError_t.
int anemoi_sponge(const void* in, void* out, long long n, int width, int E, const void* consts, int device,
                  void* stream) {
    if ((width != 2 && width != 4) || E < width - 1) return (int)cudaErrorInvalidValue;
    Consts c;
    memcpy(&c, consts, sizeof c);
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK)), block(BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    return launch_on(device, [&] {
        if (width == 2)
            sponge_kernel<2><<<grid, block, 0, s>>>(x, y, n, E, c);
        else
            sponge_kernel<4><<<grid, block, 0, s>>>(x, y, n, E, c);
    });
}

const char* anemoi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The layout of the constants this library takes: 507 words at 8, 759 at 12.
int anemoi_sponge_consts_words(void) { return (int)(sizeof(Consts) / 4); }
}
#endif  // __CUDACC__
