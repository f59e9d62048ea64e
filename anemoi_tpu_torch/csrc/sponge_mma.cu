// Batched Anemoi permutation and fused fixed-length sponge on Hopper
// (sm_90a) with the Montgomery reduction on the integer tensor cores, for
// every field: 8 words for the five 20-limb fields, 12 for BLS12-377 and
// BLS12-381.
//
// Replaces anemoi_tpu/ff/pallas_backend.py:permutation_pallas and
// sponge_pallas as the JAX package ships them, with their product
// mxu_ops.mont_mul_mxu (mul_impl "mxuf", its default, and "mxu", "mxus",
// "mxu2", "mxu3"), whose two products by constants run on the TPU's matrix
// unit.  The I/O contracts are sponge.cu's: permute_mma_kernel<W>, int32
// [W*L, N] -> int32 [W*L, N]; sponge_mma_kernel<W>, int32 [E*L, N] messages
// of E >= rate elements -> int32 [L, N] digests; limb-major, 13-bit limbs in
// Montgomery form with R = 2^(13L), canonical.  The constants are sponge.cu's
// AnemoiConsts plus the B fragments of mxu_ops.fragment_words.
//
// Design.  The arithmetic is jive_mma.cu's (MmaArith in anemoi32.cuh over
// field32_mma.cuh): a warp runs 16 states or messages, quad g the two of
// fragment rows g and g + 8, each word-sliced over its four lanes; every
// product's reduction is two mma.sync u8 products by constants, whose
// fragments are copied to shared memory once a block.  x^(1/alpha) is the
// binary ladder (LOCKSTEP).
//   * permute_mma_warp is jive_mma_warp without the feed-forward sum: each
//     element enters through mma_from_limbs (one product by c_in), one
//     permute_state, each leaves through mma_to_limbs (one by c_out).  One
//     kernel for every N: no crossover, as the four-lane and one-thread
//     integer kernels have.
//   * sponge_mma_warp is sponge.cu's sponge_group over MmaArith: the state
//     starts at zero and stays in registers for all ceil(E / rate)
//     permutations; element j enters through mma_from_limbs and is added
//     into rate word j % rate; in the last block of a message whose length
//     is not a multiple of the rate, sigma = 1 goes in at the word after
//     the last element; when the rate divides E, sigma would go to the last
//     capacity word after the last permutation, which never reaches the
//     digest (pallas_backend.py:554-558), so it is not added.  The digest
//     (one element for both shipped widths) leaves through mma_to_limbs.
//   * Block shape.  At BatchedSponge's batch, 4,096 states or messages are
//     256 warps; a block of four warps, as jive_mma_kernel's, would give 64
//     blocks and leave 68 of the card's 132 SMs without work.  A block is
//     one warp (MMA_BLOCK_WARPS), so 4,096 give 256 blocks, which reach
//     every SM.  At 65,536 (4,096 blocks) the card's cap of 32 resident
//     blocks an SM sits above what the registers allow (at most 16 warps
//     an SM at 128 registers), so one-warp blocks cost no occupancy there
//     either; each block copies the constants' fragments once (2.3 KB at 8
//     words, 4.9 KB at 12).  Measured (python3 -m
//     anemoi_tpu_torch.bounds_sweep --sources sponge_mma.cu, an H100 80GB
//     HBM3 at 700 W): blocks of 2 and 4 warps, which leave SMs idle at
//     4,096, ran within 1% of one warp in 7 of 8 cases (the 12-word
//     permutation at 4,096 states 3% faster with 4, inside the 3.4% that
//     the shipped build and its twin differed by), since a scheduler holds
//     at most one warp either way and that warp's chain of products sets
//     the time.
//   * Every lane of a warp must reach every mma, so there is no early
//     return at the ragged edge: a state or message at or past N reads as
//     zero and is not stored.  E is the same for every message, so the
//     sponge's loop and its conversions run in lockstep over the warp; a
//     dead message runs every product on zeros.
//   * Everything but the kernels and their launchers is __host__ __device__,
//     so the host tests build this file with g++ and run both warp bodies
//     over HostWarp, the whole warp in one object.
//
// What bounds it on the card is what bounds jive_mma_kernel (jive_mma.cu's
// header): per product of 16 states the IMADs left on the integer pipe
// (NW^2 products of 32 x 32 -> 64 bits, 2 IMADs each) and the tensor cores'
// u8 MACs (4 NW x 4 NW for m, 4 NW x (4 NW + 2) for U), and the group code
// around them.  A Vesta 4_3 permutation is 28 Flystels and 15 MDS layers,
// a 10 KB message 111 permutations; chip_smoke.py (phase 19) computes the
// bound for each size, and PERF.md has the numbers.  At 4,096 states a
// scheduler holds half a warp on average, so the latency of one warp's
// chain of products sets the time, not the rate the card issues at.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

// The permutation of the 16 states from `base` (warp policy M): limb row r
// of the states at in[r * n], of the result at out[r * n]; frag holds the
// constants' fragments.  out may equal in: the warp reads its states before
// it writes.
template <int W, int NW, class M>
F32_FN void permute_mma_warp(int32_t* out, const int32_t* in, long long n, long long base,
                             const AnemoiConsts<NW>& c, const uint32_t* frag) {
    using A = MmaArith<NW, M>;
    constexpr int NL = f32_limbs<NW>;
    const A ar(c, frag);
    typename A::Elem s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) mma_from_limbs<NW, M>(ar, s[w], in + (size_t)w * NL * n, n, base);
    permute_state<W>(s, ar);
#pragma unroll
    for (int w = 0; w < W; ++w) mma_to_limbs<NW, M>(ar, out + (size_t)w * NL * n, n, base, s[w]);
}

// The sponge over the 16 messages of E elements from `base` (E >= 0; the
// wrappers send E >= rate): limb row r of the messages at in[r * n], of the
// digests at out[r * n].  rate = W - 1 for both shipped widths.
template <int W, int NW, class M>
F32_FN void sponge_mma_warp(int32_t* out, const int32_t* in, long long n, int E, long long base,
                            const AnemoiConsts<NW>& c, const uint32_t* frag) {
    using A = MmaArith<NW, M>;
    constexpr int RATE = W - 1, NL = f32_limbs<NW>;
    const A ar(c, frag);
    typename A::Elem s[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < M::T; ++i)
#pragma unroll
                for (int j = 0; j < NW / 4; ++j) s[w][h][i][j] = 0;
    // the last block holds the tail and sigma when RATE does not divide E
    const int blocks = (E + RATE - 1) / RATE;
#pragma unroll 1
    for (int b = 0; b < blocks; ++b) {
#pragma unroll
        for (int i = 0; i < RATE; ++i) {
            const int j = b * RATE + i;
            if (j < E) {
                typename A::Elem e;
                mma_from_limbs<NW, M>(ar, e, in + (size_t)j * NL * n, n, base);
                ar.add(s[i], s[i], e);
            } else if (j == E) {
                ar.add(s[i], s[i], c.one);
            }
        }
        permute_state<W>(s, ar);
    }
    mma_to_limbs<NW, M>(ar, out, n, base, s[0]);
}

#ifdef __CUDACC__
using Consts = AnemoiConsts<ANEMOI_WORDS>;
constexpr int FRAG_WORDS = mma_frag_words<ANEMOI_WORDS>;

// Warps a block (the header's "Block shape"); bounds_sweep.py builds 2 and
// 4 by -D to time them beside it.
#ifndef MMA_BLOCK_WARPS
#define MMA_BLOCK_WARPS 1
#endif
#define MMA_BLOCK (MMA_BLOCK_WARPS * MMA_WARP)
#define MMA_BLOCK_STATES (MMA_BLOCK_WARPS * MMA_STATES)

// The register budget each kernel is built for, the second bound of
// __launch_bounds__, counted as in jive.cu, sponge.cu and jive_mma.cu: in
// blocks of 128 threads an SM (a value v caps a thread at 65,536 / (128 v)
// registers), so that one value means one budget in every source; the bound
// given to the compiler is that many warps' worth of these blocks.  From
// `python3 -m anemoi_tpu_torch.bounds_sweep --sources sponge_mma.cu` on an
// H100 80GB HBM3 at 700 W (PERF.md has the table): the permutation at 4,096
// and 65,536 states, the sponge over 4,096 messages of 10 KB.  1, no cap
// below 255 registers: every value without spills ran within the sweep's
// noise of it, and the values that spill were at most 3.8% faster (the
// permutation at 65,536).  At 12 words permute_mma_kernel<4> spills 12
// bytes at 255 registers, the least of any value.  Measure again when nvcc
// changes or the kernels do.
#ifndef PERMUTE_MMA_MIN_BLOCKS
#define PERMUTE_MMA_MIN_BLOCKS 1
#endif
#ifndef SPONGE_MMA_MIN_BLOCKS
#define SPONGE_MMA_MIN_BLOCKS 1
#endif
#define MMA_MIN_RESIDENT(v) ((v) * 128 / MMA_BLOCK)

// Copies the constants' fragments to shared memory and returns the first
// state of the thread's warp.
__device__ __forceinline__ long long mma_block_start(uint32_t* sfrag, const uint32_t* frag) {
    static_assert(MMA_BLOCK % MMA_WARP == 0, "an mma takes a whole warp");
    for (int i = threadIdx.x; i < FRAG_WORDS; i += MMA_BLOCK) sfrag[i] = frag[i];
    __syncthreads();
    return (long long)blockIdx.x * MMA_BLOCK_STATES + threadIdx.x / MMA_WARP * MMA_STATES;
}

template <int W>
__global__ void __launch_bounds__(MMA_BLOCK, MMA_MIN_RESIDENT(PERMUTE_MMA_MIN_BLOCKS))
    permute_mma_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n,
                       const __grid_constant__ Consts c, const uint32_t* __restrict__ frag) {
    __shared__ uint32_t sfrag[FRAG_WORDS];
    const long long base = mma_block_start(sfrag, frag);
    permute_mma_warp<W, ANEMOI_WORDS, WarpMma>(out, in, n, base, c, sfrag);
}

template <int W>
__global__ void __launch_bounds__(MMA_BLOCK, MMA_MIN_RESIDENT(SPONGE_MMA_MIN_BLOCKS))
    sponge_mma_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n, int E,
                      const __grid_constant__ Consts c, const uint32_t* __restrict__ frag) {
    __shared__ uint32_t sfrag[FRAG_WORDS];
    const long long base = mma_block_start(sfrag, frag);
    sponge_mma_warp<W, ANEMOI_WORDS, WarpMma>(out, in, n, E, base, c, sfrag);
}

static dim3 mma_grid(long long n) { return dim3((unsigned)((n + MMA_BLOCK_STATES - 1) / MMA_BLOCK_STATES)); }

extern "C" {

// Launches the permutation of n states of `width` on `stream` of `device`;
// frag is a device pointer to the field's fragment words.  Returns the
// launch's cudaError_t.
int anemoi_permute_mma(const void* in, void* out, long long n, int width, const void* consts, const void* frag,
                       int device, void* stream) {
    if (width != 2 && width != 4) return (int)cudaErrorInvalidValue;
    Consts c;
    memcpy(&c, consts, sizeof c);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    const uint32_t* f = (const uint32_t*)frag;
    return launch_on(device, [&] {
        if (width == 2)
            permute_mma_kernel<2><<<mma_grid(n), MMA_BLOCK, 0, s>>>(x, y, n, c, f);
        else
            permute_mma_kernel<4><<<mma_grid(n), MMA_BLOCK, 0, s>>>(x, y, n, c, f);
    });
}

// Launches the sponge over n messages of E >= width - 1 elements on
// `stream` of `device`; returns the launch's cudaError_t.
int anemoi_sponge_mma(const void* in, void* out, long long n, int width, int E, const void* consts,
                      const void* frag, int device, void* stream) {
    if ((width != 2 && width != 4) || E < width - 1) return (int)cudaErrorInvalidValue;
    Consts c;
    memcpy(&c, consts, sizeof c);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    const uint32_t* f = (const uint32_t*)frag;
    return launch_on(device, [&] {
        if (width == 2)
            sponge_mma_kernel<2><<<mma_grid(n), MMA_BLOCK, 0, s>>>(x, y, n, E, c, f);
        else
            sponge_mma_kernel<4><<<mma_grid(n), MMA_BLOCK, 0, s>>>(x, y, n, E, c, f);
    });
}

const char* anemoi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The layout of the constants this library takes: 507 words at 8, 759 at 12.
int anemoi_sponge_mma_consts_words(void) { return (int)(sizeof(Consts) / 4); }

// The fragment words it takes: 576 at 8 words, 1,248 at 12.
int anemoi_sponge_mma_frag_words(void) { return FRAG_WORDS; }

// Threads a block of either kernel.
int anemoi_sponge_mma_block_threads(void) { return MMA_BLOCK; }

// Blocks resident on one SM of the current device of kernel 0
// (permute_mma_kernel) or 1 (sponge_mma_kernel) at `width`, or -1 on an
// error.
int anemoi_sponge_mma_blocks_per_sm(int kernel, int width) {
    int blocks = -1;
    cudaError_t err = cudaErrorInvalidValue;
    const bool w2 = width == 2;
    if (width != 2 && width != 4) return -1;
    if (kernel == 0)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, w2 ? &permute_mma_kernel<2> : &permute_mma_kernel<4>, MMA_BLOCK, 0);
    else if (kernel == 1)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, w2 ? &sponge_mma_kernel<2> : &sponge_mma_kernel<4>, MMA_BLOCK, 0);
    return err == cudaSuccess ? blocks : -1;
}
}
#endif  // __CUDACC__
