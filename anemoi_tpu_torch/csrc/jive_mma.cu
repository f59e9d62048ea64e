// Fused batched Jive-k on Hopper (sm_90a) with the Montgomery reduction on
// the integer tensor cores, for every field: 8 words for the five 20-limb
// fields, 12 for BLS12-377 and BLS12-381.
//
// Replaces anemoi_tpu/ff/pallas_backend.py:jive_pallas as the JAX package
// ships it, with its product mxu_ops.mont_mul_mxu (mul_impl "mxuf", its
// default, and "mxu", "mxus", "mxu2", "mxu3"), whose two products by
// constants run on the TPU's matrix unit.  The I/O contract is jive.cu's:
// int32 [WIDTH*L, N] in, int32 [(WIDTH/k)*L, N] out, limb-major, 13-bit
// limbs in Montgomery form with R = 2^(13L), canonical; the constants are
// jive.cu's AnemoiConsts plus the B fragments of mxu_ops.fragment_words.
//
// Design.  A warp runs 16 states (field32_mma.cuh): quad g holds the
// states of fragment rows g and g + 8, each word-sliced over its four
// lanes as in the sponge kernel, so a state's bytes stay on its quad in the
// mma's A fragment and in its accumulator.  Every product (MmaArith in
// anemoi32.cuh) is T = a b on the integer pipe, word-sliced; then m = T_low
// p' mod R' and U = m p as mma.sync m16n8k32 u8 x u8 -> s32 (a 12-word
// field adds an m16n8k16 step for its 48 bytes of K): NW / 2 tiles for m
// and NW / 2 + 1 for U's high half and the low half's top two columns,
// whose sum gives the carry out of the low half.  The constants' fragments
// (2.3 KB at 8 words, 4.9 KB at 12) are copied to shared memory once a
// block, and each lane loads its B registers from there, 32 lanes on 32
// banks.  Every lane of a warp must reach every mma, so there is no early
// return at the ragged edge: a state at or past N reads as zero and is not
// stored.  x^(1/alpha) is the binary ladder (LOCKSTEP): the window under
// this policy is later work.  Entry and exit are jive.cu's conversions (one
// product by c_in, one by c_out), run as the same products.
//
// What bounds it on the card, per product of 16 states at 8 words (12 in
// brackets): the IMADs left on the integer pipe, the bilinear half, NW^2 =
// 64 [144] 32 x 32 -> 64-bit products, 2 IMADs each, about half of
// f32_mont_mul's (the reduction was 136 [300] of its 264 [588]); the
// tensor cores' u8 MACs, 16 rows x 8 columns x 32 [48] K x 9 [13] tiles =
// 36,864 [79,872] (chip_smoke.py's bound counts the columns the product
// needs, 4 NW x 4 NW for m and 4 NW x (4 NW + 2) for U); and the work the
// design adds around them: the group's shuffles (3 NW a product and state
// for T, a rotation each for the carries of m and of T + U), its votes and
// the recombination of each lane's byte columns into words (a multiply-add
// by 2^8, 2^16 or 2^24 a column).  What the design does about each: the
// reduction's IMADs move to the tensor cores; the low half of U is never
// summed; no byte of A or of an accumulator crosses lanes, only one
// overflow word a lane does.  The tensor cores are not what bounds it:
// sass.py counts the instructions of one product, and chip_smoke.py times
// the kernel beside jive_kernel; PERF.md has the numbers.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

#define MMA_BLOCK 128  // four warps, 64 states

// Jive-k of the 16 states from `base` (warp policy M): limb row r of the
// states at in[r * n], of the result at out[r * n]; frag holds the
// constants' fragments.
template <int W, int K, int NW, class M>
F32_FN void jive_mma_warp(int32_t* out, const int32_t* in, long long n, long long base, const AnemoiConsts<NW>& c,
                          const uint32_t* frag) {
    using A = MmaArith<NW, M>;
    constexpr int OUT = W / K, NL = f32_limbs<NW>;
    const A ar(c, frag);
    typename A::Elem s[W], ff[OUT];
#pragma unroll
    for (int w = 0; w < W; ++w) mma_from_limbs<NW, M>(ar, s[w], in + (size_t)w * NL * n, n, base);
    // the input half of the feed-forward sum, taken before the permutation
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
        ar.copy(ff[i], s[i]);
#pragma unroll
        for (int j = 1; j < K; ++j) ar.add(ff[i], ff[i], s[i + OUT * j]);
    }
    permute_state<W>(s, ar);
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) ar.add(ff[i], ff[i], s[i + OUT * j]);
        mma_to_limbs<NW, M>(ar, out + (size_t)i * NL * n, n, base, ff[i]);
    }
}

#ifdef __CUDACC__
using Consts = AnemoiConsts<ANEMOI_WORDS>;
constexpr int FRAG_WORDS = mma_frag_words<ANEMOI_WORDS>;

// The blocks an SM each width is built for, the second bound of
// __launch_bounds__, from `python3 -m anemoi_tpu_torch.bounds_sweep
// --sources jive_mma.cu` over 2^20 states on an H100 80GB HBM3 at 700 W
// (PERF.md has the tables): the first guess, 2 for width 2 and 1 for width
// 4, except 4 for width 4 at 8 words, faster than the guess by more than
// the sweep's own noise; values that spill are not taken.  The sweep builds with each value given by -D; measure again
// when nvcc changes or the kernel does.
#ifndef JIVE_MMA2_MIN_BLOCKS
#define JIVE_MMA2_MIN_BLOCKS 2
#endif
#ifndef JIVE_MMA4_MIN_BLOCKS
#define JIVE_MMA4_MIN_BLOCKS (ANEMOI_WORDS == 8 ? 4 : 1)
#endif

template <int W, int K>
__global__ void __launch_bounds__(MMA_BLOCK, W == 2 ? JIVE_MMA2_MIN_BLOCKS : JIVE_MMA4_MIN_BLOCKS)
    jive_mma_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n,
                    const __grid_constant__ Consts c, const uint32_t* __restrict__ frag) {
    static_assert(MMA_BLOCK % MMA_WARP == 0, "an mma takes a whole warp");
    __shared__ uint32_t sfrag[FRAG_WORDS];
    for (int i = threadIdx.x; i < FRAG_WORDS; i += MMA_BLOCK) sfrag[i] = frag[i];
    __syncthreads();
    const long long base = ((long long)blockIdx.x * MMA_BLOCK + threadIdx.x) / MMA_WARP * MMA_STATES;
    jive_mma_warp<W, K, ANEMOI_WORDS, WarpMma>(out, in, n, base, c, sfrag);
}

// One warp: d = a b for the lanes' fragment registers as given, a K = 32
// (m16n8k32) or K = 16 (m16n8k16) step, u8 x u8 -> s32; a [32][4] (K = 16:
// the first 2 of each lane's 4), b [32][2] (K = 16: the first), d [32][4].
// Holds the fragment layouts against HostWarp's.
__global__ void mma_check_kernel(const uint32_t* a, const uint32_t* b, int32_t* d, int k) {
    const int L = threadIdx.x;
    uint32_t ar[1][4] = {{a[4 * L], a[4 * L + 1], a[4 * L + 2], a[4 * L + 3]}}, br[1][2] = {{b[2 * L], b[2 * L + 1]}};
    int32_t dr[1][4] = {{0, 0, 0, 0}};
    if (k == 32) {
        WarpMma::mma<32>(dr, ar, br);
    } else {
        const uint32_t a16[1][2] = {{ar[0][0], ar[0][1]}}, b16[1][1] = {{br[0][0]}};
        WarpMma::mma<16>(dr, a16, b16);
    }
    for (int r = 0; r < 4; ++r) d[4 * L + r] = dr[0][r];
}

extern "C" {

// Launches Jive-k on `stream` of `device`; frag is a device pointer to the
// field's fragment words.  Returns the launch's cudaError_t.
int anemoi_jive_mma(const void* in, void* out, long long n, int width, int k, const void* consts, const void* frag,
                    int device, void* stream) {
    if (!((width == 2 && k == 2) || (width == 4 && (k == 2 || k == 4)))) return (int)cudaErrorInvalidValue;
    Consts c;
    memcpy(&c, consts, sizeof c);
    const dim3 grid((unsigned)((n + MMA_BLOCK / MMA_WARP * MMA_STATES - 1) / (MMA_BLOCK / MMA_WARP * MMA_STATES))),
        block(MMA_BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    const uint32_t* f = (const uint32_t*)frag;
    return launch_on(device, [&] {
        if (width == 2)
            jive_mma_kernel<2, 2><<<grid, block, 0, s>>>(x, y, n, c, f);
        else if (k == 2)
            jive_mma_kernel<4, 2><<<grid, block, 0, s>>>(x, y, n, c, f);
        else
            jive_mma_kernel<4, 4><<<grid, block, 0, s>>>(x, y, n, c, f);
    });
}

// One mma_check_kernel warp on device pointers.
int anemoi_mma_check(const void* a, const void* b, void* d, int k, int device, void* stream) {
    if (k != 32 && k != 16) return (int)cudaErrorInvalidValue;
    return launch_on(device, [&] {
        mma_check_kernel<<<1, MMA_WARP, 0, (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b,
                                                                   (int32_t*)d, k);
    });
}

const char* anemoi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The layout of the constants this library takes: 507 words at 8, 759 at 12.
int anemoi_jive_mma_consts_words(void) { return (int)(sizeof(Consts) / 4); }

// The fragment words it takes: 576 at 8 words, 1,248 at 12.
int anemoi_jive_mma_frag_words(void) { return FRAG_WORDS; }

// Blocks of jive_mma_kernel<width, k> resident on one SM of the current
// device, or -1 on an error.
int anemoi_jive_mma_blocks_per_sm(int width, int k) {
    int blocks = -1;
    cudaError_t err = cudaErrorInvalidValue;
    if (width == 2 && k == 2)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_mma_kernel<2, 2>, MMA_BLOCK, 0);
    else if (width == 4 && k == 2)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_mma_kernel<4, 2>, MMA_BLOCK, 0);
    else if (width == 4 && k == 4)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_mma_kernel<4, 4>, MMA_BLOCK, 0);
    return err == cudaSuccess ? blocks : -1;
}
}
#endif  // __CUDACC__
