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
// Design.  One state a thread, 32 a warp (MmaThreadArith in anemoi32.cuh
// over field32_mma.cuh's one-state-a-thread product): each element lies
// whole in its thread as NW words, as in jive.cu, and every product is the
// thread's bilinear half (NW^2 word products, or NW (NW + 1) / 2 for a
// squaring) and the warp's reduction, whose two products by constants,
// m = T_low p' mod R' and U = m p, run as mma.sync m16n8k32 u8 x u8 -> s32
// (a 12-word field adds an m16n8k16 step for its 48 bytes of K) with the
// warp's 32 states as two m16 tiles: NW / 2 n8 tiles for m and NW / 2 + 1
// for U's high half and the low half's top two columns.  Operands reach
// the A fragments through each state's row of the warp's scratch and
// ldmatrix; each lane recombines its byte columns of four states into word
// slices and hands each back through the state's row; all carries then run
// in the owning thread.  x^(1/alpha) is the 4-bit window, as in jive.cu,
// its table of odd powers in shared memory (8 entries of NW words a
// thread).  The constants' fragments are copied lane-major to shared
// memory once a block (2.3 KB at 8 words; 6.5 KB at 12, a lane's three
// registers padded to one 16-byte load).  Every lane of a warp must reach
// every mma, so there is no early return at the ragged edge: a state at or
// past N reads as zero and is not stored.  Entry and exit are jive.cu's
// conversions (one product by c_in, one by c_out), run as the same
// products.
//
// What bounds it on the card, per product at 8 words (12 in brackets): the
// IMADs of the bilinear half, NW^2 = 64 [144] 32 x 32 -> 64-bit word
// products, 2 IMADs each, half that for a squaring; the tensor cores' u8
// MACs, 32 states x 8 columns x 32 [48] K x 9 [13] tiles (of them the
// product needs 4 NW x 4 NW for m and 4 NW x (4 NW + 2) for U); and the
// work around them: the recombination of
// each lane's byte columns into words (a multiply-add by 2^8 or 2^16 a
// column), the scratch rows' stores and loads, the carry chains.  What the
// design does about each: the reduction's IMADs (136 [300] of f32_mont_mul's
// 264 [588]) move to the tensor cores; squarings, 80% of the window's
// products, run at half the bilinear cost; no carry crosses a lane; the low
// half of U is never summed.  sass.py counts the instructions of one
// squaring and one product, and bounds_sweep.py times the kernel; PERF.md
// has the numbers.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

// Jive-k of the 32 states from `base` (warp policy M, arithmetic ar): limb
// row r of the states at in[r * n], of the result at out[r * n].  A state
// at or past n reads as zero and is not written.
template <int W, int K, int NW, class M>
F32_FN void jive_mma_warp(int32_t* out, const int32_t* in, long long n, long long base,
                          const MmaThreadArith<NW, M>& ar) {
    using A = MmaThreadArith<NW, M>;
    constexpr int OUT = W / K, NL = f32_limbs<NW>;
    typename A::Elem s[W], ff[OUT];
#pragma unroll
    for (int w = 0; w < W; ++w) mt_from_limbs<NW, M>(ar, s[w], in + (size_t)w * NL * n, n, base);
    // the input half of the feed-forward sum, taken before the permutation
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
        ar.copy(ff[i], s[i]);
#pragma unroll
        for (int j = 1; j < K; ++j) ar.add(ff[i], ff[i], s[i + OUT * j]);
    }
    permute_state<W>(s, ar);
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
#pragma unroll
        for (int j = 0; j < K; ++j) ar.add(ff[o], ff[o], s[o + OUT * j]);
        mt_to_limbs<NW, M>(ar, out + (size_t)o * NL * n, n, base, ff[o]);
    }
}

#ifdef __CUDACC__
using Consts = AnemoiConsts<ANEMOI_WORDS>;
constexpr int FRAG_WORDS = mma_frag_words<ANEMOI_WORDS>;

// Warps a block; bounds_sweep.py builds other values by -D to time them.
#ifndef JIVE_MMA_BLOCK_WARPS
#define JIVE_MMA_BLOCK_WARPS 4
#endif
#define MMA_BLOCK (JIVE_MMA_BLOCK_WARPS * MMA_WARP)
constexpr int SMEM_BYTES = mt_smem_words<ANEMOI_WORDS>(MMA_BLOCK) * 4;  // 45,312 at 8 words, 66,048 at 12

// The register budget each width is built for, the second bound of
// __launch_bounds__, counted in blocks of 128 threads an SM (MMA_MIN_RESIDENT
// in field32_mma.cuh), as in sponge_mma.cu, from
// `python3 -m anemoi_tpu_torch.bounds_sweep --sources jive_mma.cu` over 2^20
// states on an H100 80GB HBM3 at 700 W (PERF.md has the table): 2 for both
// widths.  Width 2 ran within the sweep's noise (the shipped build against
// its twin) at every value without spills; width 4 ran faster at 2 than at
// 1 by more than it, and at 12 words spills at every value, 72 bytes at 1
// and 2, the fewest.  Budgets that spill more are not taken (width 4 at 8
// words ran 18% faster at 4 with 92 bytes spilled).  Blocks of 1 and 2
// warps ran no faster than 4.  Measure again when nvcc changes or the
// kernel does.
#ifndef JIVE_MMA2_MIN_BLOCKS
#define JIVE_MMA2_MIN_BLOCKS 2
#endif
#ifndef JIVE_MMA4_MIN_BLOCKS
#define JIVE_MMA4_MIN_BLOCKS 2
#endif

template <int W, int K>
__global__ void __launch_bounds__(MMA_BLOCK, MMA_MIN_RESIDENT(W == 2 ? JIVE_MMA2_MIN_BLOCKS : JIVE_MMA4_MIN_BLOCKS,
                                                              MMA_BLOCK))
    jive_mma_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n,
                    const __grid_constant__ Consts c, const uint32_t* __restrict__ frag) {
    static_assert(MMA_BLOCK % MMA_WARP == 0, "an mma takes a whole warp");
    extern __shared__ __align__(16) uint32_t smem[];  // mt_smem_words' layout
    uint32_t* sfrag = smem;
    mt_copy_fragments<ANEMOI_WORDS>(sfrag, frag, threadIdx.x, MMA_BLOCK);
    __syncthreads();
    const int warp = threadIdx.x / MMA_WARP;
    uint32_t* rows = smem + mt_frag_words<ANEMOI_WORDS> + warp * MMA_THREAD_STATES * MMA_ROW_WORDS;
    uint32_t* tab = smem + mt_frag_words<ANEMOI_WORDS> + MMA_BLOCK * MMA_ROW_WORDS + threadIdx.x;
    const long long base = (long long)blockIdx.x * MMA_BLOCK + warp * MMA_THREAD_STATES;
    jive_mma_warp<W, K, ANEMOI_WORDS, WarpMma>(out, in, n, base,
                                              MmaThreadArith<ANEMOI_WORDS, WarpMma>{c, sfrag, rows, tab, MMA_BLOCK});
}

// The kernel of (width, k), or nullptr; its dynamic shared memory allowed
// up to SMEM_BYTES (above the default 48 KB at 12 words).
static const void* jive_mma_kernel_of(int width, int k) {
    const void* f = width == 2 && k == 2   ? (const void*)jive_mma_kernel<2, 2>
                    : width == 4 && k == 2 ? (const void*)jive_mma_kernel<4, 2>
                    : width == 4 && k == 4 ? (const void*)jive_mma_kernel<4, 4>
                                           : nullptr;
    if (f) cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    return f;
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
    const dim3 grid((unsigned)((n + MMA_BLOCK - 1) / MMA_BLOCK)), block(MMA_BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    const uint32_t* f = (const uint32_t*)frag;
    return launch_on(device, [&] {
        jive_mma_kernel_of(width, k);
        if (width == 2)
            jive_mma_kernel<2, 2><<<grid, block, SMEM_BYTES, s>>>(x, y, n, c, f);
        else if (k == 2)
            jive_mma_kernel<4, 2><<<grid, block, SMEM_BYTES, s>>>(x, y, n, c, f);
        else
            jive_mma_kernel<4, 4><<<grid, block, SMEM_BYTES, s>>>(x, y, n, c, f);
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
// device (registers and shared memory permitting), or -1 on an error.
int anemoi_jive_mma_blocks_per_sm(int width, int k) {
    int blocks = -1;
    const void* f = jive_mma_kernel_of(width, k);
    const cudaError_t err = f ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, MMA_BLOCK, SMEM_BYTES)
                              : cudaErrorInvalidValue;
    return err == cudaSuccess ? blocks : -1;
}
}
#endif  // __CUDACC__
