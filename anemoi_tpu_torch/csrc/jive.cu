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
//     ARK, MDS and open Flystel, then a final MDS; loops rolled.  Then the
//     feed-forward sum.
//   * x^(1/alpha) is a left-to-right sliding window of 4 bits
//     (anemoi32.cuh:exp_inv_alpha): a table of the odd powers x, x^3, ...,
//     x^15, then per window its squarings and one product by an entry.  The
//     table is 8 entries of NW words a thread, 32 KB a 128-thread block at 8
//     words and 48 KB (the static limit) at 12, so it lives in shared memory,
//     thread-major: word j of entry e of thread t at [(e NW + j) BLOCK + t],
//     so a warp's 32 loads of one word fall in 32 banks.  The product reads
//     its table operand word by word from there (one load a word step), so
//     no entry is copied into registers.  Each thread reads only its own
//     slots, so no barrier is needed; width 4 runs its two columns one after
//     the other and reuses the table.
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
// it issues fewer products.  The window does 316 operations per Vesta
// x^(1/alpha) and 468 per BLS12-381 one, where a binary ladder does 377 and
// 573 and the reference's chain 293 and 454; the chain would need 13
// to 30 live temporaries, which do not fit beside the 12-word width-4
// state (246 to 254 registers, no spill, PERF.md).  And for the Pasta
// moduli (Vesta, Pallas) the launcher picks jive_pasta_kernel, whose
// products reduce under F32PastaModulus (field32.cuh): 120 IMADs a squaring
// and 176 a product, three wide products a word step of the reduction
// where any p needs eight and the multiply for m.  In the SASS of one
// operation alone (a kernel of one squaring or one product between its
// loads and stores, less those, built for PERF.md's count) a squaring is
// 346 instructions against 381 and a product 392 against 448,
// yet the kernel takes 0.82 times the time (PERF.md): the time follows the
// wide products on the multiply-add pipe more than the instruction count.
// Every product is still plain C, without Hopper's
// carry-chained multiply-adds (mad.lo.cc / madc.hi): the next step on the
// product, for every field; the carries' IMAD.X and the zeroed high halves
// of the wide products' addends (IMAD.MOV) are what is left on that pipe.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

#define BLOCK 128

// Jive-k of one state: limb row r of the state at in[r * n], of the result
// at out[r * n]; tab holds INV_ALPHA_TABLE * NW words at `stride` apart, the
// thread's window table (ThreadArith).  The field's p must have the shape
// Mod (field32.cuh).
template <int W, int K, int NW, class Mod = F32AnyModulus>
F32_FN void jive_lane(int32_t* out, const int32_t* in, size_t n, const AnemoiConsts<NW>& c, uint32_t* tab,
                      int stride) {
    constexpr int OUT = W / K, NL = f32_limbs<NW>;
    uint32_t s[W][NW];
#pragma unroll
    for (int w = 0; w < W; ++w) f32_from_limbs<NW, Mod>(s[w], in + (size_t)w * NL * n, n, c.c_in, c.p, c.n0);
    // the input half of the feed-forward sum, taken before the permutation
    uint32_t ff[OUT][NW];
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
        f32_copy<NW>(ff[i], s[i]);
#pragma unroll
        for (int j = 1; j < K; ++j) f32_add<NW>(ff[i], ff[i], s[i + OUT * j], c.p);
    }
    permute_state<W>(s, ThreadArith<NW, Mod>{c, tab, stride});
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
#pragma unroll
        for (int j = 0; j < K; ++j) f32_add<NW>(ff[i], ff[i], s[i + OUT * j], c.p);
        f32_to_limbs<NW, Mod>(out + (size_t)i * NL * n, n, ff[i], c.c_out, c.p, c.n0);
    }
}

#ifdef __CUDACC__
using Consts = AnemoiConsts<ANEMOI_WORDS>;

// The blocks an SM each width is built for, the second bound of
// __launch_bounds__: it caps the registers and changes how ptxas schedules
// the code.  Each is the fastest value of 1 to 8 without spills in
// `python3 -m anemoi_tpu_torch.bounds_sweep` over 2^20 states on an H100
// 80GB HBM3 at 700 W (PERF.md has the table); a value replaced the one
// before only when faster by more than the sweep's own noise (the shipped
// build against its twin).  The sweep builds with each value given by -D;
// measure again when nvcc changes.  JIVE2_PASTA_MIN_BLOCKS,
// JIVE42_PASTA_MIN_BLOCKS and JIVE44_PASTA_MIN_BLOCKS bound
// jive_pasta_kernel<2, 2>, <4, 2> and <4, 4> (8 words only): at 4 blocks
// <4, 4> builds without spills and <4, 2> does not.  JIVE44_MIN_BLOCKS
// bounds jive_kernel<4, 4> apart from <4, 2>, JIVE4_MIN_BLOCKS's value
// unless the sweep gives it one of its own.
#if ANEMOI_WORDS == 8
#ifndef JIVE2_MIN_BLOCKS
#define JIVE2_MIN_BLOCKS 6
#endif
#ifndef JIVE2_PASTA_MIN_BLOCKS
#define JIVE2_PASTA_MIN_BLOCKS 7
#endif
#ifndef JIVE42_PASTA_MIN_BLOCKS
#define JIVE42_PASTA_MIN_BLOCKS 3
#endif
#ifndef JIVE44_PASTA_MIN_BLOCKS
#define JIVE44_PASTA_MIN_BLOCKS 4
#endif
#else
#ifndef JIVE2_MIN_BLOCKS
#define JIVE2_MIN_BLOCKS 3
#endif
#endif
#ifndef JIVE4_MIN_BLOCKS
#define JIVE4_MIN_BLOCKS 1
#endif
#ifndef JIVE44_MIN_BLOCKS
#define JIVE44_MIN_BLOCKS JIVE4_MIN_BLOCKS
#endif

template <int W, int K>
__global__ void __launch_bounds__(BLOCK, W == 2 ? JIVE2_MIN_BLOCKS : K == 2 ? JIVE4_MIN_BLOCKS : JIVE44_MIN_BLOCKS)
    jive_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n,
                const __grid_constant__ Consts c) {
    __shared__ uint32_t tab[INV_ALPHA_TABLE * ANEMOI_WORDS * BLOCK];  // 32 KB at 8 words, 48 KB at 12
    const long long lane = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (lane >= n) return;  // the ragged edge
    jive_lane<W, K, ANEMOI_WORDS>(out + lane, in + lane, (size_t)n, c, tab + threadIdx.x, BLOCK);
}

#if ANEMOI_WORDS == 8
// jive_kernel with its products compiled for the Pasta moduli (Vesta,
// Pallas): F32PastaModulus, which the launcher checks c.p and c.n0 against.
template <int W, int K>
__global__ void __launch_bounds__(BLOCK, W == 2 ? JIVE2_PASTA_MIN_BLOCKS
                                   : K == 2 ? JIVE42_PASTA_MIN_BLOCKS
                                            : JIVE44_PASTA_MIN_BLOCKS)
    jive_pasta_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n,
                      const __grid_constant__ Consts c) {
    __shared__ uint32_t tab[INV_ALPHA_TABLE * ANEMOI_WORDS * BLOCK];  // 32 KB
    const long long lane = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (lane >= n) return;  // the ragged edge
    jive_lane<W, K, 8, F32PastaModulus>(out + lane, in + lane, (size_t)n, c, tab + threadIdx.x, BLOCK);
}
#endif

extern "C" {

// 1 where p and n0 of the constants have the Pasta moduli's shape, so that
// anemoi_jive launches jive_pasta_kernel; 0 otherwise.
int anemoi_jive_pasta(const void* consts) {
    Consts c;
    memcpy(&c, consts, sizeof c);
    return f32_has_shape<ANEMOI_WORDS, F32PastaModulus>(c.p, c.n0);
}

// Launches Jive-k on `stream` of `device`; returns the launch's cudaError_t.
// The kernel follows from the constants (anemoi_jive_pasta): *pasta says
// which (1 or 0).  The calling thread's current device is the same
// afterwards.
int anemoi_jive(const void* in, void* out, long long n, int width, int k, const void* consts, int* pasta,
                int device, void* stream) {
    if (!((width == 2 && k == 2) || (width == 4 && (k == 2 || k == 4)))) return (int)cudaErrorInvalidValue;
    Consts c;
    memcpy(&c, consts, sizeof c);
    *pasta = anemoi_jive_pasta(consts);
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK)), block(BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    return launch_on(device, [&] {
#if ANEMOI_WORDS == 8
        if (*pasta) {
            if (width == 2)
                jive_pasta_kernel<2, 2><<<grid, block, 0, s>>>(x, y, n, c);
            else if (k == 2)
                jive_pasta_kernel<4, 2><<<grid, block, 0, s>>>(x, y, n, c);
            else
                jive_pasta_kernel<4, 4><<<grid, block, 0, s>>>(x, y, n, c);
            return;
        }
#endif
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

// Blocks of jive_kernel<width, k> (pasta 0) or jive_pasta_kernel<width, k>
// (pasta 1; 8 words only) resident on one SM of the current device
// (registers and shared memory permitting), or -1 on an error.
int anemoi_jive_blocks_per_sm(int width, int k, int pasta) {
    int blocks = -1;
    cudaError_t err = cudaErrorInvalidValue;
    if (!pasta) {
        if (width == 2 && k == 2)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_kernel<2, 2>, BLOCK, 0);
        else if (width == 4 && k == 2)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_kernel<4, 2>, BLOCK, 0);
        else if (width == 4 && k == 4)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_kernel<4, 4>, BLOCK, 0);
    }
#if ANEMOI_WORDS == 8
    else if (width == 2 && k == 2)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_pasta_kernel<2, 2>, BLOCK, 0);
    else if (width == 4 && k == 2)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_pasta_kernel<4, 2>, BLOCK, 0);
    else if (width == 4 && k == 4)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, jive_pasta_kernel<4, 4>, BLOCK, 0);
#endif
    return err == cudaSuccess ? blocks : -1;
}
}
#endif  // __CUDACC__
