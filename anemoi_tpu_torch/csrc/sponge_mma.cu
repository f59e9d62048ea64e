// Batched Anemoi permutation and fused fixed-length sponge on Hopper
// (sm_90a) with the Montgomery reduction on the integer tensor cores, for
// every field: 8 words for the five 20-limb fields, 12 for BLS12-377 and
// BLS12-381.
//
// Replaces anemoi_tpu/ff/pallas_backend.py:permutation_pallas (its
// pallas_call at :430) and sponge_pallas (:610) as the JAX package ships
// them, with their product mxu_ops.mont_mul_mxu (mul_impl "mxuf", its
// default, and "mxu", "mxus", "mxu2", "mxu3"), whose two products by
// constants run on the TPU's matrix unit.  The I/O contracts are
// sponge.cu's: the permutation, int32 [W*L, N] -> int32 [W*L, N]; the sponge,
// int32 [E*L, N] messages of E >= rate elements -> int32 [L, N] digests;
// limb-major, 13-bit limbs in Montgomery form with R = 2^(13L), canonical.
// The constants are sponge.cu's AnemoiConsts plus the B fragments of
// mxu_ops.fragment_words.
//
// Two forms of the same arithmetic (field32_mma.cuh), as the integer
// kernels of sponge.cu have a four-lane and a one-thread form:
//   * The quad form, one state a quad, 8 a warp (MmaArith in anemoi32.cuh):
//     each element word-sliced over its quad's four lanes; the bilinear
//     half of a product runs on the integer pipe with the quad's shuffles,
//     its reduction as two mma.sync u8 products by constants.
//     sponge_mma_kernel at every N, and permute_mma_kernel up to
//     PERMUTE_MMA_GROUP_MAX states.
//   * The thread form, one state a thread, 32 a warp (MmaThreadArith, the
//     product of jive_mma.cu): each element whole in its thread, the
//     reduction on the tensor cores through the warp's scratch rows.
//     permute_mma_thread_kernel above PERMUTE_MMA_GROUP_MAX.
// Both run x^(1/alpha) as the 4-bit window (Vesta: 253 squarings and 63
// products, against the ladder's 253 and 124; BLS12-381: 379 and 89 against
// 380 and 193), its table in shared memory.
//
// What bounds them on this card, and what the design does about it.  At
// BatchedSponge's batch, 4,096 states or messages, the only size at which the
// port's sponge runs, the card's 528 schedulers (132 SMs x 4) hold about one
// warp each, so one warp's chain of dependent instructions sets the time, not
// the rate the card issues at.  The first form of these kernels held two
// states a quad (469 lane-instructions a product at 8 words, 256 warps) and
// ran x^(1/alpha) as the binary ladder: a Vesta 4_3 sponge over 4,096
// messages of 10 KB took 613.758 ms against a bound of 18.486 (an NVIDIA H100
// 80GB HBM3 at 700.00 W, PERF.md).  One state a quad puts 4,096 messages on
// 512 warps and cuts a product to 292 lane-instructions (a trip of the window
// over both columns of width 4, sass.py), and the window cuts the products of
// x^(1/alpha) by about a sixth (Vesta) and a fifth (BLS12-381): 457.892 ms on
// the same card, 4.0% of the bound, where 1.6x fewer instructions a product
// gave 1.34x the speed.  A trip still takes about 1,850 cycles for 584
// instructions, so the chain's latency, not the instructions, is what is left
// (the quad form does 2x the work at 8,192 states in 1.26x the time).  Above
// the crossover the card is full, and the instructions a state a product set
// the time: the thread form (jive_mma.cu's product) runs one in about 454
// lane-instructions a state, the quad form in 292 on each of a state's four
// lanes, and at 65,536 states the thread form ran 17.497 ms against the quad
// form's 32.879, so the permutation takes it there.  The sponge has no
// crossover: on the port's paths it runs at 4,096 messages or fewer (the
// bench's sponge and BatchedSponge's .batch take no mul_impl).  The bound is
// the larger of each product's IMADs left on the integer pipe (NW^2 products
// of 32 x 32 -> 64 bits, 2 IMADs each), the tensor cores' u8 MACs (4 NW x 4
// NW for m, 4 NW x (4 NW + 2) for U) and the bytes; PERF.md has the
// numbers.
//
// Every lane of a warp must reach every mma, so there is no early return at
// the ragged edge: a state or message at or past N reads as zero and is not
// stored.  E is the same for every message, so the sponge's loop and its
// conversions run in lockstep over the warp; a dead message runs every
// product on zeros.  Everything but the kernels and their launchers is
// __host__ __device__, so the host tests build this file with g++ and run
// the warp bodies over HostWarp, the whole warp in one object.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

// The most states for which anemoi_permute_mma launches the quad form
// (permute_mma_kernel); above it, the thread form (permute_mma_thread_kernel).
// The largest N of 4,096, 8,192, 16,384 and 65,536 at which the quad form
// was the faster of the two on an NVIDIA H100 80GB HBM3 at 700.00 W (Vesta
// 4_3 at 8 words, BLS12-381 4_3 at 12; PERF.md).
#define PERMUTE_MMA_GROUP_MAX 8192

// The form anemoi_permute_mma launches for n states: the quad form (true)
// or the thread form; `kernel` 1 or 0 names one, whatever n, and a negative
// `kernel` picks by n.
F32_FN bool permute_mma_quad(long long n, int kernel) { return kernel < 0 ? n <= PERMUTE_MMA_GROUP_MAX : kernel != 0; }

// The permutation of the 8 states from `base` under the quad form (warp
// policy M): limb row r of the states at in[r * n], of the result at
// out[r * n].  out may equal in: the warp reads its states before it writes.
template <int W, int NW, class M>
F32_FN void permute_mma_warp(int32_t* out, const int32_t* in, long long n, long long base,
                             const MmaArith<NW, M>& ar) {
    constexpr int NL = f32_limbs<NW>;
    typename MmaArith<NW, M>::Elem s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) mma_from_limbs<NW, M>(ar, s[w], in + (size_t)w * NL * n, n, base);
    permute_state<W>(s, ar);
#pragma unroll
    for (int w = 0; w < W; ++w) mma_to_limbs<NW, M>(ar, out + (size_t)w * NL * n, n, base, s[w]);
}

// The permutation of the 32 states from `base` under the thread form: as
// jive_mma.cu's jive_mma_warp without the feed-forward sum.
template <int W, int NW, class M>
F32_FN void permute_mma_thread_warp(int32_t* out, const int32_t* in, long long n, long long base,
                                    const MmaThreadArith<NW, M>& ar) {
    constexpr int NL = f32_limbs<NW>;
    typename MmaThreadArith<NW, M>::Elem s[W];
#pragma unroll
    for (int w = 0; w < W; ++w) mt_from_limbs<NW, M>(ar, s[w], in + (size_t)w * NL * n, n, base);
    permute_state<W>(s, ar);
#pragma unroll
    for (int w = 0; w < W; ++w) mt_to_limbs<NW, M>(ar, out + (size_t)w * NL * n, n, base, s[w]);
}

// The sponge over the 8 messages of E elements from `base` under the quad
// form (E >= 0; the wrappers send E >= rate): limb row r of the messages at
// in[r * n], of the digests at out[r * n].  rate = W - 1 for both shipped
// widths.  The state starts at zero and stays in registers for all
// ceil(E / rate) permutations; element j enters through mma_from_limbs and
// is added into rate word j % rate; in the last block of a message whose
// length is not a multiple of the rate, sigma = 1 goes in at the word after
// the last element; when the rate divides E, sigma would go to the last
// capacity word after the last permutation, which never reaches the digest
// (pallas_backend.py:554-558), so it is not added.  The digest (one element
// for both shipped widths) leaves through mma_to_limbs.
template <int W, int NW, class M>
F32_FN void sponge_mma_warp(int32_t* out, const int32_t* in, long long n, int E, long long base,
                            const MmaArith<NW, M>& ar) {
    using A = MmaArith<NW, M>;
    constexpr int RATE = W - 1, NL = f32_limbs<NW>;
    typename A::Elem s[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
        for (int i = 0; i < M::T; ++i)
#pragma unroll
            for (int j = 0; j < NW / 4; ++j) s[w][i][j] = 0;
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
                ar.add(s[i], s[i], ar.c.one);
            }
        }
        permute_state<W>(s, ar);
    }
    mma_to_limbs<NW, M>(ar, out, n, base, s[0]);
}

// Words of the quad form's window table a thread: 8 entries of each of
// the width's W / 2 columns, S words each.
template <int W, int NW>
constexpr int mma_tab_words = INV_ALPHA_TABLE * (W / 2) * (NW / 4);

#ifdef __CUDACC__
using Consts = AnemoiConsts<ANEMOI_WORDS>;
constexpr int FRAG_WORDS = mma_frag_words<ANEMOI_WORDS>;

// Warps a block of the quad form.  At 4,096 states or messages one-warp
// blocks give 512 blocks, which reach every SM; the card's cap of 32
// resident blocks an SM sits above what the registers allow.  bounds_sweep.py
// builds 2 and 4 by -D to time them beside it.
#ifndef MMA_BLOCK_WARPS
#define MMA_BLOCK_WARPS 1
#endif
#define MMA_BLOCK (MMA_BLOCK_WARPS * MMA_WARP)
#define MMA_BLOCK_STATES (MMA_BLOCK_WARPS * MMA_STATES)

// Warps a block of the thread form: jive_mma.cu's 4, whose body it runs;
// bounds_sweep.py builds 1 and 2 by -D.
#ifndef PERMUTE_MMA_THREAD_BLOCK_WARPS
#define PERMUTE_MMA_THREAD_BLOCK_WARPS 4
#endif
#define MT_BLOCK (PERMUTE_MMA_THREAD_BLOCK_WARPS * MMA_WARP)
constexpr int MT_SMEM_BYTES = mt_smem_words<ANEMOI_WORDS>(MT_BLOCK) * 4;  // 45,312 at 8 words, 66,048 at 12

// The register budget each kernel is built for, the second bound of
// __launch_bounds__, counted in blocks of 128 threads an SM (MMA_MIN_RESIDENT
// in field32_mma.cuh), as in jive.cu, sponge.cu and jive_mma.cu, from
// `python3 -m anemoi_tpu_torch.bounds_sweep --sources sponge_mma.cu
// --values 1,2,3,4,5,6` on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md has
// the table): the quad form's permutation at 4,096 states and its sponge
// over 4,096 messages of 10 KB, the thread form's permutation at 65,536
// states.  A value replaced the one before only when it ran faster, without
// spills, by more than the identical builds of the kernel differed (the
// shipped build, value 1 and the thread form's two block shapes, for a
// quad-form kernel): only the 12-word quad permutation, at 2 (10.482 ms
// against 10.760 to 10.812).  The thread form's values that spill ran faster
// at 8 words (4: 15.637 ms against 17.446, 56 bytes spilled) and are not
// taken, as in jive_mma.cu.  Blocks of 2 and 4 warps for the quad form and
// of 1 and 2 for the thread form ran no faster.  Measure again when nvcc
// changes or the kernels do.
#if ANEMOI_WORDS == 8
#ifndef PERMUTE_MMA_MIN_BLOCKS
#define PERMUTE_MMA_MIN_BLOCKS 1
#endif
#else
#ifndef PERMUTE_MMA_MIN_BLOCKS
#define PERMUTE_MMA_MIN_BLOCKS 2
#endif
#endif
#ifndef SPONGE_MMA_MIN_BLOCKS
#define SPONGE_MMA_MIN_BLOCKS 1
#endif
#ifndef PERMUTE_MMA_THREAD_MIN_BLOCKS
#define PERMUTE_MMA_THREAD_MIN_BLOCKS 2
#endif

// The quad form's start: copies the constants' fragments to shared memory
// and returns the first state of the thread's warp.
__device__ __forceinline__ long long mma_block_start(uint32_t* sfrag, const uint32_t* frag) {
    static_assert(MMA_BLOCK % MMA_WARP == 0, "an mma takes a whole warp");
    for (int i = threadIdx.x; i < FRAG_WORDS; i += MMA_BLOCK) sfrag[i] = frag[i];
    __syncthreads();
    return (long long)blockIdx.x * MMA_BLOCK_STATES + threadIdx.x / MMA_WARP * MMA_STATES;
}

// The quad form's arithmetic over the fragments and the thread's slots of
// the window table (stride MMA_BLOCK).
__device__ __forceinline__ MmaArith<ANEMOI_WORDS, WarpMma> mma_arith(const Consts& c, const uint32_t* sfrag,
                                                                     uint32_t* stab) {
    return MmaArith<ANEMOI_WORDS, WarpMma>(c, sfrag, stab + threadIdx.x, MMA_BLOCK);
}

template <int W>
__global__ void __launch_bounds__(MMA_BLOCK, MMA_MIN_RESIDENT(PERMUTE_MMA_MIN_BLOCKS, MMA_BLOCK))
    permute_mma_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n,
                       const __grid_constant__ Consts c, const uint32_t* __restrict__ frag) {
    __shared__ uint32_t sfrag[FRAG_WORDS];
    __shared__ uint32_t stab[mma_tab_words<W, ANEMOI_WORDS> * MMA_BLOCK];  // 4 KB a warp at 8 words, 6 KB at 12
    const long long base = mma_block_start(sfrag, frag);
    permute_mma_warp<W, ANEMOI_WORDS, WarpMma>(out, in, n, base, mma_arith(c, sfrag, stab));
}

template <int W>
__global__ void __launch_bounds__(MMA_BLOCK, MMA_MIN_RESIDENT(SPONGE_MMA_MIN_BLOCKS, MMA_BLOCK))
    sponge_mma_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n, int E,
                      const __grid_constant__ Consts c, const uint32_t* __restrict__ frag) {
    __shared__ uint32_t sfrag[FRAG_WORDS];
    __shared__ uint32_t stab[mma_tab_words<W, ANEMOI_WORDS> * MMA_BLOCK];
    const long long base = mma_block_start(sfrag, frag);
    sponge_mma_warp<W, ANEMOI_WORDS, WarpMma>(out, in, n, E, base, mma_arith(c, sfrag, stab));
}

template <int W>
__global__ void __launch_bounds__(MT_BLOCK, MMA_MIN_RESIDENT(PERMUTE_MMA_THREAD_MIN_BLOCKS, MT_BLOCK))
    permute_mma_thread_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n,
                              const __grid_constant__ Consts c, const uint32_t* __restrict__ frag) {
    static_assert(MT_BLOCK % MMA_WARP == 0, "an mma takes a whole warp");
    extern __shared__ __align__(16) uint32_t smem[];  // jive_mma.cu's layout (mt_smem_words)
    uint32_t* sfrag = smem;
    mt_copy_fragments<ANEMOI_WORDS>(sfrag, frag, threadIdx.x, MT_BLOCK);
    __syncthreads();
    const int warp = threadIdx.x / MMA_WARP;
    uint32_t* rows = smem + mt_frag_words<ANEMOI_WORDS> + warp * MMA_THREAD_STATES * MMA_ROW_WORDS;
    uint32_t* tab = smem + mt_frag_words<ANEMOI_WORDS> + MT_BLOCK * MMA_ROW_WORDS + threadIdx.x;
    const long long base = (long long)blockIdx.x * MT_BLOCK + warp * MMA_THREAD_STATES;
    permute_mma_thread_warp<W, ANEMOI_WORDS, WarpMma>(out, in, n, base,
                                                      MmaThreadArith<ANEMOI_WORDS, WarpMma>{c, sfrag, rows, tab, MT_BLOCK});
}

// The thread form's kernel of `width`, its dynamic shared memory allowed up
// to MT_SMEM_BYTES (above the default 48 KB at 12 words).
static const void* permute_mma_thread_kernel_of(int width) {
    const void* f = width == 2 ? (const void*)permute_mma_thread_kernel<2> : (const void*)permute_mma_thread_kernel<4>;
    cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, MT_SMEM_BYTES);
    return f;
}

static dim3 mma_grid(long long n) { return dim3((unsigned)((n + MMA_BLOCK_STATES - 1) / MMA_BLOCK_STATES)); }

extern "C" {

// Launches the permutation of n states of `width` on `stream` of `device`:
// with kernel < 0, the quad form up to PERMUTE_MMA_GROUP_MAX states and the
// thread form above; with kernel 1 or 0, the first or the second whatever
// n.  frag is a device pointer to the field's fragment words.  Writes 1 or
// 0 to *launched for the form it launched; returns the launch's cudaError_t.
int anemoi_permute_mma(const void* in, void* out, long long n, int width, int kernel, const void* consts,
                       const void* frag, int* launched, int device, void* stream) {
    if (width != 2 && width != 4) return (int)cudaErrorInvalidValue;
    const bool quad = permute_mma_quad(n, kernel);
    Consts c;
    memcpy(&c, consts, sizeof c);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    const uint32_t* f = (const uint32_t*)frag;
    *launched = quad;
    return launch_on(device, [&] {
        if (quad && width == 2) {
            permute_mma_kernel<2><<<mma_grid(n), MMA_BLOCK, 0, s>>>(x, y, n, c, f);
        } else if (quad) {
            permute_mma_kernel<4><<<mma_grid(n), MMA_BLOCK, 0, s>>>(x, y, n, c, f);
        } else {
            const dim3 grid((unsigned)((n + MT_BLOCK - 1) / MT_BLOCK));
            permute_mma_thread_kernel_of(width);
            if (width == 2)
                permute_mma_thread_kernel<2><<<grid, MT_BLOCK, MT_SMEM_BYTES, s>>>(x, y, n, c, f);
            else
                permute_mma_thread_kernel<4><<<grid, MT_BLOCK, MT_SMEM_BYTES, s>>>(x, y, n, c, f);
        }
    });
}

long long anemoi_permute_mma_group_max(void) { return PERMUTE_MMA_GROUP_MAX; }

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

// Threads a block of kernel 0 (permute_mma_kernel), 1 (sponge_mma_kernel)
// or 2 (permute_mma_thread_kernel).
int anemoi_sponge_mma_block_threads(int kernel) { return kernel == 2 ? MT_BLOCK : MMA_BLOCK; }

// Blocks resident on one SM of the current device of kernel 0
// (permute_mma_kernel), 1 (sponge_mma_kernel) or 2
// (permute_mma_thread_kernel) at `width`, registers and shared memory
// permitting, or -1 on an error.
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
    else if (kernel == 2)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, permute_mma_thread_kernel_of(width), MT_BLOCK,
                                                            MT_SMEM_BYTES);
    return err == cudaSuccess ? blocks : -1;
}
}
#endif  // __CUDACC__
