// Batched Anemoi permutation and fused fixed-length sponge on Hopper
// (sm_90a), for every field: 8 words for the five 20-limb fields, 12 for
// BLS12-377 and BLS12-381.
//
// permute_group_kernel<W> and permute_kernel<W> replace
// anemoi_tpu/ff/pallas_backend.py:permutation_pallas: int32 [W*L, N] ->
// int32 [W*L, N], the permutation of every state; anemoi_permute launches
// the first up to PERMUTE_GROUP_MAX states and the second above.
// sponge_kernel<W> replaces pallas_backend.py:sponge_pallas:
// int32 [E*L, N] messages of E >= rate elements -> int32 [L, N] digests
// (both shipped widths have a digest of one element).  Both keep the TPU
// kernels' I/O contract: limb-major (limb row r of lane n at r*N + n), 13-bit
// limbs in Montgomery form with R = 2^(13L), canonical in and out; L = 20
// or 30.
//
// Design.  Like jive.cu, the file is built twice, -DANEMOI_WORDS=8 and 12.
//   * The permutation has two kernels, one body (anemoi32.cuh).  At
//     BatchedSponge's batch, 4,096 states, one thread a state gives 128
//     warps for the card's 528 warp schedulers, and 100 of 132 SMs idle;
//     permute_group_kernel runs each state on four lanes, as the sponge
//     below runs a message (512 warps), entering and leaving through
//     g_from_limbs and g_to_limbs.  When the card is full the group's extra
//     instructions (shuffles, votes) cost more than the idle SMs did, so
//     above PERMUTE_GROUP_MAX states, a crossover measured on the card,
//     permute_kernel runs one thread a state: neighbouring threads own
//     neighbouring lanes, so every limb row is read and written coalesced;
//     the entry and exit conversions are jive.cu's (f32_from_limbs: one
//     Montgomery product into R' = 2^(32 NW) words; f32_to_limbs: one
//     product back), and x^(1/alpha) is jive.cu's 4-bit window over a table
//     in shared memory (ThreadArith).  The group kernel keeps the sponge's
//     binary ladder (GroupArith).
//   * The sponge runs four lanes per message: four adjacent lanes of a
//     warp, so a warp holds 8 messages and a 128-thread block 32.  Each lane
//     holds its slice of every state word, words [l S, l S + S) of 8 or 12,
//     S = 2 or 3, and the group does all the field arithmetic together
//     (field32_group.cuh: word-sliced Montgomery products and adds, through
//     shuffles and votes of width 4; GroupArith in anemoi32.cuh).  The two
//     Flystel columns of a width-4 round run in lockstep, so their shuffle
//     latencies overlap; width 2 has one column and cannot.  Why: one thread
//     per message gave 4,096 messages 128 warps for the card's 528 warp
//     schedulers (132 SMs x 4), and one warp nearly fills a scheduler's
//     issue; four lanes a message give 512 warps, each with a quarter of the
//     stream.  At one warp a scheduler no other warp hides the latency of a
//     message's chain of dependent group products, so the group product
//     steps a lane's whole slice at a time, four Montgomery steps in place
//     of NW, which shortens its chain though it issues more instructions
//     (g_mont_mul_n).  Each lane reads all the limbs of an element (the
//     group's four reads share their sectors), packs them and keeps its
//     slice; the digest is gathered into every lane and lane l writes limbs
//     l, l + 4, ....
//   * The sponge keeps its state in registers for all ceil(E / rate)
//     permutations of a message.  Element j is converted on entry and added
//     into rate word j % rate.  Blocks run as one rolled loop over one
//     permutation body: in the last block of a message whose length is not
//     a multiple of the rate, the word after the last element (row `tail`)
//     takes sigma = 1 in place of an element.  When the rate divides E, the
//     reference adds sigma to the last capacity word after the last
//     permutation: it never reaches the digest (pallas_backend.py:554-558),
//     so it is not added.
//   * The TPU kernel's 8-row padding of rate, tail and output rows and its
//     grid / pl.when staging exist for Mosaic's tiling; here a loop inside
//     the group takes the place of the sequential grid axis.
//   * E is a runtime argument and loops stay rolled, so six
//     instantiations (two permutations and the sponge, width 2 and 4) build
//     in seconds.  The ragged edge of N is masked in the kernel: the
//     one-thread permutation's threads past it return; the groups past it
//     run on the last state or message and do not store, since every lane
//     of a warp takes part in every shuffle.
//   * Everything but the kernels and their launchers is __host__ __device__,
//     so the host tests build this file with g++ and run permute_lane,
//     sponge_lane (the sponge on one thread, which no kernel runs now), and
//     permute_group and sponge_group over HostLanes, the code the group
//     kernels run.
//
// Bound on the card: 32-bit integer multiply-adds.  A Vesta 4_3 permutation
// is 28 Flystels of 250 squarings (208 IMADs) and 47 products (264 IMADs)
// with the reference's addition chain, plus 15 MDS layers of 4 products by
// the generator: ~1.82 M IMADs; a 10 KB message (331 elements) takes 111 of
// them and reads 26,480 bytes, so the sponge is compute-bound by four orders
// of magnitude.  A BLS12-381 4_3 permutation is ~6.17 M IMADs (12-word
// squarings of 456 IMADs, products of 588), and a 10 KB message (218
// elements of 47 bytes) takes 73 of them.  PERF.md has the numbers.  The group
// product does the same word products as one thread, split four ways, plus
// three shuffles a word step and a few votes.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

#define BLOCK 128

// The permutation of one state: limb row r of the state at in[r * n] and
// out[r * n].  out may equal in.  tab holds INV_ALPHA_TABLE * NW words at
// `stride` apart, the thread's window table (ThreadArith).
template <int W, int NW>
F32_FN void permute_lane(int32_t* out, const int32_t* in, size_t n, const AnemoiConsts<NW>& c, uint32_t* tab,
                         int stride) {
    constexpr int NL = f32_limbs<NW>;
    uint32_t s[W][NW];
#pragma unroll
    for (int w = 0; w < W; ++w) f32_from_limbs<NW>(s[w], in + (size_t)w * NL * n, n, c.c_in, c.p, c.n0);
    permute_state<W>(s, ThreadArith<NW>{c, tab, stride});
#pragma unroll
    for (int w = 0; w < W; ++w) f32_to_limbs<NW>(out + (size_t)w * NL * n, n, s[w], c.c_out, c.p, c.n0);
}

// The sponge over one message of E elements (E >= 0; the wrappers send
// E >= rate): limb row r of the message at in[r * n], of the digest at
// out[r * n].  rate = W - 1 for both shipped widths.  tab: as permute_lane's.
template <int W, int NW>
F32_FN void sponge_lane(int32_t* out, const int32_t* in, size_t n, int E, const AnemoiConsts<NW>& c, uint32_t* tab,
                        int stride) {
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
        permute_state<W>(s, ThreadArith<NW>{c, tab, stride});
    }
    f32_to_limbs<NW>(out, n, s[0], c.c_out, c.p, c.n0);
}

// The permutation of one state on a group of four lanes (lane policy P,
// field32_group.cuh), as permute_lane with each state word sliced over the
// group: every lane reads all the limbs of the state at in[r * n]; lane l
// writes limbs l, l + 4, ... of each element at out[r * n] when `store`
// holds.  out may equal in: every read comes before the first write.
template <int W, int NW, class P>
F32_FN void permute_group(int32_t* out, const int32_t* in, size_t n, bool store, const AnemoiConsts<NW>& c) {
    constexpr int NL = f32_limbs<NW>, S = NW / 4;
    const GroupArith<NW, P> ar(c);
    uint32_t s[W][P::H][S];
#pragma unroll
    for (int w = 0; w < W; ++w) g_from_limbs<NW, P>(s[w], in + (size_t)w * NL * n, n, c.c_in, ar.p, ar.n0);
    permute_state<W>(s, ar);
#pragma unroll
    for (int w = 0; w < W; ++w) g_to_limbs<NW, P>(out + (size_t)w * NL * n, n, s[w], c.c_out, ar.p, ar.n0, store);
}

// The sponge over one message on a group of four lanes (lane policy P,
// field32_group.cuh): as sponge_lane, with each state word sliced over the
// group.  Every lane reads the message at in[r * n]; the digest is written
// at out[r * n] when `store` holds.
template <int W, int NW, class P>
F32_FN void sponge_group(int32_t* out, const int32_t* in, size_t n, int E, bool store, const AnemoiConsts<NW>& c) {
    constexpr int RATE = W - 1, NL = f32_limbs<NW>, S = NW / 4;
    const GroupArith<NW, P> ar(c);
    uint32_t s[W][P::H][S];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
        for (int h = 0; h < P::H; ++h)
#pragma unroll
            for (int j = 0; j < S; ++j) s[w][h][j] = 0;
    const int blocks = (E + RATE - 1) / RATE;
#pragma unroll 1
    for (int b = 0; b < blocks; ++b) {
#pragma unroll
        for (int i = 0; i < RATE; ++i) {
            const int j = b * RATE + i;
            if (j < E) {
                uint32_t e[P::H][S];
                g_from_limbs<NW, P>(e, in + (size_t)j * NL * n, n, c.c_in, ar.p, ar.n0);
                ar.add(s[i], s[i], e);
            } else if (j == E) {
                ar.add(s[i], s[i], c.one);
            }
        }
        permute_state<W>(s, ar);
    }
    g_to_limbs<NW, P>(out, n, s[0], c.c_out, ar.p, ar.n0, store);
}

#ifdef __CUDACC__
using Consts = AnemoiConsts<ANEMOI_WORDS>;

// The most states for which anemoi_permute launches permute_group_kernel
// (four lanes a state); above it, permute_kernel (one thread a state).  The
// largest N of 4,096, 8,192, 16,384 and 65,536 at which the group kernel
// was the faster of the two on an H100 80GB HBM3 at 700 W (Vesta 4_3 at 8
// words, BLS12-381 4_3 at 12; PERF.md).
#define PERMUTE_GROUP_MAX 8192

// The blocks an SM each permutation kernel is built for, the second bound
// of __launch_bounds__: it caps the registers and changes how ptxas
// schedules the code.  Each is the fastest value of 1 to 8 in `python3 -m
// anemoi_tpu_torch.bounds_sweep` on an H100 80GB HBM3 at 700 W (PERF.md has
// the table), the four-lane kernel at 4,096 states, the one-thread kernel
// at 65,536 and without spills (at 12 words the four-lane one spills 8
// bytes at width 4, outside its loop, and 4 blocks do not end it and run
// 1.24 times as long; at 6 its width-2 form spills as well); a value
// replaced the one before only when faster by more than the sweep's own
// noise (the shipped build against its twin).  The sweep builds with each
// value given by -D; measure again when nvcc changes.
#if ANEMOI_WORDS == 8
#ifndef PERMUTE_MIN_BLOCKS
#define PERMUTE_MIN_BLOCKS 5
#endif
#ifndef PERMUTE_GROUP_MIN_BLOCKS
#define PERMUTE_GROUP_MIN_BLOCKS 7
#endif
#else
#ifndef PERMUTE_MIN_BLOCKS
#define PERMUTE_MIN_BLOCKS 1
#endif
#ifndef PERMUTE_GROUP_MIN_BLOCKS
#define PERMUTE_GROUP_MIN_BLOCKS 5
#endif
#endif

template <int W>
__global__ void __launch_bounds__(BLOCK, PERMUTE_MIN_BLOCKS) permute_kernel(const int32_t* __restrict__ in,
                                                                            int32_t* __restrict__ out,
                                                                            long long n,
                                                                            const __grid_constant__ Consts c) {
    __shared__ uint32_t tab[INV_ALPHA_TABLE * ANEMOI_WORDS * BLOCK];  // 32 KB at 8 words, 48 KB at 12
    const long long lane = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (lane >= n) return;  // the ragged edge
    permute_lane<W, ANEMOI_WORDS>(out + lane, in + lane, (size_t)n, c, tab + threadIdx.x, BLOCK);
}

// Four lanes per state: thread t is lane t % 4 of state t / 4.
template <int W>
__global__ void __launch_bounds__(BLOCK, PERMUTE_GROUP_MIN_BLOCKS) permute_group_kernel(
    const int32_t* __restrict__ in, int32_t* __restrict__ out, long long n, const __grid_constant__ Consts c) {
    static_assert(BLOCK % 32 == 0, "the groups' shuffles need whole warps");
    const long long state = ((long long)blockIdx.x * BLOCK + threadIdx.x) / G32_LANES;
    const bool live = state < n;  // the ragged edge: a group past it runs on the last state, stores nothing
    const long long m = live ? state : n - 1;
    permute_group<W, ANEMOI_WORDS, WarpLanes>(out + m, in + m, (size_t)n, live, c);
}

// Four lanes per message: thread t is lane t % 4 of message t / 4.
template <int W>
__global__ void __launch_bounds__(BLOCK) sponge_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                                       long long n, int E, const __grid_constant__ Consts c) {
    static_assert(BLOCK % 32 == 0, "the groups' shuffles need whole warps");
    const long long msg = ((long long)blockIdx.x * BLOCK + threadIdx.x) / G32_LANES;
    const bool live = msg < n;  // the ragged edge: a group past it runs on the last message, stores nothing
    const long long m = live ? msg : n - 1;
    sponge_group<W, ANEMOI_WORDS, WarpLanes>(out + m, in + m, (size_t)n, E, live, c);
}

extern "C" {

// Launches the permutation of n states of `width` on `stream` of `device`:
// with kernel < 0, permute_group_kernel (4n threads) up to PERMUTE_GROUP_MAX
// states and permute_kernel (n threads) above; with kernel 1 or 0, the
// first or the second whatever n.  Writes 1 or 0 to *launched for the
// kernel it launched; returns the launch's cudaError_t.
int anemoi_permute(const void* in, void* out, long long n, int width, int kernel, const void* consts, int* launched,
                   int device, void* stream) {
    if (width != 2 && width != 4) return (int)cudaErrorInvalidValue;
    const bool group = kernel < 0 ? n <= PERMUTE_GROUP_MAX : kernel != 0;
    Consts c;
    memcpy(&c, consts, sizeof c);
    const long long threads = group ? G32_LANES * n : n;
    const dim3 grid((unsigned)((threads + BLOCK - 1) / BLOCK)), block(BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    *launched = group;
    return launch_on(device, [&] {
        if (group && width == 2)
            permute_group_kernel<2><<<grid, block, 0, s>>>(x, y, n, c);
        else if (group)
            permute_group_kernel<4><<<grid, block, 0, s>>>(x, y, n, c);
        else if (width == 2)
            permute_kernel<2><<<grid, block, 0, s>>>(x, y, n, c);
        else
            permute_kernel<4><<<grid, block, 0, s>>>(x, y, n, c);
    });
}

long long anemoi_permute_group_max(void) { return PERMUTE_GROUP_MAX; }

// Launches the sponge over n messages of E >= width - 1 elements on
// `stream` of `device`; returns the launch's cudaError_t.
int anemoi_sponge(const void* in, void* out, long long n, int width, int E, const void* consts, int device,
                  void* stream) {
    if ((width != 2 && width != 4) || E < width - 1) return (int)cudaErrorInvalidValue;
    Consts c;
    memcpy(&c, consts, sizeof c);
    const long long threads = G32_LANES * n;  // four lanes per message
    const dim3 grid((unsigned)((threads + BLOCK - 1) / BLOCK)), block(BLOCK);
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

// The sponge kernel's lanes per message.
int anemoi_sponge_lanes(void) { return G32_LANES; }

// Blocks resident on one SM of the current device (registers and shared
// memory permitting) of kernel 0 (permute_kernel), 1 (permute_group_kernel)
// or 2 (sponge_kernel) at `width`, or -1 on an error.
int anemoi_sponge_blocks_per_sm(int kernel, int width) {
    int blocks = -1;
    cudaError_t err = cudaErrorInvalidValue;
    const bool w2 = width == 2;
    if (width != 2 && width != 4) return -1;
    if (kernel == 0)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, w2 ? &permute_kernel<2> : &permute_kernel<4>,
                                                            BLOCK, 0);
    else if (kernel == 1)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, w2 ? &permute_group_kernel<2> : &permute_group_kernel<4>, BLOCK, 0);
    else if (kernel == 2)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, w2 ? &sponge_kernel<2> : &sponge_kernel<4>,
                                                            BLOCK, 0);
    return err == cudaSuccess ? blocks : -1;
}
}
#endif  // __CUDACC__
