// Two microbenchmarks on Hopper (sm_90a): the counterparts of the repo's
// two TPU measurement kernels, which measure the card's integer
// multiply-add rate.
//
//   * sqr_chain_kernel<NW> replaces tools/mxu_prototype.py:chain_kernel
//     (its sos / sosp / mxu / cios2 schedules of one function): int32
//     [L, N] -> int32 [L, N], n_iter serial Montgomery squarings of each
//     lane, with the hash kernels' entry and exit conversions
//     (f32_from_limbs, f32_to_limbs) around them.  Here there is one
//     schedule, field32.cuh's f32_mont_sqr, at 8 words (L = 20) and 12
//     words (L = 30).  Its slope between two trip counts is the cost of one
//     squaring: 208 IMADs at 8 words, 456 at 12.
//   * mad_loop_kernel replaces tools/microbench_layout.py:time_body's
//     kernel: each element runs acc = (acc * acc + i) & 0x1FFF for
//     i = 0 .. n_iter - 1, one thread per element.  int32 arithmetic wraps
//     mod 2^32 as in XLA; the mask keeps acc below 2^13 after the first
//     iteration.  Its slope is the iterations an SM sustains a clock: the
//     measured counterpart of the 64 IMADs per clock per SM of the card's
//     throughput table, though an iteration also compiles to
//     about 1.75 integer add and logic instructions besides its IMAD
//     (PERF.md reads the SASS).  On the TPU the question
//     was layout (vregs at 1/8 sublane use); on the card it is how many
//     instructions an SM starts a clock, so microbench.py adds a shape
//     that fills every SM.
//
// Bound: operations (the loops read and write each element once).  Design:
// one thread per lane, loops rolled (#pragma unroll 1 on the chain) so the
// slope counts squarings and not code size; nothing else.  Both lane
// functions are __host__ __device__, so the host tests build them with g++.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

#define BLOCK 128

// n_iter squarings of one lane: limb row r at in[r * n] and out[r * n].
template <int NW>
F32_FN void sqr_chain_lane(int32_t* out, const int32_t* in, size_t n, int n_iter, const AnemoiConsts<NW>& c) {
    uint32_t a[NW];
    f32_from_limbs<NW>(a, in, n, c.c_in, c.p, c.n0);
#pragma unroll 1
    for (int i = 0; i < n_iter; ++i) f32_mont_sqr<NW>(a, a, c.p, c.n0);
    f32_to_limbs<NW>(out, n, a, c.c_out, c.p, c.n0);
}

// n_iter dependent multiply-adds and masks of one element.
F32_FN int32_t mad_lane(int32_t x, int n_iter) {
    uint32_t acc = (uint32_t)x;
    for (int i = 0; i < n_iter; ++i) acc = (acc * acc + (uint32_t)i) & 0x1FFFu;
    return (int32_t)acc;
}

#ifdef __CUDACC__
template <int NW>
__global__ void __launch_bounds__(BLOCK) sqr_chain_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                                          long long n, int n_iter,
                                                          const __grid_constant__ AnemoiConsts<NW> c) {
    const long long lane = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (lane >= n) return;  // the ragged edge
    sqr_chain_lane<NW>(out + lane, in + lane, (size_t)n, n_iter, c);
}

__global__ void __launch_bounds__(BLOCK) mad_loop_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                                         long long n, int n_iter) {
    const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
    if (i >= n) return;
    out[i] = mad_lane(in[i], n_iter);
}

extern "C" {

// Launches n_iter squarings of n lanes of a `words`-word field (limb-major
// int32 [L, n]) on `stream` of `device`; returns the launch's cudaError_t.
int anemoi_sqr_chain(const void* in, void* out, long long n, int n_iter, int words, const void* consts, int device,
                     void* stream) {
    if ((words != 8 && words != 12) || n_iter < 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK)), block(BLOCK);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* x = (const int32_t*)in;
    int32_t* y = (int32_t*)out;
    if (words == 8) {
        AnemoiConsts<8> c;
        memcpy(&c, consts, sizeof c);
        return launch_on(device, [&] { sqr_chain_kernel<8><<<grid, block, 0, s>>>(x, y, n, n_iter, c); });
    }
    AnemoiConsts<12> c;
    memcpy(&c, consts, sizeof c);
    return launch_on(device, [&] { sqr_chain_kernel<12><<<grid, block, 0, s>>>(x, y, n, n_iter, c); });
}

// Launches the multiply-add loop over n int32 elements on `stream` of
// `device`; returns the launch's cudaError_t.
int anemoi_mad_loop(const void* in, void* out, long long n, int n_iter, int device, void* stream) {
    if (n_iter < 0) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n + BLOCK - 1) / BLOCK)), block(BLOCK);
    return launch_on(device, [&] {
        mad_loop_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const int32_t*)in, (int32_t*)out, n, n_iter);
    });
}

const char* anemoi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The layout of the constants anemoi_sqr_chain takes for `words`, or -1.
int anemoi_microbench_consts_words(int words) {
    return words == 8 ? (int)(sizeof(AnemoiConsts<8>) / 4) : words == 12 ? (int)(sizeof(AnemoiConsts<12>) / 4) : -1;
}
}
#endif  // __CUDACC__
