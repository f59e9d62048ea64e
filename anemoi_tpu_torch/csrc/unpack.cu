// Byte messages -> Montgomery limbs on Hopper (sm_90a), for every field: 8
// words for the five 20-limb fields, 12 for BLS12-377 and BLS12-381.
//
// Replaces, on the card, the host's byte path in front of the sponge: the
// native packer (native/anemoi_host.cpp:anemoi_pack_bytes: chunking, the
// pad byte, 13-bit limbs), the stack into [E, L, B] and the plain domain
// conversion (limb_ops.to_mont).  In: one bucket's messages, each E
// elements long, joined into one byte buffer, with each message's int64
// offset into it and its length (row 0 and row 1 of int64 [2, B]).  Out:
// contiguous int32 [E, L, B] (limb row l of element e of message b at
// (e L + l) B + b), 13-bit limbs in Montgomery form with R = 2^(13L),
// canonical: bit for bit what anemoi_pack_bytes then to_mont give, the
// sponge kernel's input.
//
// Design.  One thread an (element, message); neighbouring threads own
// neighbouring messages of one element, so each limb-row store of a warp
// is one coalesced 128-byte line.
//   * Element e of a message is its bytes [e chunk, e chunk + take), take =
//     min(len - e chunk, chunk), little-endian, and the pad byte 1 right
//     after a short last chunk (take < chunk).  byte_chunk (31 or 47) and L
//     (20 or 30) are runtime arguments, so one build serves every field of
//     the library's word count.  The bytes are gathered straight into the
//     NW 32-bit words of x (unrolled over the 4 NW byte slots, each loaded
//     only below take), so nothing is indexed at run time and no word
//     leaves the registers.  Chunks are short enough that x < p (248 bits
//     against p > 2^252, 376 against p > 2^376): packing is bit slicing, no
//     reduction.
//   * One exact product per element makes it Montgomery: f32_mont_mul by
//     c = 2^(13L + 32 NW) mod p gives x c / 2^(32 NW) = x 2^(13L) mod p,
//     canonical (field32.cuh; the kernels' entry and exit products).  The
//     L 13-bit limbs are cut from its words as f32_to_limbs does.
//   * The work is a product and 33 to 49 bytes a thread: 1.36 M threads for
//     4,096 messages of 10 KB read 42 MB, store 108 MB and take ~0.36 G
//     IMADs.  At the H100's 3.35 TB/s the bytes bound it at 0.045 ms; it
//     measures 0.19 ms (H100 SXM, 700 W), about a quarter of the bound.
//     The scattered byte loads set that time, not the bandwidth: a warp's
//     32 messages lie len bytes apart, so each warp's load of one byte slot
//     touches 32 sectors (each thread's chunk lies in one or two 32-byte
//     sectors, which its later loads hit in L1).  The kernel is under 0.02%
//     of a 4,096 x 10 KB sponge call, so it is left untuned.
//   * unpack_element is __host__ __device__, so the host tests build this
//     file with g++ and run the kernel's per-thread code.

#include <stdint.h>
#include <string.h>

#include "anemoi32.cuh"

template <int NW>
struct UnpackConsts {
    uint32_t p[NW];
    uint32_t n0;  // -p^-1 mod 2^32
    uint32_t to_mont[NW];  // 2^(13 L + 32 NW) mod p: a product by it turns x into x 2^(13 L)
};

// Element bytes src[0, take) (take >= 1; the pad byte at take if take <
// chunk) -> `limbs` canonical 13-bit Montgomery limbs at dst[l * stride].
// Needs chunk < 4 NW and limbs <= f32_limbs<NW>.
template <int NW>
F32_FN void unpack_element(int32_t* dst, size_t stride, const uint8_t* src, long long take, int chunk, int limbs,
                           const UnpackConsts<NW>& c) {
    uint32_t w[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        uint32_t v = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int i = 4 * j + k;
            const uint32_t byte = i < take ? src[i] : (i == take && take < chunk ? 1u : 0u);
            v |= byte << (8 * k);
        }
        w[j] = v;
    }
    f32_mont_mul<NW>(w, w, c.to_mont, c.p, c.n0);
#pragma unroll
    for (int l = 0; l < f32_limbs<NW>; ++l) {
        if (l >= limbs) break;
        const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
        uint32_t v = w[word] >> shift;
        if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) v |= w[word + 1] << (32 - shift);
        dst[(size_t)l * stride] = (int32_t)(v & F32_LIMB_MASK);
    }
}

#ifdef __CUDACC__
using Consts = UnpackConsts<ANEMOI_WORDS>;

#define UNPACK_BLOCK 256

__global__ void __launch_bounds__(UNPACK_BLOCK)
    unpack_kernel(const long long* __restrict__ spans, int32_t* __restrict__ out, long long n,
                  const uint8_t* __restrict__ data, long long elements, int chunk, int limbs,
                  const __grid_constant__ Consts c) {
    const long long t = (long long)blockIdx.x * UNPACK_BLOCK + threadIdx.x;
    if (t >= elements * n) return;
    const long long e = t / n, b = t - e * n;
    const long long pos = e * chunk, rest = spans[n + b] - pos;
    unpack_element<ANEMOI_WORDS>(out + e * limbs * n + b, (size_t)n, data + spans[b] + pos,
                                 rest < chunk ? rest : chunk, chunk, limbs, c);
}

extern "C" {

// Unpacks n messages of `elements` elements each: spans int64 [2, n]
// (offsets into data, lengths), out int32 [elements, limbs, n].  Launches
// on `stream` of `device`; returns the launch's cudaError_t.
int anemoi_unpack(const void* spans, void* out, long long n, const void* data, long long elements, int chunk,
                  int limbs, const void* consts, int device, void* stream) {
    if (chunk < 1 || chunk >= 4 * ANEMOI_WORDS || limbs < 1 || limbs > f32_limbs<ANEMOI_WORDS>)
        return (int)cudaErrorInvalidValue;
    if (n <= 0 || elements <= 0) return (int)cudaSuccess;
    Consts c;
    memcpy(&c, consts, sizeof c);
    const long long threads = elements * n;
    const dim3 grid((unsigned)((threads + UNPACK_BLOCK - 1) / UNPACK_BLOCK)), block(UNPACK_BLOCK);
    return launch_on(device, [&] {
        unpack_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const long long*)spans, (int32_t*)out, n,
                                                                  (const uint8_t*)data, elements, chunk, limbs, c);
    });
}

const char* anemoi_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The layout of the constants this library takes: 17 words at 8, 25 at 12.
int anemoi_unpack_consts_words(void) { return (int)(sizeof(Consts) / 4); }
}
#endif  // __CUDACC__
