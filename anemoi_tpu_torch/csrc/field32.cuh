// Arithmetic in a prime field on NW 32-bit words: NW = 8 for p below
// 2^256 (the 20-limb fields), NW = 12 for p below 2^384 (the 30-limb
// fields, BLS12-377 and BLS12-381).
//
// Values are little-endian uint32_t[NW], canonical (below p), and in
// Montgomery form with R' = 2^(32 NW) where a function says so.  Partial
// products are uint64_t.  p may use every bit of its words: nothing here
// assumes a spare top bit, so the carry word of each sum is kept and the
// conditional subtraction looks at it.
//
// At the boundary a value is NL = f32_limbs<NW> limbs of 13 bits in
// Montgomery form with R = 2^(13 NL), as the JAX package keeps it (20 limbs
// and R = 2^260, or 30 limbs and R = 2^390); f32_from_limbs and
// f32_to_limbs convert.
//
// Every function is __host__ __device__, so the same source is compiled by
// g++ for the host tests (tests/test_torch_field32.py) and by nvcc into
// the kernels (jive.cu, sponge.cu, microbench.cu).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define F32_FN __host__ __device__ __forceinline__
#else
#define F32_FN static inline
#endif

#define F32_LIMB_BITS 13
#define F32_LIMB_MASK 0x1FFFu

// 13-bit limbs of a field on NW words: the JAX package's L.
template <int NW>
constexpr int f32_limbs = NW == 8 ? 20 : 30;

// r = (hi * 2^(32 NW) + t) mod p for a value below 2p.
template <int NW>
F32_FN void f32_reduce_once(uint32_t r[NW], const uint32_t t[NW], uint32_t hi, const uint32_t p[NW]) {
    static_assert(NW == 8 || NW == 12, "8 or 12 words");
    uint32_t d[NW];
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        uint64_t s = (uint64_t)t[j] - p[j] - borrow;
        d[j] = (uint32_t)s;
        borrow = (uint32_t)(s >> 32) & 1u;
    }
    // the value is at least p iff the top word is set or t - p did not borrow
    const bool take = hi != 0 || borrow == 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) r[j] = take ? d[j] : t[j];
}

// r = a + b mod p.
template <int NW>
F32_FN void f32_add(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW], const uint32_t p[NW]) {
    uint32_t s[NW];
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        uint64_t v = (uint64_t)a[j] + b[j] + carry;
        s[j] = (uint32_t)v;
        carry = (uint32_t)(v >> 32);
    }
    f32_reduce_once<NW>(r, s, carry, p);
}

// r = a - b mod p.
template <int NW>
F32_FN void f32_sub(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW], const uint32_t p[NW]) {
    uint32_t d[NW];
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        uint64_t v = (uint64_t)a[j] - b[j] - borrow;
        d[j] = (uint32_t)v;
        borrow = (uint32_t)(v >> 32) & 1u;
    }
    // on a borrow add p back; the carry out of that addition cancels the borrow
    uint32_t carry = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        uint64_t v = (uint64_t)d[j] + (borrow ? p[j] : 0u) + carry;
        r[j] = (uint32_t)v;
        carry = (uint32_t)(v >> 32);
    }
}

// r = a * b / 2^(32 NW) mod p (CIOS).  Takes any a below 2^(32 NW) and b
// below p: the sum before the last subtraction is below 2p.  r may alias a
// or b.  Word i of b is at b[i * bs]: each is read once, at step i, so b
// may lie in memory (the window table of anemoi32.cuh, in shared memory).
template <int NW>
F32_FN void f32_mont_mul(uint32_t r[NW], const uint32_t a[NW], const uint32_t* b, const uint32_t p[NW],
                         uint32_t n0, int bs = 1) {
    uint32_t t[NW + 2];
#pragma unroll
    for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        const uint32_t bi = b[i * bs];
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[NW] + c;
        t[NW] = (uint32_t)s;
        t[NW + 1] = (uint32_t)(s >> 32);
        const uint32_t m = t[0] * n0;
        s = (uint64_t)m * p[0] + t[0];
        c = s >> 32;
#pragma unroll
        for (int j = 1; j < NW; ++j) {
            s = (uint64_t)m * p[j] + t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[NW] + c;
        t[NW - 1] = (uint32_t)s;
        t[NW] = t[NW + 1] + (uint32_t)(s >> 32);
    }
    f32_reduce_once<NW>(r, t, t[NW], p);
}

// r = a^2 / 2^(32 NW) mod p for a below p: the 2NW-word square from
// NW(NW+1)/2 word products (each cross product once, then doubled), then a
// separated Montgomery reduction.  r may alias a.
template <int NW>
F32_FN void f32_mont_sqr(uint32_t r[NW], const uint32_t a[NW], const uint32_t p[NW], uint32_t n0) {
    uint32_t t[2 * NW];
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j) t[j] = 0;
    // cross products a_i * a_j, i < j: row i ends in a carry into t[i + NW]
#pragma unroll
    for (int i = 0; i < NW - 1; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = i + 1; j < NW; ++j) {
            uint64_t s = (uint64_t)a[i] * a[j] + t[i + j] + c;
            t[i + j] = (uint32_t)s;
            c = s >> 32;
        }
        t[i + NW] = (uint32_t)c;
    }
    // double them (their sum is below 2^(64 NW - 1), so no bit leaves the top word)
#pragma unroll
    for (int j = 2 * NW - 1; j > 0; --j) t[j] = (t[j] << 1) | (t[j - 1] >> 31);
    t[0] <<= 1;
    // add the squares a_i^2
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        uint64_t s = (uint64_t)a[i] * a[i] + t[2 * i] + c;
        t[2 * i] = (uint32_t)s;
        s = (uint64_t)t[2 * i + 1] + (s >> 32);
        t[2 * i + 1] = (uint32_t)s;
        c = s >> 32;
    }
    // reduce: add m_i * p * 2^(32 i) to clear word i; carries out of word
    // i + NW wait in `top` and enter at word i + NW + 1
    uint32_t top = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        const uint32_t m = t[i] * n0;
        uint64_t cc = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            uint64_t s = (uint64_t)m * p[j] + t[i + j] + cc;
            t[i + j] = (uint32_t)s;
            cc = s >> 32;
        }
        uint64_t s = (uint64_t)t[i + NW] + cc + top;
        t[i + NW] = (uint32_t)s;
        top = (uint32_t)(s >> 32);
    }
    f32_reduce_once<NW>(r, t + NW, top, p);
}

// Limb l of a value at src[l * stride] (its low 13 bits) -> R' form:
// r = x * 2^(32 NW - 13 NL) mod p for x in R form, one product by
// c_in = 2^(64 NW - 13 NL) mod p (2^252 for 8 words, 2^378 for 12).  Inputs
// are canonical, x < p < 2^(32 NW); the bits of x from 2^(32 NW) up (the
// top four or six of the last limb) are dropped, so a larger x is taken
// mod 2^(32 NW).
template <int NW>
F32_FN void f32_from_limbs(uint32_t r[NW], const int32_t* src, size_t stride, const uint32_t c_in[NW],
                           const uint32_t p[NW], uint32_t n0) {
    uint32_t w[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = 0;
#pragma unroll
    for (int l = 0; l < f32_limbs<NW>; ++l) {
        const uint32_t v = (uint32_t)src[(size_t)l * stride] & F32_LIMB_MASK;
        const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
        w[word] |= v << shift;
        if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) w[word + 1] |= v >> (32 - shift);
    }
    f32_mont_mul<NW>(r, w, c_in, p, n0);
}

// a in R' form -> NL canonical 13-bit limbs in R form at dst[l * stride]:
// one product by c_out = 2^(13 NL) mod p.
template <int NW>
F32_FN void f32_to_limbs(int32_t* dst, size_t stride, const uint32_t a[NW], const uint32_t c_out[NW],
                         const uint32_t p[NW], uint32_t n0) {
    uint32_t w[NW];
    f32_mont_mul<NW>(w, a, c_out, p, n0);
#pragma unroll
    for (int l = 0; l < f32_limbs<NW>; ++l) {
        const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
        uint32_t v = w[word] >> shift;
        if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) v |= w[word + 1] << (32 - shift);
        dst[(size_t)l * stride] = (int32_t)(v & F32_LIMB_MASK);
    }
}
