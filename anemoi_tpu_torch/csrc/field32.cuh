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

// The modulus' shape, the policy of f32_mont_mul and f32_mont_sqr: what
// they know of p when they are compiled.  f32_has_shape says whether a
// modulus (p and n0 = -p^-1 mod 2^32) has a shape.
//   * F32AnyModulus: any odd p below 2^(32 NW), read at run time.
//   * F32PastaModulus: the Pasta primes' shape, Vesta's and Pallas's p =
//     2^254 + c with c < 2^126 odd, at 8 words: p[0] = 1 (so n0 =
//     0xFFFFFFFF), p[3] < 2^30, p[4..6] = 0 and p[7] = 2^30; words 1 to 3
//     are read at run time (Vesta's and Pallas's differ there).  The
//     product is taken in full and reduced by f32_pasta_redc.
struct F32AnyModulus {
    static constexpr bool PASTA = false;
};
struct F32PastaModulus {
    static constexpr bool PASTA = true;
};

template <int NW, class Mod>
F32_FN bool f32_has_shape(const uint32_t p[NW], uint32_t n0) {
    if constexpr (!Mod::PASTA)
        return true;
    else
        return NW == 8 && p[0] == 1u && n0 == 0xFFFFFFFFu && p[3] < 1u << 30 && p[4] == 0u && p[5] == 0u &&
               p[6] == 0u && p[NW - 1] == 1u << 30;
}

// r = t / 2^256 mod p for t[16] below 2^256 p, p of the Pasta shape (t is
// overwritten): the separated Montgomery reduction, word step i adding m *
// p * 2^(32 i) with m = -t[i], as under F32AnyModulus, but
//   * m * p[0] + t[i] is 0, carrying 1 unless t[i] = 0: no product;
//   * three wide products, by p[1..3];
//   * words 4 to 6 of p are 0, so the carry out of word i + 3 (below 2^31,
//     as p[3] < 2^30) is not passed up through them: it is owed to word
//     i + 4, which step i + 1 reaches with its product by p[3];
//   * m * p[7] is m * 2^30, two shifts: the low word m << 30 goes into word
//     i + 7, and the high word m >> 2 with the carry out of word i + 7
//     (below 2^31) is owed to word i + 8, which step i + 1 reaches the same
//     way.
// Step i + 1's m reads word i + 1, which no owed carry reaches, so every m
// is the same as under F32AnyModulus, and so is the sum: the two owed
// carries go up once after the last step.
F32_FN void f32_pasta_redc(uint32_t r[8], uint32_t t[16], const uint32_t p[8]) {
    uint32_t k = 0, k7 = 0;  // the carries owed to words i + 4 and i + 8
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint32_t m = 0u - t[i];
        uint64_t s = (uint64_t)m * p[1] + t[i + 1] + (uint32_t)(t[i] != 0);
        t[i + 1] = (uint32_t)s;
        s = (uint64_t)m * p[2] + t[i + 2] + (s >> 32);
        t[i + 2] = (uint32_t)s;
        s = (uint64_t)m * p[3] + t[i + 3] + (s >> 32) + k;
        t[i + 3] = (uint32_t)s;
        k = (uint32_t)(s >> 32);
        s = (uint64_t)t[i + 7] + k7 + (m << 30);  // m * p[7]: its low word here, its high word m >> 2 owed
        t[i + 7] = (uint32_t)s;
        k7 = (uint32_t)(s >> 32) + (m >> 2);
    }
    uint64_t s = (uint64_t)t[11] + k;
    t[11] = (uint32_t)s;
#pragma unroll
    for (int j = 12; j < 16; ++j) {
        s = (uint64_t)t[j] + (j == 15 ? k7 : 0u) + (s >> 32);
        t[j] = (uint32_t)s;
    }
    f32_reduce_once<8>(r, t + 8, (uint32_t)(s >> 32), p);
}

// r = a * b / 2^(32 NW) mod p (CIOS; under F32PastaModulus the full
// product, then f32_pasta_redc).  Takes any a below 2^(32 NW) and b below
// p: the sum before the last subtraction is below 2p.  r may alias a or b.
// Word i of b is at b[i * bs]: each is read once, at step i, so b may lie
// in memory (the window table of anemoi32.cuh, in shared memory).  p must
// have Mod's shape.
template <int NW, class Mod = F32AnyModulus>
F32_FN void f32_mont_mul(uint32_t r[NW], const uint32_t a[NW], const uint32_t* b, const uint32_t p[NW],
                         uint32_t n0, int bs = 1) {
    if constexpr (Mod::PASTA) {
        static_assert(NW == 8, "the Pasta shape is of 8 words");
        uint32_t t[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) t[j] = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const uint32_t bi = b[i * bs];
            uint64_t c = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                uint64_t s = (uint64_t)a[j] * bi + t[i + j] + c;
                t[i + j] = (uint32_t)s;
                c = s >> 32;
            }
            t[i + 8] = (uint32_t)c;
        }
        f32_pasta_redc(r, t, p);
        return;
    }
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
// separated Montgomery reduction.  r may alias a.  p must have Mod's shape.
template <int NW, class Mod = F32AnyModulus>
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
    if constexpr (Mod::PASTA) {
        f32_pasta_redc(r, t, p);
        return;
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
// mod 2^(32 NW).  p must have Mod's shape.
template <int NW, class Mod = F32AnyModulus>
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
    f32_mont_mul<NW, Mod>(r, w, c_in, p, n0);
}

// a in R' form -> NL canonical 13-bit limbs in R form at dst[l * stride]:
// one product by c_out = 2^(13 NL) mod p.  p must have Mod's shape.
template <int NW, class Mod = F32AnyModulus>
F32_FN void f32_to_limbs(int32_t* dst, size_t stride, const uint32_t a[NW], const uint32_t c_out[NW],
                         const uint32_t p[NW], uint32_t n0) {
    uint32_t w[NW];
    f32_mont_mul<NW, Mod>(w, a, c_out, p, n0);
#pragma unroll
    for (int l = 0; l < f32_limbs<NW>; ++l) {
        const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
        uint32_t v = w[word] >> shift;
        if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) v |= w[word + 1] << (32 - shift);
        dst[(size_t)l * stride] = (int32_t)(v & F32_LIMB_MASK);
    }
}
