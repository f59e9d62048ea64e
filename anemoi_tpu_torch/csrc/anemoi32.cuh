// The Anemoi permutation of one state on NW 32-bit words: the body that
// the Jive kernel (jive.cu) and the permutation and sponge kernels
// (sponge.cu) share, at 8 words for the five 20-limb fields and at 12 for
// the two 30-limb ones.
//
// A state is W field elements in Montgomery form with R' = 2^(32 NW),
// held whole by one thread (ThreadArith over field32.cuh: the Jive kernel
// and the one-thread permutation kernel), word-sliced over a group of four
// lanes (GroupArith over field32_group.cuh: the sponge kernel and the
// four-lane permutation kernel), word-sliced so with the reduction on the
// tensor cores (MmaArith over field32_mma.cuh: the quad form of the
// tensor-core permutation and sponge kernels), or whole in one thread with
// the reduction on the tensor cores (MmaThreadArith over field32_mma.cuh:
// the tensor-core Jive kernel and the thread form of the tensor-core
// permutation); the body is written once over the four.
// Rounds: ARK, MDS (1 or 2 columns), open Flystel; then a final MDS.
// x^(1/alpha) is a 4-bit sliding window under ThreadArith, MmaThreadArith
// and MmaArith (Vesta: 253 squarings and 63 products, table included;
// BLS12-381: 379 and 89) and a binary ladder under GroupArith (253 and 124;
// 380 and 193); the reference's addition chains have 293 and 454
// operations, and the result is the same canonical value.  Round and
// exponent loops stay rolled (#pragma unroll 1), which keeps the build to
// seconds.
//
// Constants (field words, round constants, exponent bits, rounds) arrive
// in one struct passed to the kernels by value; one instantiation per
// width and word count serves every field of that word count.  Everything
// here is __host__ __device__, so the host tests build it with g++.
#pragma once

#include <stdint.h>

#include "field32.cuh"
#include "field32_group.cuh"
#include "field32_mma.cuh"

#define MAX_ROUND_COLUMNS 28  // rounds * columns of the largest instance: 14 x 2 (Vesta and BLS12-381 4_3)

// The layout matches anemoi_tpu_torch/ff/cuda_backend.py:consts_words.
template <int NW>
struct AnemoiConsts {
    uint32_t p[NW];
    uint32_t n0;  // -p^-1 mod 2^32
    uint32_t c_in[NW];  // 2^(64 NW - 13 NL) mod p: 2^252 or 2^378
    uint32_t c_out[NW];  // 2^(13 NL) mod p: 2^260 or 2^390
    uint32_t one[NW];  // 1 in R' form: 2^(32 NW) mod p
    uint32_t beta[NW];  // R' form
    uint32_t delta[NW];  // R' form
    uint32_t inv_alpha[NW];  // the exponent 1/alpha mod (p - 1)
    uint32_t inv_alpha_bits;
    uint32_t rounds;
    uint32_t C[MAX_ROUND_COLUMNS][NW];  // [round * columns + column], R' form
    uint32_t D[MAX_ROUND_COLUMNS][NW];
};
static_assert(sizeof(AnemoiConsts<8>) == 507 * 4, "AnemoiConsts<8> layout");
static_assert(sizeof(AnemoiConsts<12>) == 759 * 4, "AnemoiConsts<12> layout");
static_assert(sizeof(AnemoiConsts<12>) <= 4096, "AnemoiConsts must fit the kernel parameter space");

template <int NW>
F32_FN void f32_copy(uint32_t r[NW], const uint32_t a[NW]) {
#pragma unroll
    for (int j = 0; j < NW; ++j) r[j] = a[j];
}

// The permutation's arithmetic, as a policy the body below is written
// over: Elem is one field element as its holder keeps it, and add, sub,
// mul, sqr, mul_g (the product by the generator beta) and copy act on
// Elems; add also takes a constant of the struct (C(k), D(k), delta()).
// sqr_n, mul_n and mul_g_n do N independent products at once.  LOCKSTEP
// runs the Flystel columns of a round side by side, each operation on
// every column before the next, and their products as one N-fold product,
// so that their latencies overlap.  WINDOW says that x^(1/alpha) is the
// 4-bit window, with its table kept by the arithmetic (store and load, and
// mul_tab, the product by an entry, where columns run one after the
// other), and not the binary ladder.

// x^(1/alpha)'s window table: the odd powers x, x^3, ..., x^15 of a 4-bit
// window.
#define INV_ALPHA_WINDOW 4
#define INV_ALPHA_TABLE (1 << (INV_ALPHA_WINDOW - 1))

// One thread holds whole elements (field32.cuh): the Jive and one-thread
// permutation kernels, and sponge_lane.  Columns run one after the other,
// so one window table serves them all: word j of entry e at
// tab[(e * NW + j) * stride].  The kernels give each thread its slots of a
// shared-memory table with stride BLOCK (a warp's 32 loads of one word fall
// in 32 banks), the host builds a local array with stride 1.  Mod is the
// modulus' shape that the products are compiled for (field32.cuh).
template <int NW, class Mod = F32AnyModulus>
struct ThreadArith {
    using Elem = uint32_t[NW];
    static constexpr bool LOCKSTEP = false, WINDOW = true;
    const AnemoiConsts<NW>& c;
    uint32_t* tab;
    int stride;
    G32_MEMBER void add(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) const { f32_add<NW>(r, a, b, c.p); }
    G32_MEMBER void sub(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) const { f32_sub<NW>(r, a, b, c.p); }
    G32_MEMBER void mul(uint32_t r[NW], const uint32_t a[NW], const uint32_t b[NW]) const {
        f32_mont_mul<NW, Mod>(r, a, b, c.p, c.n0);
    }
    G32_MEMBER void sqr(uint32_t r[NW], const uint32_t a[NW]) const { f32_mont_sqr<NW, Mod>(r, a, c.p, c.n0); }
    G32_MEMBER void mul_g(uint32_t r[NW], const uint32_t a[NW]) const {
        f32_mont_mul<NW, Mod>(r, a, c.beta, c.p, c.n0);
    }
    G32_MEMBER void copy(uint32_t r[NW], const uint32_t a[NW]) const { f32_copy<NW>(r, a); }
    template <int N>
    G32_MEMBER void sqr_n(Elem* r, const Elem* a) const {
#pragma unroll
        for (int i = 0; i < N; ++i) sqr(r[i], a[i]);
    }
    template <int N>
    G32_MEMBER void mul_n(Elem* r, const Elem* a, const Elem* b) const {
#pragma unroll
        for (int i = 0; i < N; ++i) mul(r[i], a[i], b[i]);
    }
    template <int N>
    G32_MEMBER void mul_g_n(Elem* r, const Elem* a) const {
#pragma unroll
        for (int i = 0; i < N; ++i) mul_g(r[i], a[i]);
    }
    G32_MEMBER const uint32_t* C(int k) const { return c.C[k]; }
    G32_MEMBER const uint32_t* D(int k) const { return c.D[k]; }
    G32_MEMBER const uint32_t* delta() const { return c.delta; }
    // the window table: store entry e, load it, and r = a * entry e, the
    // product reading the entry's words from the table
    G32_MEMBER void store(int e, const uint32_t a[NW]) const {
#pragma unroll
        for (int j = 0; j < NW; ++j) tab[(e * NW + j) * stride] = a[j];
    }
    G32_MEMBER void load(uint32_t r[NW], int e) const {
#pragma unroll
        for (int j = 0; j < NW; ++j) r[j] = tab[(e * NW + j) * stride];
    }
    G32_MEMBER void mul_tab(uint32_t r[NW], const uint32_t a[NW], int e) const {
        f32_mont_mul<NW, Mod>(r, a, tab + e * NW * stride, c.p, c.n0, stride);
    }
};

// A group of four lanes holds each element word-sliced (field32_group.cuh,
// lane policy P): the sponge and four-lane permutation kernels.  The
// lane's slices of p, beta and delta stay in registers; a round constant
// is sliced where it is added.
// Squaring is the group product of a value by itself.  Columns run in
// lockstep, so the Flystels' products come N at a time; mds's products by
// beta (60 of a Vesta 4_3 permutation's 10,728) come one at a time.
template <int NW, class P>
struct GroupArith {
    static constexpr int S = NW / 4;
    using Elem = uint32_t[P::H][S];
    static constexpr bool LOCKSTEP = true, WINDOW = false;
    const AnemoiConsts<NW>& c;
    uint32_t p[P::H][S], beta[P::H][S], delta_[P::H][S];
    G32_MEMBER GroupArith(const AnemoiConsts<NW>& consts) : c(consts) {
        g_slice<NW, P>(p, c.p);
        g_slice<NW, P>(beta, c.beta);
        g_slice<NW, P>(delta_, c.delta);
    }
    G32_MEMBER void add(Elem r, const Elem a, const Elem b) const { g_add<NW, P>(r, a, b, p); }
    G32_MEMBER void add(Elem r, const Elem a, const uint32_t k[NW]) const {
        Elem s;
        g_slice<NW, P>(s, k);
        g_add<NW, P>(r, a, s, p);
    }
    G32_MEMBER void sub(Elem r, const Elem a, const Elem b) const { g_sub<NW, P>(r, a, b, p); }
    G32_MEMBER void mul_g(Elem r, const Elem a) const { g_mont_mul<NW, P>(r, a, beta, p, c.n0); }
    G32_MEMBER void copy(Elem r, const Elem a) const { g_copy<NW, P>(r, a); }
    // r = pick ? a : b, word by word (pick is the same in every lane)
    G32_MEMBER void select(Elem r, bool pick, const Elem a, const Elem b) const {
#pragma unroll
        for (int h = 0; h < P::H; ++h)
#pragma unroll
            for (int j = 0; j < S; ++j) r[h][j] = pick ? a[h][j] : b[h][j];
    }
    template <int N>
    G32_MEMBER void sqr_n(Elem* r, const Elem* a) const { g_mont_mul_n<NW, P, N>(r, a, a, p, c.n0); }
    template <int N>
    G32_MEMBER void mul_n(Elem* r, const Elem* a, const Elem* b) const { g_mont_mul_n<NW, P, N>(r, a, b, p, c.n0); }
    template <int N>
    G32_MEMBER void mul_g_n(Elem* r, const Elem* a) const {
        Elem g[N];
#pragma unroll
        for (int i = 0; i < N; ++i) g_copy<NW, P>(g[i], beta);
        g_mont_mul_n<NW, P, N>(r, a, g, p, c.n0);
    }
    G32_MEMBER const uint32_t* C(int k) const { return c.C[k]; }
    G32_MEMBER const uint32_t* D(int k) const { return c.D[k]; }
    G32_MEMBER const Elem& delta() const { return delta_; }
};

// A warp holds 8 states (field32_mma.cuh's quad form, warp policy M),
// one a quad, each element word-sliced over its quad as under GroupArith:
// the quad form of sponge_mma.cu's permutation and sponge.  The products
// run mma_mont_mul_n: the bilinear half on the group's word-sliced operand
// scanning, the reduction's two products by constants on the tensor cores;
// frag holds the constants' fragments (shared memory on the card).  Adds
// and subtracts run the group code on each quad.  LOCKSTEP, and
// x^(1/alpha) is the window over the N columns side by side: entry e of
// column k is table slot e * N + k, held thread i's word j of slot s at
// tab[(s * S + j) * stride + i] (on the card, each thread's slots of a
// shared-memory table with stride the block's threads, so that a warp's 32
// loads of one word fall in 32 banks).  Every lane loads the same slot, so
// every lane reaches every mma.
template <int NW, class M>
struct MmaArith {
    using G = typename M::G;
    static constexpr int S = NW / 4, T = M::T, H = G::H;
    using Elem = uint32_t[T][S];
    static constexpr bool LOCKSTEP = true, WINDOW = true;
    const AnemoiConsts<NW>& c;
    const uint32_t* frag;
    uint32_t* tab;
    int stride;
    uint32_t p[H][S];
    Elem beta;
    G32_MEMBER MmaArith(const AnemoiConsts<NW>& consts, const uint32_t* fragments, uint32_t* table, int table_stride)
        : c(consts), frag(fragments), tab(table), stride(table_stride) {
        g_slice<NW, G>(p, c.p);
        splat(beta, c.beta);
    }
    // every held lane's slice of the words w[NW]
    G32_MEMBER static void splat(Elem r, const uint32_t w[NW]) {
#pragma unroll
        for (int q = 0; q < T; q += H) g_slice<NW, G>(r + q, w);
    }
    G32_MEMBER void add(Elem r, const Elem a, const Elem b) const {
#pragma unroll
        for (int q = 0; q < T; q += H) g_add<NW, G>(r + q, a + q, b + q, p);
    }
    G32_MEMBER void add(Elem r, const Elem a, const uint32_t k[NW]) const {
        Elem s;
        splat(s, k);
        add(r, a, s);
    }
    G32_MEMBER void sub(Elem r, const Elem a, const Elem b) const {
#pragma unroll
        for (int q = 0; q < T; q += H) g_sub<NW, G>(r + q, a + q, b + q, p);
    }
    G32_MEMBER void copy(Elem r, const Elem a) const {
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = 0; j < S; ++j) r[i][j] = a[i][j];
    }
    template <int N>
    G32_MEMBER void mul_n(Elem* r, const Elem* a, const Elem* b) const { mma_mont_mul_n<NW, M, N>(r, a, b, p, frag); }
    template <int N>
    G32_MEMBER void sqr_n(Elem* r, const Elem* a) const { mul_n<N>(r, a, a); }
    template <int N>
    G32_MEMBER void mul_g_n(Elem* r, const Elem* a) const {
        Elem g[N];
#pragma unroll
        for (int i = 0; i < N; ++i) copy(g[i], beta);
        mul_n<N>(r, a, g);
    }
    G32_MEMBER void mul(Elem r, const Elem a, const Elem b) const {
        using E = uint32_t(*)[T][S];
        using CE = const uint32_t(*)[T][S];
        mul_n<1>((E)r, (CE)a, (CE)b);  // one element as an array of one (C casts, as in mma_mont_mul_n)
    }
    G32_MEMBER void mul_g(Elem r, const Elem a) const { mul(r, a, beta); }
    G32_MEMBER const uint32_t* C(int k) const { return c.C[k]; }
    G32_MEMBER const uint32_t* D(int k) const { return c.D[k]; }
    G32_MEMBER const uint32_t* delta() const { return c.delta; }
    // the window table: store slot e, and load it
    G32_MEMBER void store(int e, const Elem a) const {
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = 0; j < S; ++j) tab[(e * S + j) * stride + i] = a[i][j];
    }
    G32_MEMBER void load(Elem r, int e) const {
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = 0; j < S; ++j) r[i][j] = tab[(e * S + j) * stride + i];
    }
};

// A warp holds 32 states, one a thread, each element whole in its thread
// (field32_mma.cuh's one-state-a-thread product, warp policy M): the Jive
// kernel of jive_mma.cu and the thread form of sponge_mma.cu's permutation.  Elem is the held threads' NW words (M::T threads:
// one on the card, the whole warp on the host).  Adds and subtracts are
// field32.cuh's, in each thread; a product is the thread's bilinear half
// (mt_mul_wide, or mt_sqr_wide for a squaring) and the warp's reduction on
// the tensor cores (mt_mont_reduce; frag holds the constants' fragments,
// rows the warp's scratch, both in shared memory on the card).  Not
// LOCKSTEP: columns run one after the other and x^(1/alpha) is the window,
// whose branches read only the exponent, the same in every thread, so every
// lane reaches every mma.  Word j of window entry e of held thread i is at
// tab[(e * NW + j) * stride + i].
template <int NW, class M>
struct MmaThreadArith {
    static constexpr int T = M::T;
    using Elem = uint32_t[T][NW];
    using Wide = uint32_t[T][2 * NW];
    static constexpr bool LOCKSTEP = false, WINDOW = true;
    const AnemoiConsts<NW>& c;
    const uint32_t* frag;
    uint32_t* rows;
    uint32_t* tab;
    int stride;
    G32_MEMBER void add(Elem r, const Elem a, const Elem b) const {
#pragma unroll
        for (int i = 0; i < T; ++i) f32_add<NW>(r[i], a[i], b[i], c.p);
    }
    G32_MEMBER void add(Elem r, const Elem a, const uint32_t k[NW]) const {
#pragma unroll
        for (int i = 0; i < T; ++i) f32_add<NW>(r[i], a[i], k, c.p);
    }
    G32_MEMBER void sub(Elem r, const Elem a, const Elem b) const {
#pragma unroll
        for (int i = 0; i < T; ++i) f32_sub<NW>(r[i], a[i], b[i], c.p);
    }
    G32_MEMBER void copy(Elem r, const Elem a) const {
#pragma unroll
        for (int i = 0; i < T; ++i) f32_copy<NW>(r[i], a[i]);
    }
    G32_MEMBER void reduce(Elem r, const Wide t) const { mt_mont_reduce<NW, M>(r, t, c.p, frag, rows); }
    // r = a * k for words k the same in every thread (a constant)
    G32_MEMBER void mul_k(Elem r, const Elem a, const uint32_t k[NW]) const {
        Wide t;
#pragma unroll
        for (int i = 0; i < T; ++i) mt_mul_wide<NW>(t[i], a[i], k, 1);
        reduce(r, t);
    }
    G32_MEMBER void sqr(Elem r, const Elem a) const {
        Wide t;
#pragma unroll
        for (int i = 0; i < T; ++i) mt_sqr_wide<NW>(t[i], a[i]);
        reduce(r, t);
    }
    G32_MEMBER void mul_g(Elem r, const Elem a) const { mul_k(r, a, c.beta); }
    template <int N>
    G32_MEMBER void sqr_n(Elem* r, const Elem* a) const {
#pragma unroll
        for (int i = 0; i < N; ++i) sqr(r[i], a[i]);
    }
    template <int N>
    G32_MEMBER void mul_g_n(Elem* r, const Elem* a) const {
#pragma unroll
        for (int i = 0; i < N; ++i) mul_g(r[i], a[i]);
    }
    G32_MEMBER const uint32_t* C(int k) const { return c.C[k]; }
    G32_MEMBER const uint32_t* D(int k) const { return c.D[k]; }
    G32_MEMBER const uint32_t* delta() const { return c.delta; }
    // the window table, as ThreadArith's; its entries are the only operands
    // of a product that differ between threads
    G32_MEMBER void store(int e, const Elem a) const {
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = 0; j < NW; ++j) tab[(e * NW + j) * stride + i] = a[i][j];
    }
    G32_MEMBER void load(Elem r, int e) const {
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int j = 0; j < NW; ++j) r[i][j] = tab[(e * NW + j) * stride + i];
    }
    G32_MEMBER void mul_tab(Elem r, const Elem a, int e) const {
        Wide t;
#pragma unroll
        for (int i = 0; i < T; ++i) mt_mul_wide<NW>(t[i], a[i], tab + e * NW * stride + i, stride);
        reduce(r, t);
    }
};

// The 8 states of the warp whose first is state `base`, under MmaArith:
// held thread i's state, and whether it is one of the n (limb l of an
// element at src[l * n + state]).  A state at or past n reads as 0 and is
// not written, so the last warp runs whole.
template <class M>
F32_FN bool mma_state(long long base, long long n, int i, long long& state) {
    state = base + M::lane_id(i) / G32_LANES;
    return state < n;
}

// Limbs -> R' form, as f32_from_limbs: every lane of a quad reads all the
// limbs of its state, packs the words and keeps its slice; then one product
// by c_in.
template <int NW, class M>
F32_FN void mma_from_limbs(const MmaArith<NW, M>& ar, uint32_t r[M::T][NW / 4], const int32_t* src, long long n,
                           long long base) {
    using Elem = typename MmaArith<NW, M>::Elem;
#pragma unroll
    for (int i = 0; i < M::T; ++i) {
        long long st;
        const bool live = mma_state<M>(base, n, i, st);
        uint32_t w[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) w[j] = 0;
#pragma unroll
        for (int l = 0; l < f32_limbs<NW>; ++l) {
            const uint32_t v = live ? (uint32_t)src[(size_t)l * n + st] & F32_LIMB_MASK : 0u;
            const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
            w[word] |= v << shift;
            if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) w[word + 1] |= v >> (32 - shift);
        }
        const int lane = M::lane_id(i) % G32_LANES;
#pragma unroll
        for (int j = 0; j < NW / 4; ++j) {
            uint32_t v = w[j];
#pragma unroll
            for (int k = 1; k < G32_LANES; ++k) v = lane == k ? w[k * (NW / 4) + j] : v;
            r[i][j] = v;
        }
    }
    Elem k;
    ar.splat(k, ar.c.c_in);
    ar.mul(r, r, k);
}

// R' form -> canonical limbs at dst[l * n + state], as f32_to_limbs: one
// product by c_out, the words gathered into every lane of the quad, and
// lane t writes limbs t, t + 4, ... of its state if it is live.
template <int NW, class M>
F32_FN void mma_to_limbs(const MmaArith<NW, M>& ar, int32_t* dst, long long n, long long base,
                         const uint32_t a[M::T][NW / 4]) {
    using G = typename M::G;
    constexpr int S = NW / 4, H = G::H;
    typename MmaArith<NW, M>::Elem x, k;
    ar.splat(k, ar.c.c_out);
    ar.mul(x, a, k);
#pragma unroll
    for (int q = 0; q < M::T; q += H) {
        uint32_t v[H], got[H], w[H][NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) {
#pragma unroll
            for (int e = 0; e < H; ++e) v[e] = x[q + e][j % S];
            G::bcast(got, v, j / S);
#pragma unroll
            for (int e = 0; e < H; ++e) w[e][j] = got[e];
        }
#pragma unroll
        for (int e = 0; e < H; ++e) {
            long long st;
            const bool live = mma_state<M>(base, n, q + e, st);
            const int lane = M::lane_id(q + e) % G32_LANES;
#pragma unroll
            for (int l = 0; l < f32_limbs<NW>; ++l) {
                const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
                uint32_t u = w[e][word] >> shift;
                if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) u |= w[e][word + 1] << (32 - shift);
                if (live && l % G32_LANES == lane) dst[(size_t)l * n + st] = (int32_t)(u & F32_LIMB_MASK);
            }
        }
    }
}

// Limbs -> R' form under MmaThreadArith, as f32_from_limbs: each held
// thread's state base + lane (limb l at src[l * n + state]; zero at or past
// n), then one product by c_in.
template <int NW, class M>
F32_FN void mt_from_limbs(const MmaThreadArith<NW, M>& ar, uint32_t r[M::T][NW], const int32_t* src, long long n,
                          long long base) {
#pragma unroll
    for (int i = 0; i < M::T; ++i) {
        const long long st = base + M::lane_id(i);
#pragma unroll
        for (int j = 0; j < NW; ++j) r[i][j] = 0;
#pragma unroll
        for (int l = 0; l < f32_limbs<NW>; ++l) {
            const uint32_t v = st < n ? (uint32_t)src[(size_t)l * n + st] & F32_LIMB_MASK : 0u;
            const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
            r[i][word] |= v << shift;
            if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) r[i][word + 1] |= v >> (32 - shift);
        }
    }
    ar.mul_k(r, r, ar.c.c_in);
}

// R' form -> canonical limbs at dst[l * n + state] under MmaThreadArith, as
// f32_to_limbs: one product by c_out, in place (x is left in plain form),
// and each held thread writes its state's limbs if it is live.
template <int NW, class M>
F32_FN void mt_to_limbs(const MmaThreadArith<NW, M>& ar, int32_t* dst, long long n, long long base,
                        uint32_t x[M::T][NW]) {
    ar.mul_k(x, x, ar.c.c_out);
#pragma unroll
    for (int i = 0; i < M::T; ++i) {
        const long long st = base + M::lane_id(i);
        if (st >= n) continue;
#pragma unroll
        for (int l = 0; l < f32_limbs<NW>; ++l) {
            const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
            uint32_t v = x[i][word] >> shift;
            if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) v |= x[i][word + 1] << (32 - shift);
            dst[(size_t)l * n + st] = (int32_t)(v & F32_LIMB_MASK);
        }
    }
}

// Shared memory of a block of `threads` under MmaThreadArith, in words:
// the constants' fragments lane-major (mt_frag_word, mt_copy_fragments),
// then each warp's scratch rows (MMA_THREAD_STATES x MMA_ROW_WORDS), then
// each thread's window table (INV_ALPHA_TABLE x NW words, stride `threads`,
// so that a warp's 32 loads of one word fall in 32 banks).
template <int NW>
constexpr int mt_smem_words(int threads) {
    return mt_frag_words<NW> + threads * MMA_ROW_WORDS + INV_ALPHA_TABLE * NW * threads;
}

// The window of the exponent `e` that starts at its set bit `top`: at
// most INV_ALPHA_WINDOW bits, down to the lowest set bit among them.
// Returns the table entry of its odd value, (value - 1) / 2, and its length
// in `len`.
F32_FN int inv_alpha_window(const uint32_t* e, int top, int& len) {
    int lo = top - (INV_ALPHA_WINDOW - 1) < 0 ? 0 : top - (INV_ALPHA_WINDOW - 1);
    while (!((e[lo >> 5] >> (lo & 31)) & 1u)) ++lo;
    int value = 0;
    for (int b = top; b >= lo; --b) value = 2 * value + (int)((e[b >> 5] >> (b & 31)) & 1u);
    len = top - lo + 1;
    return value >> 1;
}

// x^(1/alpha) of N elements.
//   * Under WINDOW (ThreadArith, MmaThreadArith, MmaArith): a left-to-right
//     sliding window of 4 bits.  The table x, x^3, ..., x^15 takes one
//     squaring (x^2) and seven products.  Then, from the top bit down, a
//     zero bit between windows is one squaring, and a window is one
//     squaring a bit and one product by the table entry of its odd value;
//     the first window is its entry.  Each trip of the rolled loop is one
//     N-fold squaring or one N-fold product; every branch reads only the
//     exponent, the same in every thread.  Under LOCKSTEP (MmaArith, whose
//     squaring is its product) a trip's squaring is the product by acc
//     itself, so the loop holds one copy of the N-fold product's code.
//     Vesta: 253 squarings and 63 products (the ladder's 253 and 124);
//     BLS12-381: 379 and 89 (380 and 193).
//   * Otherwise (GroupArith): a left-to-right binary ladder over the
//     exponent's bits.  Each trip of the loop is one N-fold product, a
//     squaring or, after a set bit, the product by x, so the loop holds one
//     copy of the product's code.
template <int N, class A>
F32_FN void exp_inv_alpha(const A& ar, typename A::Elem* r, const typename A::Elem* x) {
    typename A::Elem acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) ar.copy(acc[i], x[i]);
    if constexpr (!A::WINDOW) {
        typename A::Elem f[N];
        bool by_x = false;
#pragma unroll 1
        for (int bit = (int)ar.c.inv_alpha_bits - 2; bit >= 0 || by_x;) {
#pragma unroll
            for (int i = 0; i < N; ++i) ar.select(f[i], by_x, x[i], acc[i]);
            if (by_x) {
                by_x = false;
            } else {
                by_x = (ar.c.inv_alpha[bit >> 5] >> (bit & 31)) & 1u;
                --bit;
            }
            ar.template mul_n<N>(acc, acc, f);
        }
    } else if constexpr (!A::LOCKSTEP) {
        // one column, written apart from the N columns below: run through that form, the kernels over
        // ThreadArith and MmaThreadArith compile to other PTX
        static_assert(N == 1, "one thread runs its columns one after the other");
        ar.store(0, x[0]);
        ar.sqr(acc[0], x[0]);
#pragma unroll 1
        for (int e = 1; e < INV_ALPHA_TABLE; ++e) {
            typename A::Elem t;
            ar.mul_tab(t, acc[0], e - 1);
            ar.store(e, t);
        }
        const uint32_t* bits = ar.c.inv_alpha;
        int bit = (int)ar.c.inv_alpha_bits - 1, sq;
        ar.load(acc[0], inv_alpha_window(bits, bit, sq));
        bit -= sq;
        sq = 0;
        int e = -1;  // what comes before bit: sq squarings, then the product by entry e if e >= 0
#pragma unroll 1
        for (;;) {
            if (sq == 0 && e < 0) {
                if (bit < 0) break;
                if ((bits[bit >> 5] >> (bit & 31)) & 1u) {
                    e = inv_alpha_window(bits, bit, sq);
                    bit -= sq;
                } else {
                    sq = 1;
                    --bit;
                }
            }
            if (sq > 0) {
                ar.sqr(acc[0], acc[0]);
                --sq;
            } else {
                ar.mul_tab(acc[0], acc[0], e);
                e = -1;
            }
        }
    } else {
        // the N columns side by side: entry e of column i is the table's slot e * N + i, and a trip's squaring
        // is the product by acc itself, so the loop holds one copy of the N-fold product
        typename A::Elem f[N];
#pragma unroll
        for (int i = 0; i < N; ++i) ar.store(i, x[i]);
        ar.template mul_n<N>(acc, x, x);
#pragma unroll 1
        for (int e = 1; e < INV_ALPHA_TABLE; ++e) {
#pragma unroll
            for (int i = 0; i < N; ++i) ar.load(f[i], (e - 1) * N + i);
            ar.template mul_n<N>(f, acc, f);
#pragma unroll
            for (int i = 0; i < N; ++i) ar.store(e * N + i, f[i]);
        }
        const uint32_t* bits = ar.c.inv_alpha;
        int bit = (int)ar.c.inv_alpha_bits - 1, sq;
        const int first = inv_alpha_window(bits, bit, sq);
#pragma unroll
        for (int i = 0; i < N; ++i) ar.load(acc[i], first * N + i);
        bit -= sq;
        sq = 0;
        int e = -1;  // what comes before bit: sq squarings, then the product by entry e if e >= 0
#pragma unroll 1
        for (;;) {
            if (sq == 0 && e < 0) {
                if (bit < 0) break;
                if ((bits[bit >> 5] >> (bit & 31)) & 1u) {
                    e = inv_alpha_window(bits, bit, sq);
                    bit -= sq;
                } else {
                    sq = 1;
                    --bit;
                }
            }
#pragma unroll
            for (int i = 0; i < N; ++i) {
                if (sq > 0)
                    ar.copy(f[i], acc[i]);
                else
                    ar.load(f[i], e * N + i);
            }
            ar.template mul_n<N>(acc, acc, f);
            if (sq > 0)
                --sq;
            else
                e = -1;
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) ar.copy(r[i], acc[i]);
}

// Open Flystel on N columns (x[i], y[i]):
// x -= g*y^2 ; y -= x^(1/alpha) ; x += g*y^2 + delta.
template <int N, class A>
F32_FN void flystel(const A& ar, typename A::Elem* x, typename A::Elem* y) {
    typename A::Elem t[N];
    ar.template sqr_n<N>(t, y);
    ar.template mul_g_n<N>(t, t);
#pragma unroll
    for (int i = 0; i < N; ++i) ar.sub(x[i], x[i], t[i]);
    exp_inv_alpha<N>(ar, t, x);
#pragma unroll
    for (int i = 0; i < N; ++i) ar.sub(y[i], y[i], t[i]);
    ar.template sqr_n<N>(t, y);
    ar.template mul_g_n<N>(t, t);
#pragma unroll
    for (int i = 0; i < N; ++i) ar.add(x[i], x[i], t[i]);
#pragma unroll
    for (int i = 0; i < N; ++i) ar.add(x[i], x[i], ar.delta());
}

// The linear layer and the pseudo-Hadamard transform.  Width 4 does four
// products by the generator (mul_g); width 2 does none.
template <int W, class A>
F32_FN void mds(const A& ar, typename A::Elem* s) {
    if constexpr (W == 2) {
        ar.add(s[1], s[1], s[0]);
        ar.add(s[0], s[0], s[1]);
    } else {
        typename A::Elem t;
        ar.mul_g(t, s[1]);
        ar.add(s[0], s[0], t);
        ar.mul_g(t, s[0]);
        ar.add(s[1], s[1], t);
        ar.mul_g(t, s[2]);
        ar.add(s[3], s[3], t);
        ar.mul_g(t, s[3]);
        ar.add(s[2], s[2], t);
        // swap the two y words, then the pseudo-Hadamard transform
        ar.copy(t, s[2]);
        ar.copy(s[2], s[3]);
        ar.copy(s[3], t);
        ar.add(s[2], s[2], s[0]);
        ar.add(s[3], s[3], s[1]);
        ar.add(s[0], s[0], s[2]);
        ar.add(s[1], s[1], s[3]);
    }
}

// The permutation of a state of W elements, in place: rounds x (ARK, MDS,
// S-box), then MDS.
template <int W, class A>
F32_FN void permute_state(typename A::Elem* s, const A& ar) {
    constexpr int COLS = W / 2;
#pragma unroll 1
    for (int r = 0; r < (int)ar.c.rounds; ++r) {
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
            ar.add(s[i], s[i], ar.C(r * COLS + i));
            ar.add(s[COLS + i], s[COLS + i], ar.D(r * COLS + i));
        }
        mds<W>(ar, s);
        if constexpr (A::LOCKSTEP) {
            flystel<COLS>(ar, s, s + COLS);
        } else {
#pragma unroll
            for (int i = 0; i < COLS; ++i) flystel<1>(ar, s + i, s + COLS + i);
        }
    }
    mds<W>(ar, s);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// The word count of a library's C interface: each of jive.cu and sponge.cu
// is built once with -DANEMOI_WORDS=8 and once with -DANEMOI_WORDS=12
// (_build.py), so the two word counts build in parallel and a library's
// AnemoiConsts layout says which it is.
#ifndef ANEMOI_WORDS
#define ANEMOI_WORDS 8
#endif
static_assert(ANEMOI_WORDS == 8 || ANEMOI_WORDS == 12, "ANEMOI_WORDS is 8 or 12");

// Runs launch() (kernel launches on a stream of `device`) with `device`
// current and returns the first error, with cudaGetLastError() checked
// after the launch.  The calling thread's current device is the same
// afterwards.
template <class Launch>
inline int launch_on(int device, Launch launch) {
    int prev;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    launch();
    err = cudaGetLastError();
    if (prev != device) {
        const cudaError_t back = cudaSetDevice(prev);
        if (err == cudaSuccess) err = back;
    }
    return (int)err;
}

#endif  // __CUDACC__
