// Prime-field arithmetic shared by a group of four lanes: one field element
// on NW = 8 or 12 32-bit words is split word-wise over the group, lane l
// holding words [l S, l S + S) with S = NW / 4 (2 or 3).  The sponge kernel
// (sponge.cu) runs one message on four adjacent lanes of a warp this way, so
// the instruction stream of one message is cut about in four.
//
// Values are as in field32.cuh: little-endian words, canonical, Montgomery
// form with R' = 2^(32 NW); only where they live differs.  A group value is
// uint32_t[H][S]: the slices of the H lanes that the caller holds.
//
// The lane policy P says how lanes talk:
//   * WarpLanes (below, on the card): a thread is one lane, H = 1; the
//     group is four adjacent lanes of a warp, and a broadcast, a shift or a
//     vote is one __shfl_sync or __ballot_sync of width 4.  Every lane of the
//     warp must reach every call: the code here never branches on a lane's
//     data, only on values the whole warp shares.
//   * HostLanes (below): one object holds all four lanes, H = 4, and every
//     per-lane statement is a loop over them; a shuffle reads another held
//     lane's value.  The host tests build this header with g++ through it,
//     so they run the statements the kernel runs.
//
// Carries between lanes.  An add or subtract runs its carry (or borrow)
// chain inside each lane; each lane then says whether it generates a carry
// out and whether it would pass one on (its words all ones, or all zeros
// for a borrow), two votes, and g_lookahead turns the two 4-bit masks into
// the carry into every lane at once, as a carry-lookahead adder would.  The
// Montgomery product (CIOS) defers its carries: see g_mont_mul_n.
#pragma once

#include <stdint.h>

#include "field32.cuh"

#ifdef __CUDACC__
#define G32_MEMBER __host__ __device__ __forceinline__
#else
#define G32_MEMBER inline
#endif

#define G32_LANES 4

// One object holds the four lanes of a group (the host build).
struct HostLanes {
    static constexpr int H = G32_LANES;
    G32_MEMBER static int lane(int h) { return h; }
    // out = v of lane src, in every lane
    G32_MEMBER static void bcast(uint32_t out[H], const uint32_t v[H], int src) {
        const uint32_t x = v[src];
        for (int h = 0; h < H; ++h) out[h] = x;
    }
    // out = v of lane l + 1; lane 3 takes lane 0's
    G32_MEMBER static void next(uint32_t out[H], const uint32_t v[H]) {
        for (int h = 0; h < H; ++h) out[h] = v[(h + 1) % H];
    }
    // out = v of lane l - 1; lane 0 takes 0
    G32_MEMBER static void prev(uint32_t out[H], const uint32_t v[H]) {
        for (int h = H - 1; h > 0; --h) out[h] = v[h - 1];
        out[0] = 0;
    }
    // out = v of lane l - 1; lane 0 takes lane 3's
    G32_MEMBER static void rot(uint32_t out[H], const uint32_t v[H]) {
        for (int h = 0; h < H; ++h) out[h] = v[(h + H - 1) % H];
    }
    // bit l set iff lane l's predicate holds
    G32_MEMBER static uint32_t ballot(const bool pred[H]) {
        uint32_t bits = 0;
        for (int h = 0; h < H; ++h) bits |= (uint32_t)pred[h] << h;
        return bits;
    }
};

#ifdef __CUDACC__
// A thread is one lane of a group of four adjacent lanes of its warp (the
// four-lane kernels of sponge.cu and jive_mma.cu).  The whole warp reaches
// every call (blocks are whole warps, and no lane leaves early).  The
// functions are __host__ __device__ only so that the templates instantiated
// for the kernels need no host counterpart; their host bodies never run.
#ifdef __CUDA_ARCH__
#define WARP_LANES(device, host) device
#else
#define WARP_LANES(device, host) host
#endif
struct WarpLanes {
    static constexpr int H = 1;
    static constexpr unsigned FULL = 0xffffffffu;
    G32_MEMBER static int lane(int) { return WARP_LANES((int)(threadIdx.x % G32_LANES), 0); }
    G32_MEMBER static void bcast(uint32_t out[1], const uint32_t v[1], int src) {
        out[0] = WARP_LANES(__shfl_sync(FULL, v[0], src, G32_LANES), v[0]);
    }
    // lane 3's source, lane 4, wraps to lane 0 of the group
    G32_MEMBER static void next(uint32_t out[1], const uint32_t v[1]) {
        out[0] = WARP_LANES(__shfl_sync(FULL, v[0], lane(0) + 1, G32_LANES), v[0]);
    }
    G32_MEMBER static void prev(uint32_t out[1], const uint32_t v[1]) {
        const uint32_t x = WARP_LANES(__shfl_up_sync(FULL, v[0], 1, G32_LANES), 0u);
        out[0] = lane(0) ? x : 0u;
    }
    // lane 0's source, lane -1, wraps to lane 3 of the group
    G32_MEMBER static void rot(uint32_t out[1], const uint32_t v[1]) {
        out[0] = WARP_LANES(__shfl_sync(FULL, v[0], lane(0) + G32_LANES - 1, G32_LANES), v[0]);
    }
    // the group's four votes, lane l at bit l
    G32_MEMBER static uint32_t ballot(const bool pred[1]) {
        return WARP_LANES((__ballot_sync(FULL, pred[0]) >> (threadIdx.x % 32 & ~(G32_LANES - 1u))), 0u) &
               ((1u << G32_LANES) - 1);
    }
};
#endif  // __CUDACC__

// The carry into each lane (bit l) and out of the group (bit 4), from the
// lanes that generate a carry (g) and those that pass an incoming one on
// (q; g and q share no bit): an incoming carry runs up through a block of
// passing lanes exactly as the binary sum (g << 1) + q carries through q.
F32_FN uint32_t g_lookahead(uint32_t g, uint32_t q) { return ((g << 1) + q) ^ q; }

// a += bit (0 or 1) over S words; returns the carry out.
template <int S>
F32_FN uint32_t g_add_bit(uint32_t a[S], uint32_t bit) {
    uint32_t c = bit;
#pragma unroll
    for (int j = 0; j < S; ++j) {
        const uint64_t v = (uint64_t)a[j] + c;
        a[j] = (uint32_t)v;
        c = (uint32_t)(v >> 32);
    }
    return c;
}

// a -= bit (0 or 1) over S words.
template <int S>
F32_FN void g_sub_bit(uint32_t a[S], uint32_t bit) {
    uint32_t b = bit;
#pragma unroll
    for (int j = 0; j < S; ++j) {
        const uint64_t v = (uint64_t)a[j] - b;
        a[j] = (uint32_t)v;
        b = (uint32_t)(v >> 32) & 1u;
    }
}

// Each held lane's slice of a whole value w[NW] (a constant, or words every
// lane holds): selects over the four slices, so no register array is
// indexed by the lane at run time.
template <int NW, class P>
F32_FN void g_slice(uint32_t r[][NW / 4], const uint32_t w[NW]) {
    constexpr int S = NW / 4;
#pragma unroll
    for (int h = 0; h < P::H; ++h) {
        const int l = P::lane(h);
#pragma unroll
        for (int j = 0; j < S; ++j) {
            uint32_t v = w[j];
#pragma unroll
            for (int k = 1; k < G32_LANES; ++k) v = l == k ? w[k * S + j] : v;
            r[h][j] = v;
        }
    }
}

template <int NW, class P>
F32_FN void g_copy(uint32_t r[][NW / 4], const uint32_t a[][NW / 4]) {
#pragma unroll
    for (int h = 0; h < P::H; ++h)
#pragma unroll
        for (int j = 0; j < NW / 4; ++j) r[h][j] = a[h][j];
}

// r = t mod p for N values t + top * 2^(32 NW) below 2p, side by side; only
// lane 3's top is read.  One vote pair settles the borrows of t - p; the
// whole group then keeps t or t - p.
template <int NW, class P, int N>
F32_FN void g_reduce_once_n(uint32_t (*r)[P::H][NW / 4], const uint32_t (*t)[P::H][NW / 4],
                            const uint32_t (*top)[P::H], const uint32_t p[][NW / 4]) {
    constexpr int S = NW / 4, H = P::H;
    uint32_t d[N][H][S], bin[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
        bool gen[H], pass[H];
#pragma unroll
        for (int h = 0; h < H; ++h) {
            uint32_t borrow = 0, any = 0;
#pragma unroll
            for (int j = 0; j < S; ++j) {
                const uint64_t v = (uint64_t)t[k][h][j] - p[h][j] - borrow;
                d[k][h][j] = (uint32_t)v;
                borrow = (uint32_t)(v >> 32) & 1u;
                any |= d[k][h][j];
            }
            // the top lane's words continue into `top`, which absorbs a borrow
            const bool open = P::lane(h) != G32_LANES - 1 || top[k][h] == 0;
            gen[h] = borrow && open;
            pass[h] = any == 0 && open;
        }
        bin[k] = g_lookahead(P::ballot(gen), P::ballot(pass));
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const bool take = ((bin[k] >> G32_LANES) & 1u) == 0;  // no borrow out: t >= p
#pragma unroll
        for (int h = 0; h < H; ++h) {
            g_sub_bit<S>(d[k][h], (bin[k] >> P::lane(h)) & 1u);
#pragma unroll
            for (int j = 0; j < S; ++j) r[k][h][j] = take ? d[k][h][j] : t[k][h][j];
        }
    }
}

template <int NW, class P>
F32_FN void g_reduce_once(uint32_t r[][NW / 4], const uint32_t t[][NW / 4], const uint32_t top[],
                          const uint32_t p[][NW / 4]) {
    using E = uint32_t[P::H][NW / 4];
    g_reduce_once_n<NW, P, 1>(reinterpret_cast<E*>(r), reinterpret_cast<const E*>(t),
                              reinterpret_cast<const uint32_t(*)[P::H]>(top), p);
}

// r = a + b mod p.
template <int NW, class P>
F32_FN void g_add(uint32_t r[][NW / 4], const uint32_t a[][NW / 4], const uint32_t b[][NW / 4],
                  const uint32_t p[][NW / 4]) {
    constexpr int S = NW / 4, H = P::H;
    uint32_t s[H][S], top[H];
    bool gen[H], pass[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
        uint32_t carry = 0, all = ~0u;
#pragma unroll
        for (int j = 0; j < S; ++j) {
            const uint64_t v = (uint64_t)a[h][j] + b[h][j] + carry;
            s[h][j] = (uint32_t)v;
            carry = (uint32_t)(v >> 32);
            all &= s[h][j];
        }
        gen[h] = carry != 0;
        pass[h] = all == ~0u;
    }
    const uint32_t cin = g_lookahead(P::ballot(gen), P::ballot(pass));
#pragma unroll
    for (int h = 0; h < H; ++h) {
        g_add_bit<S>(s[h], (cin >> P::lane(h)) & 1u);
        top[h] = (cin >> G32_LANES) & 1u;
    }
    g_reduce_once<NW, P>(r, s, top, p);
}

// r = a - b mod p.
template <int NW, class P>
F32_FN void g_sub(uint32_t r[][NW / 4], const uint32_t a[][NW / 4], const uint32_t b[][NW / 4],
                  const uint32_t p[][NW / 4]) {
    constexpr int S = NW / 4, H = P::H;
    uint32_t d[H][S];
    bool gen[H], pass[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
        uint32_t borrow = 0, any = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
            const uint64_t v = (uint64_t)a[h][j] - b[h][j] - borrow;
            d[h][j] = (uint32_t)v;
            borrow = (uint32_t)(v >> 32) & 1u;
            any |= d[h][j];
        }
        gen[h] = borrow != 0;
        pass[h] = any == 0;
    }
    const uint32_t bin = g_lookahead(P::ballot(gen), P::ballot(pass));
    const bool under = (bin >> G32_LANES) & 1u;  // a < b: add p back, and drop the carry out of that
#pragma unroll
    for (int h = 0; h < H; ++h) {
        g_sub_bit<S>(d[h], (bin >> P::lane(h)) & 1u);
        uint32_t carry = 0, all = ~0u;
#pragma unroll
        for (int j = 0; j < S; ++j) {
            const uint64_t v = (uint64_t)d[h][j] + (under ? p[h][j] : 0u) + carry;
            d[h][j] = (uint32_t)v;
            carry = (uint32_t)(v >> 32);
            all &= d[h][j];
        }
        gen[h] = carry != 0;
        pass[h] = all == ~0u;
    }
    const uint32_t cin = g_lookahead(P::ballot(gen), P::ballot(pass));
#pragma unroll
    for (int h = 0; h < H; ++h) g_add_bit<S>(d[h], (cin >> P::lane(h)) & 1u);
    g_copy<NW, P>(r, d);
}

// r[k] = a[k] * b[k] / 2^(32 NW) mod p (CIOS over the NW words of a[k]) for
// N independent products side by side, each a[k] below 2^(32 NW) and b[k]
// below p, or the other way round.  r may alias a or b.
//
// Step i: a_i is broadcast from lane i / S, and each lane adds a_i * b and
// then m * p over its own S words, m = t_0 * n0 broadcast from lane 0 (whose
// low word is the sum's, exact).  The carries out of a lane's top word are
// not passed up: they wait in the lane's `hi` (weight 2^(32 S) above the
// lane's low word).  The shift by one word then brings in the next lane's
// low word as the lane's new top word, and `hi`, now at that word's weight,
// is added into it there, inside the lane; what is left of hi stays below 4.
// After NW steps one shift up of every lane's hi and one vote pair settle
// the sum, and g_reduce_once_n takes p off if it is at least p.  The N
// products run each phase of a step in turn, so one product's shuffles
// are in flight while the others multiply.
template <int NW, class P, int N>
F32_FN void g_mont_mul_n(uint32_t (*r)[P::H][NW / 4], const uint32_t (*a)[P::H][NW / 4],
                         const uint32_t (*b)[P::H][NW / 4], const uint32_t p[][NW / 4], uint32_t n0) {
    constexpr int S = NW / 4, H = P::H;
    uint32_t t[N][H][S], v[H], ai[N][H], m[N][H], nx[N][H];
    uint64_t hi[N][H];
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
        for (int h = 0; h < H; ++h) {
            hi[k][h] = 0;
#pragma unroll
            for (int j = 0; j < S; ++j) t[k][h][j] = 0;
        }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
#pragma unroll
            for (int h = 0; h < H; ++h) v[h] = a[k][h][i % S];
            P::bcast(ai[k], v, i / S);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
#pragma unroll
            for (int h = 0; h < H; ++h) {
                uint64_t c = 0;
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    const uint64_t s = (uint64_t)ai[k][h] * b[k][h][j] + t[k][h][j] + c;
                    t[k][h][j] = (uint32_t)s;
                    c = s >> 32;
                }
                hi[k][h] += c;
                v[h] = t[k][h][0] * n0;
            }
            P::bcast(m[k], v, 0);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
#pragma unroll
            for (int h = 0; h < H; ++h) {
                uint64_t c = 0;
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    const uint64_t s = (uint64_t)m[k][h] * p[h][j] + t[k][h][j] + c;
                    t[k][h][j] = (uint32_t)s;
                    c = s >> 32;
                }
                hi[k][h] += c;
                v[h] = t[k][h][0];
            }
            // lane 3 takes lane 0's low word, which m * p has just made 0
            P::next(nx[k], v);
#pragma unroll
            for (int h = 0; h < H; ++h) {
#pragma unroll
                for (int j = 0; j < S - 1; ++j) t[k][h][j] = t[k][h][j + 1];
                const uint64_t s = (uint64_t)nx[k][h] + hi[k][h];
                t[k][h][S - 1] = (uint32_t)s;
                hi[k][h] = s >> 32;
            }
        }
    }
    // settle: lane l's hi joins lane l + 1's words; lane 3's is the top
    uint32_t top[N][H], cin[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
        bool gen[H], pass[H];
#pragma unroll
        for (int h = 0; h < H; ++h) top[k][h] = (uint32_t)hi[k][h];
        P::prev(v, top[k]);
#pragma unroll
        for (int h = 0; h < H; ++h) {
            uint32_t carry = v[h], all = ~0u;
#pragma unroll
            for (int j = 0; j < S; ++j) {
                const uint64_t s = (uint64_t)t[k][h][j] + carry;
                t[k][h][j] = (uint32_t)s;
                carry = (uint32_t)(s >> 32);
                all &= t[k][h][j];
            }
            gen[h] = carry != 0;
            pass[h] = all == ~0u;
        }
        cin[k] = g_lookahead(P::ballot(gen), P::ballot(pass));
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
        for (int h = 0; h < H; ++h) {
            g_add_bit<S>(t[k][h], (cin[k] >> P::lane(h)) & 1u);
            top[k][h] += (cin[k] >> G32_LANES) & 1u;
        }
    g_reduce_once_n<NW, P, N>(r, t, top, p);
}

// r = a * b / 2^(32 NW) mod p: one product (g_mont_mul_n).
template <int NW, class P>
F32_FN void g_mont_mul(uint32_t r[][NW / 4], const uint32_t a[][NW / 4], const uint32_t b[][NW / 4],
                       const uint32_t p[][NW / 4], uint32_t n0) {
    using E = uint32_t[P::H][NW / 4];
    g_mont_mul_n<NW, P, 1>(reinterpret_cast<E*>(r), reinterpret_cast<const E*>(a), reinterpret_cast<const E*>(b),
                           p, n0);
}

// A value's NL 13-bit limbs at src[l * stride] -> R' form, as f32_from_limbs:
// every lane reads all the limbs (the group's four reads hit the same
// addresses), packs the words and keeps its slice; then one group product
// by c_in.
template <int NW, class P>
F32_FN void g_from_limbs(uint32_t r[][NW / 4], const int32_t* src, size_t stride, const uint32_t c_in[NW],
                         const uint32_t p[][NW / 4], uint32_t n0) {
    constexpr int S = NW / 4;
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
    uint32_t x[P::H][S], k[P::H][S];
    g_slice<NW, P>(x, w);
    g_slice<NW, P>(k, c_in);
    g_mont_mul<NW, P>(r, x, k, p, n0);
}

// a in R' form -> NL canonical 13-bit limbs at dst[l * stride], as
// f32_to_limbs: one group product by c_out, the words gathered into every
// lane, and lane l writes the limbs l, l + 4, ... when `store` holds.
template <int NW, class P>
F32_FN void g_to_limbs(int32_t* dst, size_t stride, const uint32_t a[][NW / 4], const uint32_t c_out[NW],
                       const uint32_t p[][NW / 4], uint32_t n0, bool store) {
    constexpr int S = NW / 4, H = P::H;
    uint32_t x[H][S], k[H][S], v[H], w[H][NW], got[H];
    g_slice<NW, P>(k, c_out);
    g_mont_mul<NW, P>(x, a, k, p, n0);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
#pragma unroll
        for (int h = 0; h < H; ++h) v[h] = x[h][j % S];
        P::bcast(got, v, j / S);
#pragma unroll
        for (int h = 0; h < H; ++h) w[h][j] = got[h];
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
        const int l0 = P::lane(h);
#pragma unroll
        for (int l = 0; l < f32_limbs<NW>; ++l) {
            const int bit = l * F32_LIMB_BITS, word = bit / 32, shift = bit % 32;
            uint32_t u = w[h][word] >> shift;
            if (shift + F32_LIMB_BITS > 32 && word + 1 < NW) u |= w[h][word + 1] << (32 - shift);
            if (store && l % G32_LANES == l0) dst[(size_t)l * stride] = (int32_t)(u & F32_LIMB_MASK);
        }
    }
}
