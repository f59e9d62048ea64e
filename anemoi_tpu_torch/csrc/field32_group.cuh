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
// Montgomery product (CIOS) steps a lane's whole slice at a time and defers
// its carries: see g_mont_mul_n.
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

// r = a * b mod 2^(32 S), the low half of the product; r may alias a or b.
template <int S>
F32_FN void g_mul_low(uint32_t r[S], const uint32_t a[S], const uint32_t b[S]) {
    uint32_t t[S];
#pragma unroll
    for (int j = 0; j < S; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; i + j < S; ++j) {
            const uint64_t s = (uint64_t)a[i] * b[j] + t[i + j] + c;
            t[i + j] = (uint32_t)s;
            c = s >> 32;
        }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) r[j] = t[j];
}

// r = -p^-1 mod 2^(32 S), S = NW / 4: the Montgomery constant of one
// lane's slice, lifted from n0 = -p^-1 mod 2^32 (the constants' word) by
// Newton's step y <- y (2 + p y), which doubles the low bits that are
// right: once for 64 bits, twice for 96.
template <int NW>
F32_FN void g_lift_n0(uint32_t r[NW / 4], const uint32_t p[NW], uint32_t n0) {
    constexpr int S = NW / 4;
    r[0] = n0;
#pragma unroll
    for (int j = 1; j < S; ++j) r[j] = 0;
#pragma unroll
    for (int bits = 32; bits < 32 * S; bits *= 2) {
        uint32_t u[S];
        g_mul_low<S>(u, p, r);
        uint64_t c = 2;
#pragma unroll
        for (int j = 0; j < S; ++j) {
            c += u[j];
            u[j] = (uint32_t)c;
            c >>= 32;
        }
        g_mul_low<S>(r, r, u);
    }
}

// r[k] = a[k] * b[k] / 2^(32 NW) mod p for N independent products side by
// side, each a[k] below 2^(32 NW) and b[k] below p, or the other way round;
// n0 is g_lift_n0's.  r may alias a or b.
//
// Montgomery's CIOS with a lane's whole slice as the digit: radix
// D = 2^(32 S), four steps.  Step i: a's digit is lane i's S words,
// broadcast to every lane (a alone decides the 4 S broadcasts, so they are
// all issued before the first step).  Each lane adds digit * its slice of
// b to its S words t, a 2S-word sum u; m = u_low * n0 mod D, exact in lane
// 0, is broadcast from there (S independent shuffles), and each lane adds
// m * its slice of p to u, which makes lane 0's low S words 0.  The shift
// by one lane then brings lane l + 1's low S words into lane l (S
// independent shuffles; lane 3 takes lane 0's zeros), and lane l adds its
// own high words there, now at that weight, and its `hi`: the carry out of
// the last such add (below 4, at the weight of lane l + 1's first word),
// which waits there for the next step's.  So a product's chain holds two
// rounds of shuffles a step, 8 in all at 8 words and at 12, where steps of
// one word hold one a step, NW in all, and more dependent steps: at one
// warp a scheduler, as the sponge kernel runs, nothing hides that chain, and
// the slice steps' is the shorter though they issue more instructions (two
// products side by side overlap their chains, and there the word steps'
// fewer instructions were the faster: PERF.md).  After the 4 steps one
// shift up of every lane's hi and one vote pair settle the sum, and
// g_reduce_once_n takes p off if it is at least p.
// R stays 2^(32 NW), so the result is the word-by-word CIOS's.  The N
// products run each phase of a step in turn, so one product's shuffles are
// in flight while the others multiply.
template <int NW, class P, int N>
F32_FN void g_mont_mul_n(uint32_t (*r)[P::H][NW / 4], const uint32_t (*a)[P::H][NW / 4],
                         const uint32_t (*b)[P::H][NW / 4], const uint32_t p[][NW / 4], const uint32_t n0[NW / 4]) {
    constexpr int S = NW / 4, H = P::H;
    // dig[k][i][j]: word j of a[k]'s digit i, in every lane
    uint32_t dig[N][G32_LANES][S][H], t[N][H][S], hi[N][H], u[N][H][2 * S + 1], m[N][S][H], nx[N][S][H], v[S][H];
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
        for (int i = 0; i < G32_LANES; ++i)
#pragma unroll
            for (int j = 0; j < S; ++j) {
#pragma unroll
                for (int h = 0; h < H; ++h) v[j][h] = a[k][h][j];
                P::bcast(dig[k][i][j], v[j], i);
            }
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
        for (int h = 0; h < H; ++h) {
            hi[k][h] = 0;
#pragma unroll
            for (int j = 0; j < S; ++j) t[k][h][j] = 0;
        }
#pragma unroll
    for (int i = 0; i < G32_LANES; ++i) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
#pragma unroll
            for (int h = 0; h < H; ++h) {
                // u = t + digit * b < D^2: each row's last carry lands in a word no row has written
#pragma unroll
                for (int j = 0; j < S; ++j) u[k][h][j] = t[k][h][j];
#pragma unroll
                for (int x = 0; x < S; ++x) {
                    uint64_t c = 0;
#pragma unroll
                    for (int y = 0; y < S; ++y) {
                        const uint64_t s = (uint64_t)dig[k][i][x][h] * b[k][h][y] + u[k][h][x + y] + c;
                        u[k][h][x + y] = (uint32_t)s;
                        c = s >> 32;
                    }
                    u[k][h][x + S] = (uint32_t)c;
                }
                u[k][h][2 * S] = 0;
                uint32_t w[S];
                g_mul_low<S>(w, u[k][h], n0);
#pragma unroll
                for (int j = 0; j < S; ++j) v[j][h] = w[j];
            }
#pragma unroll
            for (int j = 0; j < S; ++j) P::bcast(m[k][j], v[j], 0);
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
#pragma unroll
            for (int h = 0; h < H; ++h) {
                // u += m * p < 2 D^2: the carry past word 2S - 1 is one bit, in word 2S
#pragma unroll
                for (int x = 0; x < S; ++x) {
                    uint64_t c = 0;
#pragma unroll
                    for (int y = 0; y < S; ++y) {
                        const uint64_t s = (uint64_t)m[k][x][h] * p[h][y] + u[k][h][x + y] + c;
                        u[k][h][x + y] = (uint32_t)s;
                        c = s >> 32;
                    }
#pragma unroll
                    for (int z = x + S; z <= 2 * S; ++z) {
                        const uint64_t s = (uint64_t)u[k][h][z] + c;
                        u[k][h][z] = (uint32_t)s;
                        c = s >> 32;
                    }
                }
#pragma unroll
                for (int j = 0; j < S; ++j) v[j][h] = u[k][h][j];
            }
            // lane 3 takes lane 0's low words, which m * p has just made 0
#pragma unroll
            for (int j = 0; j < S; ++j) P::next(nx[k][j], v[j]);
#pragma unroll
            for (int h = 0; h < H; ++h) {
                uint64_t c = hi[k][h];
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    const uint64_t s = (uint64_t)nx[k][j][h] + u[k][h][S + j] + c;
                    t[k][h][j] = (uint32_t)s;
                    c = s >> 32;
                }
                hi[k][h] = (uint32_t)c + u[k][h][2 * S];
            }
        }
    }
    // settle: lane l's hi joins lane l + 1's words; lane 3's is the top
    uint32_t top[N][H], cin[N], up[H];
#pragma unroll
    for (int k = 0; k < N; ++k) {
        bool gen[H], pass[H];
#pragma unroll
        for (int h = 0; h < H; ++h) top[k][h] = hi[k][h];
        P::prev(up, top[k]);
#pragma unroll
        for (int h = 0; h < H; ++h) {
            uint32_t carry = up[h], all = ~0u;
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
                       const uint32_t p[][NW / 4], const uint32_t n0[NW / 4]) {
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
                         const uint32_t p[][NW / 4], const uint32_t n0[NW / 4]) {
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
                       const uint32_t p[][NW / 4], const uint32_t n0[NW / 4], bool store) {
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
