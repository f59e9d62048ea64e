// The Montgomery product with its reduction on Hopper's integer tensor
// cores: the counterpart of anemoi_tpu/ff/mxu_ops.py:mont_mul_mxu, the JAX
// package's product whose two products by constants run on the TPU's matrix
// unit.  Two forms: field32_group.cuh's word-sliced elements, one state a
// quad, 8 a warp (mma_mont_mul_n: the quad form of sponge_mma.cu's
// permutation and sponge), and whole elements, one state a thread, 32 a
// warp (mt_mont_reduce, at the end of this file: the Jive of jive_mma.cu and
// the thread form of sponge_mma.cu's permutation).
//
// The quad form.  A warp holds 8 states: quad g (lanes 4g .. 4g + 3) holds
// the state of fragment row g of mma.sync m16n8k32 (u8 x u8 -> s32),
// word-sliced over the quad as in field32_group.cuh (lane t holds words
// [t S, t S + S), S = NW / 4).  Rows g + 8 of A read zero: the tensor cores
// are a few percent of a product's instructions, and a lane that carried a
// second state would run the group code twice.  An element of the 8 states
// is uint32_t[T][S]: [thread held][word].
//
// The product r = a b / R' mod p, R' = 2^(32 NW), p' = -p^-1 mod R':
//   1. T = a b on the integer pipe (g_mul_wide_n): the group's word-sliced
//      operand scanning, one word of a a step, with no m p.  The window
//      shifts down one word a step, and the word that leaves it at lane 0,
//      product word i, joins a queue of S words a lane that moves down the
//      quad one word a step (lane 3 takes it), so T's low half ends sliced
//      as the A fragment wants it; the high half is the window, its
//      deferred carries left for step 3's carry pass.
//   2. m = T_low p' mod R' on the tensor cores: A is T_low's bytes, the
//      constant's byte Toeplitz matrix is B (anemoi_tpu_torch/ff/mxu_ops.py,
//      in the fragment order that B loads).  K is permuted so that lane t's
//      A registers are its own words (K slots t and t + 4 hold words t S and
//      t S + 1, and a 12-word field's k16 step's slot t word t S + 2), and N
//      so that tile j's accumulator gives lane t its own bytes 2j and 2j + 1:
//      no operand crosses lanes.  Each lane sums its 4S byte columns (each
//      below 48 * 255^2 < 2^22, exact in s32) into S words and what is above
//      them; that goes to the next lane, and one vote pair settles the carry
//      bits (g_carry_in_n).  The top lane's carry out is dropped (mod R').
//   3. U = m p on the tensor cores, 2S + 1 tiles: U's high half, added to
//      T's high half in the same column sums, and the low half's top two
//      columns.  The low half is never summed: T_low + U_low is 0 or R' mod
//      R', and the carry into each 16-bit chunk of it stays below 2^16, so
//      the carry out of the low half is (X >> 16) + (X mod 2^16 != 0) for X
//      the top chunk's two U columns plus T_low's top 16 bits.  Lane 3
//      holds both and passes that carry to lane 0 in the same shuffle that
//      brings each other lane the overflow of the lane below.
//   4. The sum is below 2p: g_reduce_once_n takes p off.
// Per product and quad: 3 NW shuffles in T, 2 in the carries; the tensor
// cores do NW / 2 + NW / 2 + 1 n8 tiles (a k32 step each, plus a k16 step at
// 12 words) for 8 states.
//
// The warp policy M says where the lanes are:
//   * WarpMma (on the card): a thread is one lane, T = 1; the mma is one
//     inline PTX instruction, and the quads' group code runs over WarpLanes.
//   * HostWarp: one object holds the whole warp, T = 32, and computes each
//     mma from its definition over the 32 lanes' fragment registers, after
//     the PTX ISA's m16n8k32 and m16n8k16 layouts for .u8 (and ldmatrix
//     from its definition over the lanes' addresses); the group code runs
//     over HostLanes, each quad's four lanes.  The host tests build this
//     header with g++ through it, so they run the statements the kernel runs.
// Every lane of the warp must reach every mma: nothing here branches on a
// lane's data around one.
#pragma once

#include <stdint.h>

#include "field32_group.cuh"

#define MMA_WARP 32
// The second bound of __launch_bounds__ for a register budget v counted in
// blocks of 128 threads an SM (v caps a thread at 65,536 / (128 v)
// registers): that many warps' worth of blocks of `block` threads, so that
// one value means one budget in every source and block shape.
#define MMA_MIN_RESIDENT(v, block) ((v) * 128 / (block))
#define MMA_STATES 8  // states a warp under the quad form: quad g holds row g

// B-fragment registers of one n8 tile (the k32 step's two, and a 12-word
// field's k16 step's one), and the tiles of m and of U.
template <int NW>
constexpr int mma_regs = NW == 8 ? 2 : 3;
template <int NW>
constexpr int mma_m_tiles = NW / 2;
template <int NW>
constexpr int mma_u_tiles = NW / 2 + 1;
// The words of the constant fragments (mxu_ops.fragment_words): word
// (tile * R + r) * 32 + lane, m's tiles first.
template <int NW>
constexpr int mma_frag_words = (mma_m_tiles<NW> + mma_u_tiles<NW>) * mma_regs<NW> * MMA_WARP;

// The whole warp in one object (the host build).
struct HostWarp {
    static constexpr int T = MMA_WARP;  // threads held
    using G = HostLanes;  // the group policy of each quad's four lanes
    static int lane_id(int i) { return i; }
    // d += a b for a K = 32 (m16n8k32) or K = 16 (m16n8k16) step, u8 x u8 ->
    // s32, from the fragment layouts: lane L = 4 g + t;
    //   A: register r holds row g + 8 (r & 1), columns 4t + 16 (r >> 1) + i;
    //   B: register r holds rows (K) 4t + 16 r + i, column g;
    //   C, D: register r holds row g + 8 (r >> 1), column 2t + (r & 1);
    // byte i of a register at bits 8i.
    template <int K>
    static void mma(int32_t d[][4], const uint32_t a[][K / 8], const uint32_t b[][K / 16]) {
        uint32_t A[16][K], B[K][8];
        for (int L = 0; L < MMA_WARP; ++L) {
            const int g = L / 4, t = L % 4;
            for (int r = 0; r < K / 8; ++r)
                for (int i = 0; i < 4; ++i) A[g + 8 * (r & 1)][4 * t + 16 * (r >> 1) + i] = (a[L][r] >> (8 * i)) & 0xffu;
            for (int r = 0; r < K / 16; ++r)
                for (int i = 0; i < 4; ++i) B[4 * t + 16 * r + i][g] = (b[L][r] >> (8 * i)) & 0xffu;
        }
        for (int L = 0; L < MMA_WARP; ++L) {
            const int g = L / 4, t = L % 4;
            for (int r = 0; r < 4; ++r) {
                const int row = g + 8 * (r >> 1), col = 2 * t + (r & 1);
                uint32_t s = 0;
                for (int k = 0; k < K; ++k) s += A[row][k] * B[k][col];
                d[L][r] += (int32_t)s;
            }
        }
    }
    // ldmatrix.sync.aligned.m8n8.x{Q}.shared.b16: lane 8q + i gives the
    // address of row i of 8 x 8 b16 matrix q (16 bytes), and lane L
    // receives in register q the word L % 4 of matrix q's row L / 4
    template <int Q>
    static void ldsm(uint32_t d[][Q], const uint32_t* const addr[]) {
        for (int L = 0; L < MMA_WARP; ++L)
            for (int q = 0; q < Q; ++q) d[L][q] = addr[8 * q + L / 4][L % 4];
    }
    static void sync() {}
};

#ifdef __CUDACC__
// A thread is one lane of the warp (jive_mma.cu); WarpLanes and WARP_LANES
// are field32_group.cuh's.
struct WarpMma {
    static constexpr int T = 1;
    using G = WarpLanes;
    G32_MEMBER static int lane_id(int) { return WARP_LANES((int)(threadIdx.x % MMA_WARP), 0); }
    template <int K>
    G32_MEMBER static void mma(int32_t d[][4], const uint32_t a[][K / 8], const uint32_t b[][K / 16]) {
#ifdef __CUDA_ARCH__
        if constexpr (K == 32)
            asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};"
                : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
                : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]), "r"(b[0][0]), "r"(b[0][1]));
        else
            asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
                "{%0, %1, %2, %3};"
                : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
                : "r"(a[0][0]), "r"(a[0][1]), "r"(b[0][0]));
#endif
    }
    // HostWarp::ldsm's load, from the lane's own address in shared memory
    template <int Q>
    G32_MEMBER static void ldsm(uint32_t d[][Q], const uint32_t* const addr[]) {
#ifdef __CUDA_ARCH__
        const unsigned at = (unsigned)__cvta_generic_to_shared(addr[0]);
        if constexpr (Q == 4)
            asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                         : "=r"(d[0][0]), "=r"(d[0][1]), "=r"(d[0][2]), "=r"(d[0][3])
                         : "r"(at)
                         : "memory");
        else
            asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
                         : "=r"(d[0][0]), "=r"(d[0][1])
                         : "r"(at)
                         : "memory");
#endif
    }
    // the warp's shared-memory writes so far are seen by its other lanes
    G32_MEMBER static void sync() {
#ifdef __CUDA_ARCH__
        __syncwarp();
#endif
    }
};
#endif  // __CUDACC__

// t[k] += what each lane takes from the lane below it, for N groups side by
// side: lane l > 0 takes lane l - 1's ov, lane 0 takes lane 3's in0 (both
// below 2^32), in one rotation; then one vote pair settles the carry bits.
// Lane 3's own ov and the carry out of the group are its top word; other
// lanes' top is 0.
template <int NW, class P, int N>
F32_FN void g_carry_in_n(uint32_t (*t)[P::H][NW / 4], const uint32_t (*ov)[P::H], const uint32_t (*in0)[P::H],
                         uint32_t (*top)[P::H]) {
    constexpr int S = NW / 4, H = P::H;
    uint32_t v[H], got[N][H], cin[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
        for (int h = 0; h < H; ++h) v[h] = P::lane(h) == G32_LANES - 1 ? in0[k][h] : ov[k][h];
        P::rot(got[k], v);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
        bool gen[H], pass[H];
#pragma unroll
        for (int h = 0; h < H; ++h) {
            uint32_t carry = got[k][h], all = ~0u;
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
            top[k][h] = (P::lane(h) == G32_LANES - 1 ? ov[k][h] : 0u) + ((cin[k] >> G32_LANES) & 1u);
        }
}

// lo[k], hi[k] + carry[k] = the low and high halves of a[k] * b[k] (2 NW
// words, each half sliced as the operands) for N products side by side,
// a[k] and b[k] below 2^(32 NW): lo exact, hi with each lane's deferred
// carry (below 4, at the weight of the next lane's first word; lane 3's is
// 0) left in carry for the caller's next carry pass.  Step i adds a_i (broadcast from lane i / S) times the
// lane's slice of b into its window, and shifts the
// window down one word: lane l takes lane l + 1's low word as its new top
// word, with its own deferred carry `up` added there; lane 3's new top word
// is its carry alone.  The word leaving lane 0 is product word i: lane 3
// takes it from that same shuffle onto the conveyor, lo, a queue of S words
// a lane: each step every lane's oldest word moves to the lane below as its
// newest (one shuffle), and lane 3's newest is the word that left.  After
// NW steps the queue holds the NW low words in order, lane l's slots words
// l S .. l S + S - 1, and the window is the high half.
template <int NW, class P, int N>
F32_FN void g_mul_wide_n(uint32_t (*lo)[P::H][NW / 4], uint32_t (*hi)[P::H][NW / 4], uint32_t (*carry)[P::H],
                         const uint32_t (*a)[P::H][NW / 4], const uint32_t (*b)[P::H][NW / 4]) {
    constexpr int S = NW / 4, H = P::H;
    uint32_t v[H], ai[N][H], nx[N][H], got[N][H];
    uint64_t up[N][H];
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
        for (int h = 0; h < H; ++h) {
            up[k][h] = 0;
#pragma unroll
            for (int j = 0; j < S; ++j) lo[k][h][j] = hi[k][h][j] = 0;
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
                    const uint64_t s = (uint64_t)ai[k][h] * b[k][h][j] + hi[k][h][j] + c;
                    hi[k][h][j] = (uint32_t)s;
                    c = s >> 32;
                }
                up[k][h] += c;
                v[h] = hi[k][h][0];
            }
            P::next(nx[k], v);
#pragma unroll
            for (int h = 0; h < H; ++h) v[h] = lo[k][h][0];
            P::next(got[k], v);
#pragma unroll
            for (int h = 0; h < H; ++h) {
                const bool last = P::lane(h) == G32_LANES - 1;
#pragma unroll
                for (int j = 0; j < S - 1; ++j) {
                    hi[k][h][j] = hi[k][h][j + 1];
                    lo[k][h][j] = lo[k][h][j + 1];
                }
                const uint64_t s = (uint64_t)(last ? 0u : nx[k][h]) + up[k][h];
                hi[k][h][S - 1] = (uint32_t)s;
                up[k][h] = s >> 32;
                lo[k][h][S - 1] = last ? nx[k][h] : got[k][h];
            }
        }
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
        for (int h = 0; h < H; ++h) carry[k][h] = (uint32_t)up[k][h];
}

// acc[j] = the NT n8 tiles from tile0 of x's bytes (A, the 8 states of an
// element, uint32_t[T][S]) times the constant's fragments (B: `frag`, word
// (tile * R + r) * 32 + lane).  Lane t's A registers are its own words: word
// 0 (K slot t, row g), then word 1 (slot t + 4); at 12 words a k16 step
// takes word 2.  Rows g + 8 are zero.
template <int NW, class M, int NT>
F32_FN void mma_tiles(int32_t (*acc)[M::T][4], const uint32_t (*x)[NW / 4], const uint32_t* frag, int tile0) {
    constexpr int T = M::T, R = mma_regs<NW>;
    uint32_t a[T][4], a16[T][2];
#pragma unroll
    for (int i = 0; i < T; ++i) {
        a[i][0] = x[i][0];
        a[i][1] = 0;
        a[i][2] = x[i][1];
        a[i][3] = 0;
        if constexpr (NW == 12) {
            a16[i][0] = x[i][2];
            a16[i][1] = 0;
        }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        uint32_t b[T][2], b16[T][1];
#pragma unroll
        for (int i = 0; i < T; ++i) {
            const uint32_t* f = frag + (tile0 + j) * R * MMA_WARP + M::lane_id(i);
            b[i][0] = f[0];
            b[i][1] = f[MMA_WARP];
            if constexpr (NW == 12) b16[i][0] = f[2 * MMA_WARP];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[j][i][r] = 0;
        }
        M::template mma<32>(acc[j], a, b);
        if constexpr (NW == 12) M::template mma<16>(acc[j], a16, b16);
    }
}

// w = the S words of thread i's row-g byte columns in the first 2S tiles
// (tile j holds the lane's bytes 2j and 2j + 1), plus add[] where given;
// returns what is above them (below 2^15).  w may alias add.
template <int NW, class M>
F32_FN uint32_t mma_words(uint32_t w[NW / 4], const int32_t (*acc)[M::T][4], int i, const uint32_t* add) {
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; j < NW / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
            s += ((uint64_t)(uint32_t)acc[2 * j + e][i][0] << (16 * e)) +
                 ((uint64_t)(uint32_t)acc[2 * j + e][i][1] << (16 * e + 8));
        if (add) s += add[j];
        w[j] = (uint32_t)s;
        s >>= 32;
    }
    return (uint32_t)s;
}

// r[k] = a[k] * b[k] / 2^(32 NW) mod p for N products of 8-state elements
// side by side, a[k] below 2^(32 NW) and b[k] below p (or the other way
// round); p is the group's slices of p, frag the constant fragments.  r may
// alias a or b.
template <int NW, class M, int N>
F32_FN void mma_mont_mul_n(uint32_t (*r)[M::T][NW / 4], const uint32_t (*a)[M::T][NW / 4],
                           const uint32_t (*b)[M::T][NW / 4], const uint32_t p[][NW / 4], const uint32_t* frag) {
    using G = typename M::G;
    constexpr int S = NW / 4, T = M::T, H = G::H, NG = N * T / H, MT = mma_m_tiles<NW>;
    // the N products' T / H groups, as the group code takes them (C casts: nvcc refuses
    // reinterpret_cast between these pointers to arrays of const)
    using Group = uint32_t (*)[H][S];
    using CGroup = const uint32_t (*)[H][S];
    using Words = uint32_t (*)[H];
    using CWords = const uint32_t (*)[H];
    uint32_t tlo[N][T][S], thi[N][T][S], tup[N][T], m[N][T][S], ov[N][T], in0[N][T], top[N][T];
    g_mul_wide_n<NW, G, NG>((Group)tlo, (Group)thi, (Words)tup, (CGroup)a, (CGroup)b);
    // m = T_low p' mod R'
#pragma unroll
    for (int k = 0; k < N; ++k) {
        int32_t acc[MT][T][4];
        mma_tiles<NW, M, MT>(acc, tlo[k], frag, 0);
#pragma unroll
        for (int i = 0; i < T; ++i) {
            ov[k][i] = mma_words<NW, M>(m[k][i], acc, i, nullptr);
            in0[k][i] = 0;
        }
    }
    g_carry_in_n<NW, G, NG>((Group)m, (CWords)ov, (CWords)in0, (Words)top);
    // T_high + U_high + the carry out of T_low + U_low, with T_high's deferred carries
#pragma unroll
    for (int k = 0; k < N; ++k) {
        int32_t acc[MT + 1][T][4];
        mma_tiles<NW, M, MT + 1>(acc, m[k], frag, MT);
#pragma unroll
        for (int i = 0; i < T; ++i) {
            ov[k][i] = mma_words<NW, M>(thi[k][i], acc, i, thi[k][i]) + tup[k][i];
            const uint32_t x = (uint32_t)acc[MT][i][0] + ((uint32_t)acc[MT][i][1] << 8) +
                               (tlo[k][i][S - 1] >> 16);  // lane 3's: U's columns 4 NW - 2, 4 NW - 1
            in0[k][i] = (x >> 16) + ((x & 0xffffu) != 0);
        }
    }
    g_carry_in_n<NW, G, NG>((Group)thi, (CWords)ov, (CWords)in0, (Words)top);
    g_reduce_once_n<NW, G, NG>((Group)r, (CGroup)thi, (CWords)top, p);
}

// ---------------------------------------------------------------------------
// One state a thread: the product of jive_mma.cu's kernel and of
// sponge_mma.cu's thread-form permutation (MmaThreadArith in anemoi32.cuh).
//
// A warp holds 32 states, held thread i state i, each element whole in its
// thread as NW words, as field32.cuh's one-thread code holds it.  The
// product r = a b / R' mod p:
//   1. T = a b (mt_mul_wide: NW^2 word products) or a^2 (mt_sqr_wide:
//      NW (NW + 1) / 2, each cross product once and then doubled), 2 NW
//      words; every carry runs inside the thread.
//   2. m = T_low p' mod R' on the tensor cores.  The 32 states are the rows
//      of two m16 tiles, state i row i % 16 of tile i / 16.  Each thread
//      writes T_low to its row of the warp's scratch in shared memory in
//      the K order of mxu_ops.input_order (slot 4j + t holds word t S + j,
//      S = NW / 4), and ldmatrix loads both tiles' A fragments: an 8 x 8 b16
//      matrix's lane layout is the u8 A layout of m16n8k32 (and, at 12
//      words, of the m16n8k16 step over bytes 32 to 47).  B is the
//      constant's fragments (mxu_ops.fragment_words), lane-major in shared
//      memory (mt_frag_word).  N is in mxu_ops.m_order, so tiles 2j and
//      2j + 1 give lane t of quad g byte columns 4 (S t + j) to 4 (S t + j)
//      + 3 of the four states of its rows (g and g + 8 of both m16 tiles):
//      the lane recombines them into word S t + j of each, carrying from
//      its word j - 1.  It writes each state's slice t (its S words, and
//      what is above them, below 2^16, in the slice's fourth slot) to that
//      state's row, one 16-byte store; then each thread reads its four
//      slices back and adds each slice's overflow into the next one (the
//      top one leaves: mod R').
//   3. U = m p: m goes back through the row and ldmatrix, NW / 2 + 1 tiles
//      (mxu_ops.u_order): U's high half in slices as m, and the low half's
//      top two columns, from which follows the carry out of T_low + U_low
//      (as in mma_mont_mul_n: that sum is 0 mod R', and what comes into its
//      top 16 bits is below 2^16).  Lane 3 holds those two columns and
//      hands them over in the overflow slot of its slice, which its slice
//      leaves free: the high half's column sum is below p < R', so its top
//      slice has no overflow.
//   4. T_high + U_high + the slices' overflows + that carry, one carry
//      chain in the thread, below 2p; then f32_reduce_once.
// No shuffle and no vote: the lanes meet only in the scratch rows, with a
// warp barrier (M::sync) between one phase's writes and the next one's
// reads.  Rows are MMA_ROW_WORDS apart, 80 bytes: any eight consecutive
// rows fall on eight different 16-byte groups of banks, so ldmatrix, the
// slices' stores and each thread's 16-byte loads and stores of its own row
// run with at most two-way bank conflicts (the slices' stores) or none.
// The warp policy M gives the lanes as for mma_mont_mul_n, and ldsm and
// sync: HostWarp computes ldmatrix from its definition, WarpMma issues it.

#define MMA_THREAD_STATES 32  // states a warp: thread i's is row i % 16 of m16 tile i / 16
#define MMA_ROW_WORDS 20  // a state's row of the warp's scratch: 16 words of slices (or NW of a staged operand) + 4

// Where register r of `lane`'s B fragment of n8 tile `tile` lies in the
// kernel's shared memory: lane-major, a lane's registers side by side, in
// one 8-byte load at 8 words and one 16-byte load (three and a gap) at 12;
// mt_frag_words in all.
template <int NW>
constexpr int mt_frag_stride = NW == 8 ? 2 : 4;
template <int NW>
constexpr int mt_frag_words = (mma_m_tiles<NW> + mma_u_tiles<NW>) * MMA_WARP * mt_frag_stride<NW>;
template <int NW>
F32_FN int mt_frag_word(int tile, int r, int lane) {
    return (tile * MMA_WARP + lane) * mt_frag_stride<NW> + r;
}

// Copies words first, first + step, ... of the constants' fragments as
// mxu_ops.fragment_words lays them out (frag: word (tile * R + r) * 32 +
// lane) to their places in the lane-major layout at dst (mt_frag_word): a
// block's threads each take their share (first = the thread, step = the
// block), the host takes them all.
template <int NW>
F32_FN void mt_copy_fragments(uint32_t* dst, const uint32_t* frag, int first, int step) {
    constexpr int R = mma_regs<NW>;
    for (int i = first; i < mma_frag_words<NW>; i += step)
        dst[mt_frag_word<NW>(i / (R * MMA_WARP), i / MMA_WARP % R, i % MMA_WARP)] = frag[i];
}

// Four words at p (16-byte aligned), in one access on the card.
F32_FN void mt_store4(uint32_t* p, const uint32_t v[4]) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
#else
    for (int k = 0; k < 4; ++k) p[k] = v[k];
#endif
}
F32_FN void mt_load4(uint32_t v[4], const uint32_t* p) {
#ifdef __CUDA_ARCH__
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
#else
    for (int k = 0; k < 4; ++k) v[k] = p[k];
#endif
}

// t = a * b, 2 NW words, for a and b below 2^(32 NW): operand scanning,
// row i adding a * b_i at word i.  Word i of b is at b[i * bs], read once
// (b may lie in memory: the window table, in shared memory on the card).
template <int NW>
F32_FN void mt_mul_wide(uint32_t t[2 * NW], const uint32_t a[NW], const uint32_t* b, int bs) {
#pragma unroll
    for (int j = 0; j < NW; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        const uint32_t bi = b[i * bs];
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < NW; ++j) {
            const uint64_t s = (uint64_t)a[j] * bi + t[i + j] + c;
            t[i + j] = (uint32_t)s;
            c = s >> 32;
        }
        t[i + NW] = (uint32_t)c;
    }
}

// t = a^2, 2 NW words: the cross products a_i a_j, i < j, once each,
// doubled, then the squares a_i^2.
template <int NW>
F32_FN void mt_sqr_wide(uint32_t t[2 * NW], const uint32_t a[NW]) {
#pragma unroll
    for (int j = 0; j < 2 * NW; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < NW - 1; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = i + 1; j < NW; ++j) {
            const uint64_t s = (uint64_t)a[i] * a[j] + t[i + j] + c;
            t[i + j] = (uint32_t)s;
            c = s >> 32;
        }
        t[i + NW] = (uint32_t)c;
    }
    // twice the cross products is at most a^2 < 2^(64 NW): no bit leaves the top word
#pragma unroll
    for (int j = 2 * NW - 1; j > 0; --j) t[j] = (t[j] << 1) | (t[j - 1] >> 31);
    t[0] <<= 1;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        uint64_t s = (uint64_t)a[i] * a[i] + t[2 * i] + c;
        t[2 * i] = (uint32_t)s;
        s = (uint64_t)t[2 * i + 1] + (s >> 32);
        t[2 * i + 1] = (uint32_t)s;
        c = s >> 32;
    }
}

// Writes the NW words w to a row in the K order of the A fragments: slot
// 4j + t holds word t S + j.
template <int NW>
F32_FN void mt_stage(uint32_t* row, const uint32_t w[NW]) {
    constexpr int S = NW / 4;
#pragma unroll
    for (int j = 0; j < S; ++j) {
        const uint32_t v[4] = {w[j], w[S + j], w[2 * S + j], w[3 * S + j]};
        mt_store4(row + 4 * j, v);
    }
}

// The A fragments of both m16 tiles from the warp's rows: a[h], the k32
// step (bytes 0 to 31 of each row), and at 12 words a16[h], the k16 step
// (bytes 32 to 47).
template <int NW, class M>
F32_FN void mt_load_a(uint32_t (*a)[M::T][4], uint32_t (*a16)[M::T][2], const uint32_t* rows) {
    constexpr int T = M::T;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const uint32_t* addr[T];
#pragma unroll
        for (int i = 0; i < T; ++i) {
            const int L = M::lane_id(i);
            addr[i] = rows + (16 * h + (L & 7) + 8 * ((L >> 3) & 1)) * MMA_ROW_WORDS + 4 * (L >> 4);
        }
        M::template ldsm<4>(a[h], addr);
        if constexpr (NW == 12) {
#pragma unroll
            for (int i = 0; i < T; ++i) {
                const int L = M::lane_id(i);
                addr[i] = rows + (16 * h + (L & 7) + 8 * ((L >> 3) & 1)) * MMA_ROW_WORDS + 8;
            }
            M::template ldsm<2>(a16[h], addr);
        }
    }
}

// Tile `tile` of the constant times both m16 tiles' A: acc[h], zeroed first.
template <int NW, class M>
F32_FN void mt_tile(int32_t (*acc)[M::T][4], const uint32_t (*a)[M::T][4], const uint32_t (*a16)[M::T][2],
                    const uint32_t* frag, int tile) {
    constexpr int T = M::T;
    uint32_t b[T][2], b16[T][1];
#pragma unroll
    for (int i = 0; i < T; ++i) {
        const uint32_t* f = frag + mt_frag_word<NW>(tile, 0, M::lane_id(i));
        if constexpr (NW == 12) {
            uint32_t v[4];
            mt_load4(v, f);
            b[i][0] = v[0];
            b[i][1] = v[1];
            b16[i][0] = v[2];
        } else {
            b[i][0] = f[0];
            b[i][1] = f[1];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[h][i][r] = 0;
        M::template mma<32>(acc[h], a[h], b);
        if constexpr (NW == 12) M::template mma<16>(acc[h], a16[h], b16);
    }
}

// The product of the A fragments by tiles tile0 to tile0 + 2S - 1 of the
// constant, as slices: each held lane recombines its byte columns of the
// four states of its rows into their slice t (S words and the overflow, in
// slot 3) and writes each to the state's row.  With LOW_TOP, tile
// tile0 + 2S holds the low half's top two columns, and lane 3 writes them,
// as one value below 2^31, in place of its overflow (which is then 0).
template <int NW, class M, bool LOW_TOP>
F32_FN void mt_slices(uint32_t* rows, const uint32_t (*a)[M::T][4], const uint32_t (*a16)[M::T][2],
                      const uint32_t* frag, int tile0) {
    constexpr int T = M::T, S = NW / 4;
    uint32_t w[T][2][2][4];  // [held][m16 tile][row g or g + 8][slot]
    uint64_t carry[T][2][2];
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                carry[i][h][e] = 0;
                w[i][h][e][2] = 0;  // unused at 8 words
            }
#pragma unroll
    for (int j = 0; j < S; ++j) {
        int32_t acc[2][2][T][4];  // [tile 2j or 2j + 1][m16 tile]
        mt_tile<NW, M>(acc[0], a, a16, frag, tile0 + 2 * j);
        mt_tile<NW, M>(acc[1], a, a16, frag, tile0 + 2 * j + 1);
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    // bytes 0 and 1 of the word from tile 2j, 2 and 3 from tile 2j + 1; each below 2^31
                    const uint32_t lo = (uint32_t)acc[0][h][i][2 * e] + ((uint32_t)acc[0][h][i][2 * e + 1] << 8);
                    const uint32_t hi = (uint32_t)acc[1][h][i][2 * e] + ((uint32_t)acc[1][h][i][2 * e + 1] << 8);
                    const uint64_t s = ((uint64_t)hi << 16) + lo + carry[i][h][e];
                    w[i][h][e][j] = (uint32_t)s;
                    carry[i][h][e] = s >> 32;
                }
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) w[i][h][e][3] = (uint32_t)carry[i][h][e];
    if constexpr (LOW_TOP) {
        int32_t acc[2][T][4];
        mt_tile<NW, M>(acc, a, a16, frag, tile0 + 2 * S);
#pragma unroll
        for (int i = 0; i < T; ++i)
            if (M::lane_id(i) % 4 == 3)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        w[i][h][e][3] = (uint32_t)acc[h][i][2 * e] + ((uint32_t)acc[h][i][2 * e + 1] << 8);
    }
#pragma unroll
    for (int i = 0; i < T; ++i) {
        const int L = M::lane_id(i), g = L / 4, t = L % 4;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) mt_store4(rows + (16 * h + g + 8 * e) * MMA_ROW_WORDS + 4 * t, w[i][h][e]);
    }
}

// A thread's four slices from its row: w, its NW words as the lanes left
// them, and ov[t], slice t's overflow slot.
template <int NW>
F32_FN void mt_gather(uint32_t w[NW], uint32_t ov[4], const uint32_t* row) {
    constexpr int S = NW / 4;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        uint32_t v[4];
        mt_load4(v, row + 4 * t);
#pragma unroll
        for (int j = 0; j < S; ++j) w[t * S + j] = v[j];
        ov[t] = v[3];
    }
}

// r[i] = t[i] / 2^(32 NW) mod p for the held threads' 2 NW-word values
// t[i] < 2^(32 NW) p (steps 2 to 4 above); frag holds the constants'
// fragments (mt_frag_word), rows the warp's scratch.  Every lane of the
// warp must reach it.  r may alias nothing of t.
template <int NW, class M>
F32_FN void mt_mont_reduce(uint32_t (*r)[NW], const uint32_t (*t)[2 * NW], const uint32_t p[NW],
                           const uint32_t* frag, uint32_t* rows) {
    constexpr int T = M::T, S = NW / 4, MT = mma_m_tiles<NW>;
    uint32_t a[2][T][4], a16[2][T][2], w[T][NW], ov[T][4];
    // m = T_low p' mod R'
#pragma unroll
    for (int i = 0; i < T; ++i) mt_stage<NW>(rows + M::lane_id(i) * MMA_ROW_WORDS, t[i]);
    M::sync();
    mt_load_a<NW, M>(a, a16, rows);
    M::sync();
    mt_slices<NW, M, false>(rows, a, a16, frag, 0);
    M::sync();
#pragma unroll
    for (int i = 0; i < T; ++i) {
        uint32_t* row = rows + M::lane_id(i) * MMA_ROW_WORDS;
        mt_gather<NW>(w[i], ov[i], row);
        uint64_t s = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k) {
            s += w[i][k];
            if (k % S == 0 && k > 0) s += ov[i][k / S - 1];
            w[i][k] = (uint32_t)s;
            s >>= 32;
        }
        mt_stage<NW>(row, w[i]);
    }
    M::sync();
    // U = m p: its high half, and the carry out of T_low + U_low
    mt_load_a<NW, M>(a, a16, rows);
    M::sync();
    mt_slices<NW, M, true>(rows, a, a16, frag, MT);
    M::sync();
#pragma unroll
    for (int i = 0; i < T; ++i) {
        mt_gather<NW>(w[i], ov[i], rows + M::lane_id(i) * MMA_ROW_WORDS);
        const uint32_t x = ov[i][3] + (t[i][NW - 1] >> 16);  // U's columns 4 NW - 2, 4 NW - 1 and T_low's top 16 bits
        uint64_t s = (x >> 16) + ((x & 0xffffu) != 0);
        uint32_t hsum[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) {
            s += (uint64_t)t[i][NW + k] + w[i][k];
            if (k % S == 0 && k > 0) s += ov[i][k / S - 1];
            hsum[k] = (uint32_t)s;
            s >>= 32;
        }
        f32_reduce_once<NW>(r[i], hsum, (uint32_t)s, p);
    }
}
