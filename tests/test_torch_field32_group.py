"""The sponge kernel's group arithmetic, built for the host with g++:
csrc/field32_group.cuh's word-sliced Montgomery product, add, subtract and
limb conversions against Python ints, at 8 and 12 words.

On the card four lanes of a warp share one field element, lane l holding
words [l S, l S + S); here the header's HostLanes policy holds all four
lanes in one object and runs every per-lane statement for each, so the
test runs the statements the kernel runs.  A value's NW words, in order,
are exactly the four lanes' slices.  The edge values are those where
carries and borrows run across lanes: lanes of all-ones or all-zero words,
p - 1, 2^(32 NW) - 1 as the product's first operand, and 2^256 - 189 and
2^384 - 317, which leave no spare top bit.  Tolerance: exact.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from anemoi_tpu_torch._build import CSRC
from anemoi_tpu_torch.fields.params import FIELD_NAMES, FIELDS_20, FIELDS_30, get_field, limbs_from_int

from .test_torch_field32 import PRIMES, _ints, _ptr, _values, _words

_SHIM = r"""
#include <stddef.h>
#include "field32_group.cuh"
#define BY_WORDS(f, ...) (words == 8 ? f<8>(__VA_ARGS__) : f<12>(__VA_ARGS__))
// a value's NW words are the four lanes' slices, lane after lane
template <int NW> using Slices = uint32_t (*)[NW / 4];
template <int NW> using CSlices = const uint32_t (*)[NW / 4];
// the products take n0 = -p^-1 mod 2^32 lifted to a slice's width, as GroupArith does
template <int NW> void glift_n(uint32_t* r, const uint32_t* p, uint32_t n0) { g_lift_n0<NW>(r, p, n0); }
template <int NW> void gmul_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p, uint32_t n0) {
    uint32_t nd[NW / 4];
    g_lift_n0<NW>(nd, p, n0);
    for (int i = 0; i < n; ++i)
        g_mont_mul<NW, HostLanes>(Slices<NW>(r + NW * i), CSlices<NW>(a + NW * i), CSlices<NW>(b + NW * i),
                                  CSlices<NW>(p), nd);
}
// two products side by side (g_mont_mul_n<2>, the lockstep columns): values 2i and 2i + 1
template <int NW> void gmul2_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p, uint32_t n0) {
    using E = uint32_t[HostLanes::H][NW / 4];
    uint32_t nd[NW / 4];
    g_lift_n0<NW>(nd, p, n0);
    for (int i = 0; i + 1 < n; i += 2)
        g_mont_mul_n<NW, HostLanes, 2>((E*)(r + NW * i), (const E*)(a + NW * i), (const E*)(b + NW * i), CSlices<NW>(p), nd);
}
template <int NW> void gadd_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p) {
    for (int i = 0; i < n; ++i)
        g_add<NW, HostLanes>(Slices<NW>(r + NW * i), CSlices<NW>(a + NW * i), CSlices<NW>(b + NW * i), CSlices<NW>(p));
}
template <int NW> void gsub_n(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p) {
    for (int i = 0; i < n; ++i)
        g_sub<NW, HostLanes>(Slices<NW>(r + NW * i), CSlices<NW>(a + NW * i), CSlices<NW>(b + NW * i), CSlices<NW>(p));
}
template <int NW> void gfrom_n(uint32_t* r, const int32_t* limbs, int n, const uint32_t* c_in, const uint32_t* p,
                               uint32_t n0) {
    uint32_t nd[NW / 4];
    g_lift_n0<NW>(nd, p, n0);
    for (int i = 0; i < n; ++i) g_from_limbs<NW, HostLanes>(Slices<NW>(r + NW * i), limbs + i, (size_t)n, c_in, CSlices<NW>(p), nd);
}
template <int NW> void gto_n(int32_t* limbs, const uint32_t* a, int n, const uint32_t* c_out, const uint32_t* p,
                             uint32_t n0, int store) {
    uint32_t nd[NW / 4];
    g_lift_n0<NW>(nd, p, n0);
    for (int i = 0; i < n; ++i)
        g_to_limbs<NW, HostLanes>(limbs + i, (size_t)n, CSlices<NW>(a + NW * i), c_out, CSlices<NW>(p), nd, store != 0);
}
extern "C" {
void t_gmul(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p, uint32_t n0) {
    BY_WORDS(gmul_n, r, a, b, n, p, n0);
}
void t_gmul2(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p, uint32_t n0) {
    BY_WORDS(gmul2_n, r, a, b, n, p, n0);
}
void t_gadd(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p) {
    BY_WORDS(gadd_n, r, a, b, n, p);
}
void t_gsub(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p) {
    BY_WORDS(gsub_n, r, a, b, n, p);
}
void t_gfrom_limbs(uint32_t* r, const int32_t* limbs, int n, int words, const uint32_t* c_in, const uint32_t* p,
                   uint32_t n0) {
    BY_WORDS(gfrom_n, r, limbs, n, c_in, p, n0);
}
void t_gto_limbs(int32_t* limbs, const uint32_t* a, int n, int words, const uint32_t* c_out, const uint32_t* p,
                 uint32_t n0, int store) {
    BY_WORDS(gto_n, limbs, a, n, c_out, p, n0, store);
}
void t_lift_n0(uint32_t* r, int words, const uint32_t* p, uint32_t n0) { BY_WORDS(glift_n, r, p, n0); }
unsigned t_lookahead(unsigned g, unsigned q) { return g_lookahead(g, q); }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("field32_group")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libfield32_group.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.t_lookahead.restype = ctypes.c_uint
    return lib


def _lane_edges(prime, nw):
    """Values whose lanes are all ones or all zeros, or equal p's lanes:
    carries and borrows that run through whole lanes, and the width."""
    s = 32 * nw // 4
    full = (1 << s) - 1
    out = []
    for mask in range(1, 16):  # every set of all-ones lanes
        out.append(sum(full << (s * l) for l in range(4) if mask >> l & 1))
    for k in range(1, 4):
        out += [1 << (s * k), (1 << (s * k)) - 1, prime - (1 << (s * k)), prime - (1 << (s * k)) + 1,
                prime >> (s * k) << (s * k), (prime >> (s * k) << (s * k)) - 1]
    return out


def _edge_values(prime, nw):
    return [v % prime for v in _lane_edges(prime, nw)] + [0, 1, 2, prime - 1, prime - 2, prime // 2, prime // 2 + 1]


def test_lookahead(lib):
    """Every generate/pass pattern of four lanes against a ripple through them."""
    for g in range(16):
        for q in range(16):
            if g & q:
                continue
            want, carry = 0, 0
            for lane in range(4):
                want |= carry << lane
                carry = (g >> lane) & 1 | ((q >> lane) & 1 & carry)
            want |= carry << 4
            assert lib.t_lookahead(g, q) == want, (g, q)


@pytest.mark.parametrize("prime", PRIMES, ids=list(FIELDS_20) + ["p256"] + list(FIELDS_30) + ["p384"])
def test_group_arithmetic(lib, prime):
    """g_mont_mul (alone and two side by side, g_mont_mul_n<2>), g_add and
    g_sub on every pair of the edge values and on random canonical pairs;
    the product also with a first operand from p up to 2^(32 NW) - 1, as
    the entry conversion gives it."""
    nw = 8 if prime < 1 << 256 else 12
    r_words = 1 << (32 * nw)
    p, n0 = _words([prime], nw)[0], ctypes.c_uint32(-pow(prime, -1, 2**32) % 2**32)
    rinv = pow(r_words, -1, prime)
    edges = _edge_values(prime, nw)
    a_vals = [x for x in edges for _ in edges] + _values(prime, 200, 1)
    b_vals = [y for _ in edges for y in edges] + _values(prime, 200, 2)[::-1]
    # a - b and a + b at the edges of p: equal, one apart, summing to p and p - 1
    a_vals += [x for x in edges for _ in range(4)]
    b_vals += [v % prime for x in edges for v in (x, x + 1, x - 1 + prime, prime - x)]
    a, b = _words(a_vals, nw), _words(b_vals, nw)
    n = len(a_vals)
    r = np.zeros_like(a)

    lib.t_gmul(_ptr(r), _ptr(a), _ptr(b), n, nw, _ptr(p), n0)
    assert _ints(r) == [x * y * rinv % prime for x, y in zip(a_vals, b_vals)]
    lib.t_gmul(_ptr(r), _ptr(a), _ptr(a), n, nw, _ptr(p), n0)  # the squaring
    assert _ints(r) == [x * x * rinv % prime for x in a_vals]
    m = n - n % 2
    r[:] = 0
    lib.t_gmul2(_ptr(r), _ptr(a), _ptr(b), m, nw, _ptr(p), n0)
    assert _ints(r[:m]) == [x * y * rinv % prime for x, y in zip(a_vals[:m], b_vals[:m])]
    lib.t_gadd(_ptr(r), _ptr(a), _ptr(b), n, nw, _ptr(p))
    assert _ints(r) == [(x + y) % prime for x, y in zip(a_vals, b_vals)]
    lib.t_gsub(_ptr(r), _ptr(a), _ptr(b), n, nw, _ptr(p))
    assert _ints(r) == [(x - y) % prime for x, y in zip(a_vals, b_vals)]

    big = _lane_edges(prime, nw) + [r_words - 1, r_words - prime, prime, prime + 1] + _values(prime, 100, 3, below=r_words)
    small = ([prime - 1, prime - 2, 1, prime // 2] * len(big))[: len(big)]
    r = np.zeros((len(big), nw), np.uint32)
    lib.t_gmul(_ptr(r), _ptr(_words(big, nw)), _ptr(_words(small, nw)), len(big), nw, _ptr(p), n0)
    assert _ints(r) == [x * y * rinv % prime for x, y in zip(big, small)]


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_group_limb_boundary(lib, field):
    """g_from_limbs and g_to_limbs against Python ints, as
    test_torch_field32.py holds f32_from_limbs and f32_to_limbs; and a group
    that must not store leaves the output as it was."""
    fp = get_field(field)
    nw, L = fp.kernel_words, fp.n_limbs
    r_words = 1 << (32 * nw)
    p, n0 = _words([fp.p], nw)[0], ctypes.c_uint32(fp.kernel_n0)
    c_in, c_out = _words([fp.c_in], nw)[0], _words([fp.c_out], nw)[0]
    vals = (_edge_values(fp.p, nw) + _values(fp.p, 100, 4) + _values(fp.p, 30, 5, below=r_words)
            + [r_words - 1, (1 << (13 * L)) - 1])
    limbs = np.stack([limbs_from_int(v, L) for v in vals], axis=1)
    n = len(vals)
    words = np.zeros((n, nw), np.uint32)
    lib.t_gfrom_limbs(_ptr(words), _ptr(limbs), n, nw, _ptr(c_in), _ptr(p), n0)
    shift = pow(2, 13 * L - 32 * nw, fp.p)
    assert _ints(words) == [v % r_words * pow(shift, -1, fp.p) % fp.p for v in vals]

    back = np.zeros_like(limbs)
    lib.t_gto_limbs(_ptr(back), _ptr(words), n, nw, _ptr(c_out), _ptr(p), n0, 1)
    assert [sum(int(x) << (13 * i) for i, x in enumerate(back[:, j])) for j in range(n)] == [
        v % r_words % fp.p for v in vals]
    assert back.min() >= 0 and back.max() < (1 << 13)
    untouched = np.full_like(limbs, -1)
    lib.t_gto_limbs(_ptr(untouched), _ptr(words), n, nw, _ptr(c_out), _ptr(p), n0, 0)
    assert (untouched == -1).all()


_IDS = list(FIELDS_20) + ["p256"] + list(FIELDS_30) + ["p384"]


def _setup(prime):
    nw = 8 if prime < 1 << 256 else 12
    p, n0 = _words([prime], nw)[0], ctypes.c_uint32(-pow(prime, -1, 2**32) % 2**32)
    return nw, p, n0, 1 << (32 * nw // 4)


def _digits_for_top_m(prime, b, nw):
    """A first operand a below 2^(32 NW) whose digits (lane slices) make
    every one of the product's four steps take m = D - 1 against b (odd):
    step i's sum of the running value and digit * b is p mod D in its low
    digit, so m = that times -p^-1 is -1 mod D."""
    d = 1 << (32 * nw // 4)
    inv_b0 = pow(b % d, -1, d)
    t, a = 0, 0
    for i in range(4):
        digit = (prime - t) * inv_b0 % d
        assert (t + digit * b) * -pow(prime, -1, d) % d == d - 1
        t = (t + digit * b + (d - 1) * prime) // d
        a += digit << (32 * nw // 4 * i)
    return a


@pytest.mark.parametrize("prime", PRIMES, ids=_IDS)
def test_group_product_digits(lib, prime):
    """The product at the edges of its lane-wide digits (D = 2^(32 NW / 4)),
    alone and two side by side: digits of all ones against lane slices of
    all ones, the largest digit product and deferred high words; operands
    that make every step's m = D - 1, the largest m * p; a first operand
    from p up to 2^(32 NW) - 1 against a second below p, and the other way
    round."""
    nw, p, n0, d = _setup(prime)
    r_words = 1 << (32 * nw)
    rinv = pow(r_words, -1, prime)
    ones = [sum((d - 1) << (32 * nw // 4 * l) for l in range(4) if mask >> l & 1) for mask in range(1, 16)]
    below = [v for v in ones if v < prime] + [prime - 1, prime - 2, prime - d, prime // d * d - 1]
    below = [v for v in below if v < prime]
    pairs = [(x, y) for x in ones for y in below]  # a up to R - 1 (every digit all ones), b below p
    rng = np.random.default_rng(7)
    odd = [int.from_bytes(rng.bytes(48), "little") % prime | 1 for _ in range(40)]
    odd = [y for y in odd + [1, prime - 2] if y < prime]
    pairs += [(_digits_for_top_m(prime, y, nw), y) for y in odd]
    big = [r_words - 1, r_words - 2, r_words - prime, prime, prime + 1] + _values(prime, 40, 8, below=r_words)
    big = [v for v in big if v >= prime]
    small = _values(prime, 8, 9)
    pairs += [(x, y) for x in big for y in small]
    pairs += [(y, x) for x in big for y in small]  # a below p, b from p up to R - 1
    a, b = _words([x for x, _ in pairs], nw), _words([y for _, y in pairs], nw)
    want = [x * y * rinv % prime for x, y in pairs]
    n = len(pairs)
    r = np.zeros_like(a)
    lib.t_gmul(_ptr(r), _ptr(a), _ptr(b), n, nw, _ptr(p), n0)
    assert _ints(r) == want
    # two side by side, each value once as either column
    for s in (0, 1):
        m = (n - s) - (n - s) % 2
        r[:] = 0
        lib.t_gmul2(_ptr(r[s:]), _ptr(a[s:]), _ptr(b[s:]), m, nw, _ptr(p), n0)
        assert _ints(r[s:s + m]) == want[s:s + m]


@pytest.mark.parametrize("prime", PRIMES, ids=_IDS)
def test_lift_n0(lib, prime):
    """g_lift_n0, Newton's lift of n0 = -p^-1 mod 2^32 to a lane slice's
    width, equals -p^-1 mod 2^(32 NW / 4): 64 bits at 8 words, 96 at 12."""
    nw, p, n0, d = _setup(prime)
    r = np.zeros(nw // 4, np.uint32)
    lib.t_lift_n0(_ptr(r), nw, _ptr(p), n0)
    assert _ints([r]) == [-pow(prime, -1, d) % d]
