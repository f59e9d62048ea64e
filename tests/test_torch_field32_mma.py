"""The tensor-core Montgomery product of csrc/field32_mma.cuh and the Jive
of csrc/jive_mma.cu, built for the host with g++.

On the card the quad form of the tensor-core permutation and sponge holds
8 states a warp, one on each quad of four lanes, and the reduction's two
products by constants run as mma.sync on the tensor cores; here the
header's HostWarp policy holds the whole warp in one object and computes
each mma from its definition over the 32 lanes' fragment registers, so the
test runs the statements the kernel runs.  Checked: the emulated mma
against a direct integer matrix product; the quad form's product
(mma_mont_mul_n, alone and two side by side, as the permutation's two
columns run) against f32_mont_mul and f32_mont_sqr and Python ints on
10,000 random canonical pairs of each of the 7 fields and of 2^256 - 189
and 2^384 - 317 (no spare top bit), with the edge values; the Jive of
jive_mma.cu's warp (one state a thread, tests/test_torch_jive_mma_thread.py
holds its product and window) against the native oracle, for 2_1 and 4_3
at 8 and 12 words, k = 2 and 4, ragged warps.
On the card (skipped here): the kernel against jive_kernel and the plain
version.  Tolerance: exact.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from anemoi_tpu_torch._build import CSRC
from anemoi_tpu_torch.ff import cuda_backend, mxu_ops, native
from anemoi_tpu_torch.ff.limb_ops import random_canonical
from anemoi_tpu_torch.fields.params import get_instance

from .test_torch_field32 import PRIMES, _ints, _ptr, _words
from .test_torch_field32_group import _edge_values

_SHIM = r"""
#include <stddef.h>
#include "jive_mma.cu"
#define BY_WORDS(f, ...) (words == 8 ? f<8>(__VA_ARGS__) : f<12>(__VA_ARGS__))
template <int NW> using E = uint32_t[MMA_WARP][NW / 4];
// value s of a warp's 8 (word j at v[s * NW + j]) <-> the element: state s is row s, quad s
template <int NW> void to_elem(E<NW>& e, const uint32_t* v) {
    for (int s = 0; s < MMA_STATES; ++s)
        for (int t = 0; t < 4; ++t)
            for (int j = 0; j < NW / 4; ++j) e[4 * s + t][j] = v[s * NW + t * (NW / 4) + j];
}
template <int NW> void from_elem(uint32_t* v, const E<NW>& e) {
    for (int s = 0; s < MMA_STATES; ++s)
        for (int t = 0; t < 4; ++t)
            for (int j = 0; j < NW / 4; ++j) v[s * NW + t * (NW / 4) + j] = e[4 * s + t][j];
}
template <int NW> void mul_warps(uint32_t* r, const uint32_t* a, const uint32_t* b, int warps, int pairs,
                                 const uint32_t* p, const uint32_t* frag) {
    uint32_t ps[4][NW / 4];
    g_slice<NW, HostLanes>(ps, p);
    for (int w = 0; w < warps; w += pairs) {
        E<NW> x[2], y[2], z[2];
        for (int k = 0; k < pairs; ++k) {
            to_elem<NW>(x[k], a + (size_t)(w + k) * MMA_STATES * NW);
            to_elem<NW>(y[k], b + (size_t)(w + k) * MMA_STATES * NW);
        }
        if (pairs == 1) mma_mont_mul_n<NW, HostWarp, 1>(z, x, y, ps, frag);
        else mma_mont_mul_n<NW, HostWarp, 2>(z, x, y, ps, frag);
        for (int k = 0; k < pairs; ++k) from_elem<NW>(r + (size_t)(w + k) * MMA_STATES * NW, z[k]);
    }
}
template <int NW> void f32mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, const uint32_t* p, uint32_t n0, int sqr) {
    for (int i = 0; i < n; ++i) {
        if (sqr) f32_mont_sqr<NW>(r + NW * i, a + NW * i, p, n0);
        else f32_mont_mul<NW>(r + NW * i, a + NW * i, b + NW * i, p, n0);
    }
}
// jive_mma.cu's warp (32 states, MmaThreadArith) over its shared memory's host counterparts: the
// fragments lane-major (mt_frag_word), the warp's scratch rows, its threads' window tables (stride 32)
template <int NW> void jive_n(int32_t* out, const int32_t* in, long long n, int width, int k, const void* consts, const uint32_t* frag) {
    static uint32_t lanes[mt_frag_words<NW>], rows[MMA_THREAD_STATES * MMA_ROW_WORDS], tab[INV_ALPHA_TABLE * NW * MMA_WARP];
    mt_copy_fragments<NW>(lanes, frag, 0, 1);
    const MmaThreadArith<NW, HostWarp> ar{*(const AnemoiConsts<NW>*)consts, lanes, rows, tab, MMA_WARP};
    for (long long base = 0; base < n; base += MMA_THREAD_STATES) {
        if (width == 2) jive_mma_warp<2, 2, NW, HostWarp>(out, in, n, base, ar);
        else if (k == 2) jive_mma_warp<4, 2, NW, HostWarp>(out, in, n, base, ar);
        else jive_mma_warp<4, 4, NW, HostWarp>(out, in, n, base, ar);
    }
}
extern "C" {
void t_mma(int32_t* d, const uint32_t* a, const uint32_t* b, int k) {
    if (k == 32) HostWarp::mma<32>((int32_t(*)[4])d, (const uint32_t(*)[4])a, (const uint32_t(*)[2])b);
    else HostWarp::mma<16>((int32_t(*)[4])d, (const uint32_t(*)[2])a, (const uint32_t(*)[1])b);
}
void t_mma_mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int warps, int pairs, int words, const uint32_t* p, const uint32_t* frag) {
    BY_WORDS(mul_warps, r, a, b, warps, pairs, p, frag);
}
void t_f32_mul(uint32_t* r, const uint32_t* a, const uint32_t* b, int n, int words, const uint32_t* p, uint32_t n0, int sqr) {
    BY_WORDS(f32mul, r, a, b, n, p, n0, sqr);
}
void t_jive(int32_t* out, const int32_t* in, long long n, int width, int k, int words, const void* consts, const uint32_t* frag) {
    BY_WORDS(jive_n, out, in, n, width, k, consts, frag);
}
}
"""

N_PAIRS = 10_000


def build_shim(tmp_path_factory, name: str, shim: str) -> ctypes.CDLL:
    """A shim of csrc/ sources, built with g++ into a temporary directory
    and loaded; skips the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp(name)
    (d / "shim.cpp").write_text(shim)
    so = d / f"lib{name}.so"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory, "field32_mma", _SHIM)
    lib.t_jive.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("k", [32, 16])
def test_emulated_mma(lib, k):
    """HostWarp's mma over packed fragments equals A B."""
    rng = np.random.default_rng(k)
    for _ in range(4):
        a, b = rng.integers(0, 256, (16, k)), rng.integers(0, 256, (k, 8))
        pa, pb = mxu_ops.pack_a(a), mxu_ops.pack_b(b)
        d = np.zeros((32, 4), np.int32)
        lib.t_mma(_ptr(d), _ptr(pa), _ptr(pb), k)
        np.testing.assert_array_equal(mxu_ops.unpack_d(d), a @ b)


@pytest.mark.parametrize("prime", PRIMES, ids=[f"{p.bit_length()}b{i}" for i, p in enumerate(PRIMES)])
def test_reduction_matches_f32(lib, prime):
    """mma_mont_mul_n (one product a warp of 8 states, and two side by side) equals
    f32_mont_mul and, on a by itself, f32_mont_sqr and Python ints."""
    nw = 8 if prime < 1 << 256 else 12
    rng = np.random.default_rng(prime % 1000)
    edges = _edge_values(prime, nw)
    n = N_PAIRS + (-N_PAIRS - 2 * len(edges)) % 32  # whole warps, an even count of them
    a_vals = edges + edges[::-1] + [int.from_bytes(rng.bytes(48), "little") % prime for _ in range(n)]
    b_vals = edges[::-1] + [prime - 1] * len(edges) + [int.from_bytes(rng.bytes(48), "little") % prime
                                                        for _ in range(n)]
    a, b = _words(a_vals, nw), _words(b_vals, nw)
    p, n0 = _words([prime], nw)[0], ctypes.c_uint32(-pow(prime, -1, 2**32) % 2**32)
    frag = mxu_ops.fragment_words(prime)
    warps = len(a_vals) // 8
    rinv = pow(1 << (32 * nw), -1, prime)
    for pairs in (1, 2):
        got, want = np.zeros_like(a), np.zeros_like(a)
        lib.t_mma_mul(_ptr(got), _ptr(a), _ptr(b), warps, pairs, nw, _ptr(p), _ptr(frag))
        lib.t_f32_mul(_ptr(want), _ptr(a), _ptr(b), len(a_vals), nw, _ptr(p), n0, 0)
        np.testing.assert_array_equal(got, want)
    assert _ints(got) == [x * y * rinv % prime for x, y in zip(a_vals, b_vals)]
    lib.t_mma_mul(_ptr(got), _ptr(a), _ptr(a), warps, 1, nw, _ptr(p), _ptr(frag))
    lib.t_f32_mul(_ptr(want), _ptr(a), _ptr(a), len(a_vals), nw, _ptr(p), n0, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("field,iname,k,n", [
    ("vesta", "anemoi_2_1", 2, 16), ("vesta", "anemoi_4_3", 2, 16), ("vesta", "anemoi_4_3", 4, 11),
    ("bls12_381", "anemoi_2_1", 2, 16), ("bls12_381", "anemoi_4_3", 4, 16),
    ("vesta", "anemoi_2_1", 2, 11), ("vesta", "anemoi_2_1", 2, 45), ("vesta", "anemoi_4_3", 2, 45),
    ("vesta", "anemoi_4_3", 4, 45), ("bls12_381", "anemoi_2_1", 2, 45), ("bls12_381", "anemoi_4_3", 2, 11),
    ("bls12_377", "anemoi_4_3", 4, 45),
])
def test_host_jive_matches_oracle(lib, field, iname, k, n):
    """jive_mma_warp over HostWarp (MmaThreadArith, 32 states a warp), warp
    after warp as the kernel's grid runs them, against the native oracle:
    widths 2 and 4, k = 2 and 4, 8 and 12 words; n = 11 and 16 one ragged
    warp, 45 a whole one and a ragged one; nothing is written past the n
    states."""
    inst = get_instance(field, iname)
    W, L = inst.width, inst.field.n_limbs
    st = random_canonical(inst.field, (W, n), np.random.default_rng(n + W)).transpose(1, 0, 2).copy()
    x = np.ascontiguousarray(st.reshape(W * L, n))
    rows = (W // k) * L
    out = np.full(rows * n + 64, -1, np.int32)  # a guard past the output
    lib.t_jive(_ptr(out), _ptr(x), n, W, k, inst.field.kernel_words, _ptr(cuda_backend.consts_words(inst)),
               _ptr(mxu_ops.fragment_words(inst.field)))
    assert (out[rows * n:] == -1).all()
    want = native.jive_batch_canonical(inst, native.canonical_host(inst, torch.from_numpy(st)), k)
    got = native.canonical_host(inst, torch.from_numpy(out[:rows * n].reshape(rows, n)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(45)
    for field, iname, k in [("vesta", "anemoi_2_1", 2), ("vesta", "anemoi_4_3", 4), ("bls12_381", "anemoi_2_1", 2)]:
        inst = get_instance(field, iname)
        W, L = inst.width, inst.field.n_limbs
        x = torch.from_numpy(random_canonical(inst.field, (W, 131), rng).transpose(1, 0, 2).copy())
        x = x.reshape(W * L, 131).cuda()
        before = cuda_backend.launch_counts()["jive_mma"]
        out = cuda_backend.jive(inst, k, x, "mxuf").cpu().numpy()
        assert cuda_backend.launch_counts()["jive_mma"] == before + 1
        np.testing.assert_array_equal(out, cuda_backend.jive(inst, k, x).cpu().numpy())
        np.testing.assert_array_equal(out, cuda_backend.jive_plain(inst, k, x).cpu().numpy())
