"""The tensor-core permutation and sponge of csrc/sponge_mma.cu, built for
the host with g++.

On the card the quad form runs 8 states or messages a warp, one on each
quad of four lanes, and the thread form 32 states a warp, one a thread;
every product's reduction runs as mma.sync on the tensor cores.  Here
field32_mma.cuh's HostWarp policy holds the whole warp in one object and
computes each mma (and ldmatrix) from its definition, so the test runs the
statements the kernels run (permute_mma_warp, sponge_mma_warp and
permute_mma_thread_warp).  Checked, for anemoi_2_1 and anemoi_4_3 at 8
words (Vesta) and 12 (BLS12-381): the quad form's permutation of one
warp's 8 states, of two warps and of a ragged warp of 5, and the thread
form's of one warp's 32 states and of a whole and a ragged warp (45),
against the JAX package's pure-Python golden model
(``anemoi_tpu.ff.golden``) and the native oracle, with nothing stored past
the live states; the sponge over two warps of messages at E = rate, rate +
1, 2 rate and 7 (a whole and a ragged warp, 11, at E = 7), against the
golden model's ``hash_field``; the quad form's x^(1/alpha) (the window, its
columns side by side) against the golden model for the 7 fields; the
launcher's choice of form against the crossover the library reports, and
the wrapper's count of it.  Behind the JAX tests' own opt-in
(ANEMOI_PALLAS_INTERPRET=1), the same inputs through the JAX package's
``permutation_pallas`` and ``sponge_pallas`` with ``mul_impl="mxuf"`` in
interpret mode.  On the card (skipped here): both kernels against their
plain versions and the integer kernels.  Tolerance: exact.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.fields import params as jparams
from anemoi_tpu_torch.ff import cuda_backend, mxu_ops, native
from anemoi_tpu_torch.ff.limb_ops import decode_ints, random_canonical
from anemoi_tpu_torch.fields.params import FIELD_NAMES, get_field, get_instance

from .test_torch_field32 import _ints as _word_ints
from .test_torch_field32 import _ptr, _words
from .test_torch_field32_mma import build_shim
from .test_torch_sponge import _FakeCudaTensor

_SHIM = r"""
#include <stddef.h>
#include <string.h>
#include "sponge_mma.cu"
#define BY_WORDS(f, ...) (words == 8 ? f<8>(__VA_ARGS__) : f<12>(__VA_ARGS__))
// the quad form's arithmetic over one warp's window table (stride 32), as the kernels' shared memory holds it
template <int NW> struct Quad {
    uint32_t tab[mma_tab_words<4, NW> * MMA_WARP];
    MmaArith<NW, HostWarp> ar;
    Quad(const void* consts, const uint32_t* frag) : ar(*(const AnemoiConsts<NW>*)consts, frag, tab, MMA_WARP) {}
};
// the thread form's: the fragments lane-major, the warp's scratch rows, its threads' window tables (stride 32)
template <int NW> struct Thread {
    uint32_t frag[mt_frag_words<NW>];
    uint32_t rows[MMA_THREAD_STATES * MMA_ROW_WORDS];
    uint32_t tab[INV_ALPHA_TABLE * NW * MMA_WARP];
    MmaThreadArith<NW, HostWarp> ar;
    Thread(const void* consts, const uint32_t* f) : ar{*(const AnemoiConsts<NW>*)consts, frag, rows, tab, MMA_WARP} {
        memset(frag, 0, sizeof frag);
        mt_copy_fragments<NW>(frag, f, 0, 1);
    }
};
// the kernels' warps one after the other, HostWarp holding each whole
template <int NW> void permute_n(int32_t* out, const int32_t* in, long long n, int width, int quad, const void* consts,
                                 const uint32_t* frag) {
    if (quad) {
        Quad<NW>* q = new Quad<NW>(consts, frag);
        for (long long base = 0; base < n; base += MMA_STATES) {
            if (width == 2) permute_mma_warp<2, NW, HostWarp>(out, in, n, base, q->ar);
            else permute_mma_warp<4, NW, HostWarp>(out, in, n, base, q->ar);
        }
        delete q;
    } else {
        Thread<NW>* t = new Thread<NW>(consts, frag);
        for (long long base = 0; base < n; base += MMA_THREAD_STATES) {
            if (width == 2) permute_mma_thread_warp<2, NW, HostWarp>(out, in, n, base, t->ar);
            else permute_mma_thread_warp<4, NW, HostWarp>(out, in, n, base, t->ar);
        }
        delete t;
    }
}
template <int NW> void sponge_n(int32_t* out, const int32_t* in, long long n, int width, int E, const void* consts,
                                const uint32_t* frag) {
    Quad<NW>* q = new Quad<NW>(consts, frag);
    for (long long base = 0; base < n; base += MMA_STATES) {
        if (width == 2) sponge_mma_warp<2, NW, HostWarp>(out, in, n, E, base, q->ar);
        else sponge_mma_warp<4, NW, HostWarp>(out, in, n, E, base, q->ar);
    }
    delete q;
}
// x^(1/alpha) under MmaArith of `cols` columns side by side: column k of the warp's 8 states at
// x[(k * 8 + s) * NW + j]
template <int NW, int N> void pow_cols(uint32_t* r, const uint32_t* x, const void* consts, const uint32_t* frag) {
    using E = uint32_t[MMA_WARP][NW / 4];
    Quad<NW>* q = new Quad<NW>(consts, frag);
    E a[N], b[N];
    for (int k = 0; k < N; ++k)
        for (int s = 0; s < MMA_STATES; ++s)
            for (int t = 0; t < 4; ++t)
                for (int j = 0; j < NW / 4; ++j) a[k][4 * s + t][j] = x[(k * MMA_STATES + s) * NW + t * (NW / 4) + j];
    exp_inv_alpha<N>(q->ar, b, a);
    for (int k = 0; k < N; ++k)
        for (int s = 0; s < MMA_STATES; ++s)
            for (int t = 0; t < 4; ++t)
                for (int j = 0; j < NW / 4; ++j) r[(k * MMA_STATES + s) * NW + t * (NW / 4) + j] = b[k][4 * s + t][j];
    delete q;
}
template <int NW> void pow_n(uint32_t* r, const uint32_t* x, int cols, const void* consts, const uint32_t* frag) {
    if (cols == 1) pow_cols<NW, 1>(r, x, consts, frag);
    else pow_cols<NW, 2>(r, x, consts, frag);
}
extern "C" {
void t_permute(int32_t* out, const int32_t* in, long long n, int width, int quad, int words, const void* consts,
               const uint32_t* frag) {
    BY_WORDS(permute_n, out, in, n, width, quad, consts, frag);
}
void t_sponge(int32_t* out, const int32_t* in, long long n, int width, int E, int words, const void* consts,
              const uint32_t* frag) {
    BY_WORDS(sponge_n, out, in, n, width, E, consts, frag);
}
void t_pow(uint32_t* r, const uint32_t* x, int cols, int words, const void* consts, const uint32_t* frag) {
    BY_WORDS(pow_n, r, x, cols, consts, frag);
}
int t_quad(long long n, int kernel) { return permute_mma_quad(n, kernel); }
long long t_group_max(void) { return PERMUTE_MMA_GROUP_MAX; }
}
"""

INSTANCES = [("vesta", "anemoi_2_1"), ("vesta", "anemoi_4_3"), ("bls12_381", "anemoi_2_1"),
             ("bls12_381", "anemoi_4_3")]
GUARD = 16  # sentinel words past the output, which a store past the live states would reach


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory, "sponge_mma", _SHIM)
    lib.t_permute.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.t_quad.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.t_group_max.restype = ctypes.c_longlong
    lib.t_sponge.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _run(fn, inst, x: np.ndarray, out_rows: int, *args) -> np.ndarray:
    """One shim call on limb-major int32 [rows, n]; the output's rows, with
    its GUARD sentinel words checked untouched."""
    n = x.shape[1]
    buf = np.full(out_rows * n + GUARD, -1, np.int32)
    fn(_ptr(buf), _ptr(x), n, inst.width, *args, inst.field.kernel_words, _ptr(cuda_backend.consts_words(inst)),
       _ptr(mxu_ops.fragment_words(inst.field)))
    assert (buf[out_rows * n:] == -1).all(), "a state past N was stored"
    return buf[:out_rows * n].reshape(out_rows, n)


def _states(inst, n: int, seed: int) -> np.ndarray:
    """int32 [WIDTH*L, n] random canonical states, limb-major."""
    st = random_canonical(inst.field, (inst.width, n), np.random.default_rng(seed)).transpose(1, 0, 2)
    return np.ascontiguousarray(st.reshape(inst.width * inst.field.n_limbs, n))


def _ints(inst, x: np.ndarray, rows: int) -> list:
    """int32 [rows*L, n] Montgomery limbs -> n lists of `rows` ints."""
    cols = [decode_ints(torch.from_numpy(r), inst.field) for r in x.reshape(rows, inst.field.n_limbs, -1)]
    return [list(v) for v in zip(*cols)]


def _check_permute(lib, field, iname, n, quad):
    """The permutation of n states by the quad form's warps (quad) or the
    thread form's, against the golden model and the native oracle."""
    inst, ref = get_instance(field, iname), jparams.get_instance(field, iname)
    W = inst.width
    x = _states(inst, n, n + W)
    out = _run(lib.t_permute, inst, x, W * inst.field.n_limbs, int(quad))
    assert _ints(inst, out, W) == [jgolden.permutation(ref, s) for s in _ints(inst, x, W)]
    want = native.permute_batch_canonical(inst, native.canonical_host(inst, torch.from_numpy(x)))
    np.testing.assert_array_equal(native.canonical_host(inst, torch.from_numpy(out)), want)


@pytest.mark.parametrize("n", [16, 8, 5])
@pytest.mark.parametrize("field,iname", INSTANCES)
def test_host_permute_matches_golden_and_oracle(lib, field, iname, n):
    """permute_mma_warp (the quad form) over HostWarp on two warps of 8
    states, one warp and a ragged warp of 5, against the JAX package's
    golden model and the native oracle."""
    _check_permute(lib, field, iname, n, quad=True)


@pytest.mark.parametrize("n", [32, 45])
@pytest.mark.parametrize("field,iname", INSTANCES)
def test_host_permute_thread_matches_golden_and_oracle(lib, field, iname, n):
    """permute_mma_thread_warp (the thread form) over HostWarp on one warp's
    32 states and on a whole and a ragged warp (45), against the golden
    model and the native oracle."""
    _check_permute(lib, field, iname, n, quad=False)


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_quad_window_matches_golden(lib, field):
    """x^(1/alpha) under MmaArith (the window, its table in the warp's
    slots) against the JAX package's golden model, with one column and with
    two side by side as width 4 runs them: 0, 1, p - 1, beta and random
    canonical bases, in and out in R' form."""
    fp = get_field(field)
    nw, ref = fp.kernel_words, jparams.get_field(field)
    r_words = 1 << (32 * nw)
    rng = np.random.default_rng(17)
    bases = [0, 1, fp.p - 1, fp.beta] + [int.from_bytes(rng.bytes(56), "little") % fp.p for _ in range(12)]
    consts = cuda_backend.consts_words(get_instance(field, "anemoi_2_1"))
    for cols in (1, 2):
        vals = bases[:8 * cols]
        x = _words([v * r_words % fp.p for v in vals], nw)
        r = np.zeros_like(x)
        lib.t_pow(_ptr(r), _ptr(x), cols, nw, _ptr(consts), _ptr(mxu_ops.fragment_words(fp)))
        assert _word_ints(r) == [jgolden.exp_inv_alpha(ref, v) * r_words % fp.p for v in vals]


def test_launcher_picks_the_form_by_the_crossover(lib):
    """anemoi_permute_mma's choice: the quad form up to the crossover the
    library reports (PERMUTE_MMA_GROUP_MAX), the thread form above it, and
    the named form whatever N when the caller names one."""
    top = lib.t_group_max()
    assert top > 0
    for n in (1, top - 1, top, top + 1, 4 * top):
        assert lib.t_quad(n, -1) == (n <= top)
        assert lib.t_quad(n, 1) == 1 and lib.t_quad(n, 0) == 0


def test_wrapper_counts_the_form_the_launcher_picks(lib, monkeypatch):
    """``permutation`` with an "mxu" name lets the launcher pick the form
    (kernel -1) and counts one launch a call in ``launch_counts()``, under
    the form the launcher reports it picked;
    ``permutation_mma_with`` names the form and counts nothing;
    ``permute_mma_group_max`` reads the library's crossover."""
    launched = []
    top = lib.t_group_max()

    def launcher(cdll, name, x, out, width, kernel, consts, frag, picked):
        picked.contents.value = lib.t_quad(x.shape[1], kernel)  # the launcher's own rule, built from sponge_mma.cu
        launched.append((name, x.shape[1], kernel))

    cdll = type("CDLL", (), {"anemoi_permute_mma_group_max": staticmethod(lambda: top)})()
    monkeypatch.setattr(cuda_backend, "sponge_mma_library", lambda words: type("Built", (), {"cdll": cdll})())
    monkeypatch.setattr(cuda_backend, "fragments", lambda field, device: torch.zeros(1, dtype=torch.int32))
    monkeypatch.setattr(cuda_backend, "_launch", launcher)
    # the fake launches count in a table of their own, not in the process's
    monkeypatch.setattr(cuda_backend, "_launches", dict.fromkeys(cuda_backend._launches, 0))
    before = cuda_backend.launch_counts()
    inst = get_instance("vesta", "anemoi_4_3")
    fake = lambda n: torch.zeros(80, n, dtype=torch.int32).as_subclass(_FakeCudaTensor)
    assert cuda_backend.permute_mma_group_max(8) == top
    for n in (1, top, top + 1, 0):
        cuda_backend.permutation(inst, fake(n), "mxuf")
    for quad in (True, False):
        cuda_backend.permutation_mma_with(inst, fake(5), quad)
    assert launched == [("anemoi_permute_mma", 1, -1), ("anemoi_permute_mma", top, -1),
                        ("anemoi_permute_mma", top + 1, -1), ("anemoi_permute_mma", 5, 1),
                        ("anemoi_permute_mma", 5, 0)]
    after = cuda_backend.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {**dict.fromkeys(after, 0), "permutation_mma": 2,
                                                        "permutation_mma_thread": 1}


def _sponge_cases():
    for field, iname in INSTANCES:
        rate = get_instance(field, iname).rate
        for E in sorted({rate, rate + 1, 2 * rate, 7}):
            yield field, iname, E


@pytest.mark.parametrize("field,iname,E", list(_sponge_cases()))
def test_host_sponge_matches_golden(lib, field, iname, E):
    """sponge_mma_warp over HostWarp on two warps of messages (a whole and a
    ragged warp, 11, at E = 7): E = rate and 2 rate end on a whole block
    (sigma is not added), rate + 1 and 7 on a tail, against the golden
    model."""
    inst, ref = get_instance(field, iname), jparams.get_instance(field, iname)
    n = 11 if E == 7 else 16
    x = np.ascontiguousarray(
        random_canonical(inst.field, (E, n), np.random.default_rng(E)).transpose(1, 0, 2).reshape(-1, n))
    out = _run(lib.t_sponge, inst, x, inst.field.n_limbs, E)
    assert _ints(inst, out, 1) == [jgolden.hash_field(ref, m) for m in _ints(inst, x, E)]


interpret = pytest.mark.skipif(not os.environ.get("ANEMOI_PALLAS_INTERPRET"),
                               reason="pallas interpret mode on CPU is slow; set ANEMOI_PALLAS_INTERPRET=1")


@interpret
@pytest.mark.parametrize("field,iname", [("vesta", "anemoi_4_3"), ("bls12_381", "anemoi_2_1")])
def test_host_warps_match_pallas_mxuf(lib, field, iname):
    """The same inputs through the JAX package's permutation_pallas and
    sponge_pallas with its shipped product (mul_impl="mxuf"), interpreted."""
    from anemoi_tpu.ff import pallas_backend as pb

    inst, ref = get_instance(field, iname), jparams.get_instance(field, iname)
    W, L = inst.width, inst.field.n_limbs
    x = _states(inst, 16, 16 + W)
    got = pb.permutation_pallas(ref, block_b=128, interpret=True, mul_impl="mxuf")(x)
    np.testing.assert_array_equal(np.asarray(got), _run(lib.t_permute, inst, x, W * L, 1))
    E = inst.rate + 1
    m = np.ascontiguousarray(random_canonical(inst.field, (E, 16), np.random.default_rng(E)).transpose(1, 0, 2)
                             .reshape(-1, 16))
    got = pb.sponge_pallas(ref, E, block_b=16, interpret=True, mul_impl="mxuf")(m)
    np.testing.assert_array_equal(np.asarray(got), _run(lib.t_sponge, inst, m, L, E))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(46)
    for field, iname in INSTANCES:
        inst = get_instance(field, iname)
        W, L = inst.width, inst.field.n_limbs
        x = torch.from_numpy(random_canonical(inst.field, (W, 131), rng).transpose(1, 0, 2).copy())
        x = x.reshape(W * L, 131).cuda()
        before = cuda_backend.launch_counts()
        out = cuda_backend.permutation(inst, x, "mxuf").cpu().numpy()
        after = cuda_backend.launch_counts()
        assert sum(after[k] - before[k] for k in ("permutation_mma", "permutation_mma_thread")) == 1
        np.testing.assert_array_equal(out, cuda_backend.permutation(inst, x).cpu().numpy())
        np.testing.assert_array_equal(out, cuda_backend.permutation_plain(inst, x).cpu().numpy())
        for quad in (True, False):
            np.testing.assert_array_equal(out, cuda_backend.permutation_mma_with(inst, x, quad).cpu().numpy())
        E = inst.rate + 1
        m = torch.from_numpy(random_canonical(inst.field, (E, 131), rng).transpose(1, 0, 2).copy())
        m = m.reshape(E * L, 131).cuda()
        before = cuda_backend.launch_counts()["sponge_mma"]
        out = cuda_backend.sponge(inst, E, m, "mxuf").cpu().numpy()
        assert cuda_backend.launch_counts()["sponge_mma"] == before + 1
        np.testing.assert_array_equal(out, cuda_backend.sponge(inst, E, m).cpu().numpy())
        np.testing.assert_array_equal(out, cuda_backend.sponge_plain(inst, E, m).cpu().numpy())
