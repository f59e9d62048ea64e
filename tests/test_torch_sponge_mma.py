"""The tensor-core permutation and sponge of csrc/sponge_mma.cu, built for
the host with g++.

On the card a warp runs 16 states or messages, two on each quad of four
lanes, and every product's reduction runs as mma.sync on the tensor cores;
here field32_mma.cuh's HostWarp policy holds the whole warp in one object
and computes each mma from its definition, so the test runs the statements
the kernels run (permute_mma_warp and sponge_mma_warp).  Checked, for
anemoi_2_1 and anemoi_4_3 at 8 words (Vesta) and 12 (BLS12-381): the
permutation of one warp's 16 states and of a ragged warp of 5, against the
JAX package's pure-Python golden model (``anemoi_tpu.ff.golden``) and the
native oracle, with nothing stored past the live states; the sponge over
one warp of messages at E = rate, rate + 1, 2 rate and 7 (a ragged warp of
11 at E = 7), against the golden model's ``hash_field``.  Behind the JAX
tests' own opt-in (ANEMOI_PALLAS_INTERPRET=1), the same inputs through the
JAX package's ``permutation_pallas`` and ``sponge_pallas`` with
``mul_impl="mxuf"`` in interpret mode.  On the card (skipped here): both
kernels against their plain versions and the integer kernels.  Tolerance:
exact.
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
from anemoi_tpu_torch.fields.params import get_instance

from .test_torch_field32 import _ptr
from .test_torch_field32_mma import build_shim

_SHIM = r"""
#include <stddef.h>
#include "sponge_mma.cu"
#define BY_WORDS(f, ...) (words == 8 ? f<8>(__VA_ARGS__) : f<12>(__VA_ARGS__))
// the kernels' warps one after the other, HostWarp holding each whole
template <int NW> void permute_n(int32_t* out, const int32_t* in, long long n, int width, const void* consts,
                                 const uint32_t* frag) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    for (long long base = 0; base < n; base += MMA_STATES) {
        if (width == 2) permute_mma_warp<2, NW, HostWarp>(out, in, n, base, c, frag);
        else permute_mma_warp<4, NW, HostWarp>(out, in, n, base, c, frag);
    }
}
template <int NW> void sponge_n(int32_t* out, const int32_t* in, long long n, int width, int E, const void* consts,
                                const uint32_t* frag) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    for (long long base = 0; base < n; base += MMA_STATES) {
        if (width == 2) sponge_mma_warp<2, NW, HostWarp>(out, in, n, E, base, c, frag);
        else sponge_mma_warp<4, NW, HostWarp>(out, in, n, E, base, c, frag);
    }
}
extern "C" {
void t_permute(int32_t* out, const int32_t* in, long long n, int width, int words, const void* consts,
               const uint32_t* frag) {
    BY_WORDS(permute_n, out, in, n, width, consts, frag);
}
void t_sponge(int32_t* out, const int32_t* in, long long n, int width, int E, int words, const void* consts,
              const uint32_t* frag) {
    BY_WORDS(sponge_n, out, in, n, width, E, consts, frag);
}
}
"""

INSTANCES = [("vesta", "anemoi_2_1"), ("vesta", "anemoi_4_3"), ("bls12_381", "anemoi_2_1"),
             ("bls12_381", "anemoi_4_3")]
GUARD = 16  # sentinel words past the output, which a store past the live states would reach


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build_shim(tmp_path_factory, "sponge_mma", _SHIM)
    lib.t_permute.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]
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


@pytest.mark.parametrize("n", [16, 5])
@pytest.mark.parametrize("field,iname", INSTANCES)
def test_host_permute_matches_golden_and_oracle(lib, field, iname, n):
    """permute_mma_warp over HostWarp on one warp's 16 states and a ragged
    warp of 5, against the JAX package's golden model and the native oracle."""
    inst, ref = get_instance(field, iname), jparams.get_instance(field, iname)
    W = inst.width
    x = _states(inst, n, n + W)
    out = _run(lib.t_permute, inst, x, W * inst.field.n_limbs)
    assert _ints(inst, out, W) == [jgolden.permutation(ref, s) for s in _ints(inst, x, W)]
    want = native.permute_batch_canonical(inst, native.canonical_host(inst, torch.from_numpy(x)))
    np.testing.assert_array_equal(native.canonical_host(inst, torch.from_numpy(out)), want)


def _sponge_cases():
    for field, iname in INSTANCES:
        rate = get_instance(field, iname).rate
        for E in sorted({rate, rate + 1, 2 * rate, 7}):
            yield field, iname, E


@pytest.mark.parametrize("field,iname,E", list(_sponge_cases()))
def test_host_sponge_matches_golden(lib, field, iname, E):
    """sponge_mma_warp over HostWarp on one warp of messages (a ragged warp
    of 11 at E = 7): E = rate and 2 rate end on a whole block (sigma is not
    added), rate + 1 and 7 on a tail, against the golden model."""
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
    np.testing.assert_array_equal(np.asarray(got), _run(lib.t_permute, inst, x, W * L))
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
        before = cuda_backend.permutation_mma.launches
        out = cuda_backend.permutation(inst, x, "mxuf").cpu().numpy()
        assert cuda_backend.permutation_mma.launches == before + 1
        np.testing.assert_array_equal(out, cuda_backend.permutation(inst, x).cpu().numpy())
        np.testing.assert_array_equal(out, cuda_backend.permutation_plain(inst, x).cpu().numpy())
        E = inst.rate + 1
        m = torch.from_numpy(random_canonical(inst.field, (E, 131), rng).transpose(1, 0, 2).copy())
        m = m.reshape(E * L, 131).cuda()
        before = cuda_backend.sponge_mma.launches
        out = cuda_backend.sponge(inst, E, m, "mxuf").cpu().numpy()
        assert cuda_backend.sponge_mma.launches == before + 1
        np.testing.assert_array_equal(out, cuda_backend.sponge(inst, E, m).cpu().numpy())
        np.testing.assert_array_equal(out, cuda_backend.sponge_plain(inst, E, m).cpu().numpy())
