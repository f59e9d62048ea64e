"""The microbenchmarks' kernels and plain versions (anemoi_tpu_torch/
microbench.py, csrc/microbench.cu) against Python ints, on the CPU.

The squaring chain's per-lane code is built for the host with g++, as the
hash kernels' is (tests/test_torch_field32.py), and held beside its plain
version: an 8-deep chain, as tools/mxu_prototype.py:check_correct runs it,
for Vesta (8 words) and BLS12-381 (12 words).  The multiply-add loop
(tools/microbench_layout.py:time_body's body) is held against Python ints
with int32 wrap-around.  Tolerance: exact.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from anemoi_tpu_torch import microbench as mb
from anemoi_tpu_torch._build import CSRC
from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.ff import limb_ops as lo
from anemoi_tpu_torch.fields.params import get_field, get_instance

_SHIM = r"""
#include "microbench.cu"
template <int NW> void chain_n(int32_t* out, const int32_t* in, int n, int n_iter, const uint32_t* consts) {
    const AnemoiConsts<NW>& c = *(const AnemoiConsts<NW>*)consts;
    for (int i = 0; i < n; ++i) sqr_chain_lane<NW>(out + i, in + i, (size_t)n, n_iter, c);
}
extern "C" {
void t_sqr_chain(int32_t* out, const int32_t* in, int n, int n_iter, int words, const uint32_t* consts) {
    if (words == 8) chain_n<8>(out, in, n, n_iter, consts);
    else chain_n<12>(out, in, n, n_iter, consts);
}
void t_mad_loop(int32_t* out, const int32_t* in, int n, int n_iter) {
    for (int i = 0; i < n; ++i) out[i] = mad_lane(in[i], n_iter);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("microbench")
    (d / "shim.cpp").write_text(_SHIM)
    so = d / "libmicrobench.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(d / "shim.cpp")],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(str(so))
    lib.t_sqr_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]
    lib.t_mad_loop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return lib


def _chain_inputs(fp, n, seed=3):
    rng = np.random.default_rng(seed)
    vals = [int(rng.integers(0, 2**62)) * int(rng.integers(1, 2**62)) % fp.p for _ in range(n)]
    return vals[:-2] + [0, fp.p - 1]


def _mad_ints(vals, n_iter):
    out = []
    for acc in vals:
        for i in range(n_iter):
            acc = ((acc * acc + i) % 2**32) & 0x1FFF
        out.append(acc)
    return out


@pytest.mark.parametrize("words, pasta, want", [(8, False, (208, 264, 136)), (12, False, (456, 588, 300)),
                                               (8, True, (120, 176, 48))])
def test_imad_counts(words, pasta, want):
    """The bound's IMAD counts per squaring, product and reduction
    (chip_smoke.py), for any modulus and for the Pasta moduli's shape,
    whose reduction keeps three of its eight wide products a word step."""
    assert (mb.imads_per_squaring(words, pasta), mb.imads_per_product(words, pasta),
            mb.imads_per_reduction(words, pasta)) == want


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_sqr_chain_plain_and_host(lib, field):
    """An 8-deep chain: x^(2^8) in Montgomery form, from the plain version
    and from the kernel's per-lane code built for the host."""
    fp = get_field(field)
    vals = _chain_inputs(fp, 16)
    want = [pow(v, 1 << 8, fp.p) for v in vals]
    x = lo.encode_ints(vals, fp)
    plain = mb.sqr_chain(fp, x, 8)
    assert lo.decode_ints(plain, fp) == want
    out = np.zeros_like(x.numpy())
    consts = cuda_backend.consts_words(get_instance(field, "anemoi_2_1"))
    lib.t_sqr_chain(out.ctypes.data, np.ascontiguousarray(x.numpy()).ctypes.data, len(vals), 8, fp.kernel_words,
                    consts.ctypes.data)
    np.testing.assert_array_equal(out, plain.numpy())
    # no squaring: the conversions alone give the input back
    lib.t_sqr_chain(out.ctypes.data, np.ascontiguousarray(x.numpy()).ctypes.data, len(vals), 0, fp.kernel_words,
                    consts.ctypes.data)
    np.testing.assert_array_equal(out, x.numpy())


def test_mad_loop_plain_and_host(lib):
    """The multiply-add loop at one of the JAX tool's shapes, and with
    values whose square wraps int32."""
    x = np.random.default_rng(0).integers(1, 1000, size=(4, 128), dtype=np.int32)
    want = np.array(_mad_ints(x.reshape(-1).tolist(), 50), np.int32).reshape(4, 128)
    np.testing.assert_array_equal(mb.mad_loop(torch.from_numpy(x), 50).numpy(), want)
    out = np.zeros_like(x)
    lib.t_mad_loop(out.ctypes.data, x.ctypes.data, x.size, 50)
    np.testing.assert_array_equal(out, want)
    big = np.array([2**31 - 1, -(2**31), 123456789, -7], np.int32)
    want = [v if v < 2**31 else v - 2**32 for v in _mad_ints([int(v) % 2**32 for v in big], 3)]
    np.testing.assert_array_equal(mb.mad_loop(torch.from_numpy(big), 3).numpy(), want)
    lib.t_mad_loop(out.ctypes.data, big.ctypes.data, 4, 3)
    np.testing.assert_array_equal(out.reshape(-1)[:4], want)


def test_wrappers_check_their_inputs():
    fp = get_field("vesta")
    with pytest.raises(ValueError):
        mb.sqr_chain(fp, torch.zeros(30, 2, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        mb.sqr_chain(fp, torch.zeros(20, 2, dtype=torch.int64), 1)
    with pytest.raises(ValueError):
        mb.mad_loop(torch.zeros(3, dtype=torch.int32), -1)
    assert mb.mad_loop(torch.arange(3, dtype=torch.int32), 0).tolist() == [0, 1, 2]


class _FakeCudaTensor(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensors_go_to_the_kernels(monkeypatch):
    """A CUDA tensor reaches the kernel library, never the plain version."""
    monkeypatch.setattr(mb, "sqr_chain_plain", lambda *a: pytest.fail("plain path taken"))
    monkeypatch.setattr(mb, "mad_loop_plain", lambda *a: pytest.fail("plain path taken"))

    def no_library():
        raise RuntimeError("no kernel library here")

    monkeypatch.setattr(mb, "library", no_library)
    with pytest.raises(RuntimeError, match="no kernel library"):
        mb.sqr_chain(get_field("bls12_381"), torch.zeros(30, 2, dtype=torch.int32).as_subclass(_FakeCudaTensor), 8)
    with pytest.raises(RuntimeError, match="no kernel library"):
        mb.mad_loop(torch.zeros(8, dtype=torch.int32).as_subclass(_FakeCudaTensor), 8)


@pytest.mark.cuda
def test_microbench_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    for field in ("vesta", "bls12_381"):
        mb.check_chain(field, 257, dev)
    x = torch.from_numpy(np.random.default_rng(1).integers(1, 1000, size=(20, 512), dtype=np.int32))
    np.testing.assert_array_equal(mb.mad_loop(x.to(dev), 100).cpu().numpy(), mb.mad_loop_plain(x, 100).numpy())
