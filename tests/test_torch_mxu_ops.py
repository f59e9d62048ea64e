"""The port's tensor-core Montgomery product (``anemoi_tpu_torch/ff/mxu_ops.py``)
against the JAX package's ``anemoi_tpu.ff.mxu_ops`` (run eagerly on the CPU,
as ``tests/test_mxu_ops.py`` runs it), against the golden model's arithmetic
(Python ints) for all seven fields, and its constants: p p' = -1 mod R', the
byte Toeplitz products against integer products, the fragment order and the
fragment packing.  Tolerance: exact, limb for limb.
"""

import numpy as np
import pytest
import torch

from anemoi_tpu.ff import limb_ops as jlo
from anemoi_tpu.ff import mxu_ops as jmx
from anemoi_tpu_torch.ff import mxu_ops as mx
from anemoi_tpu_torch.ff.limb_ops import decode_ints, encode_ints
from anemoi_tpu_torch.fields.params import FIELD_NAMES, get_field

N_LANES = 256


def _canonical(fp, seed: int) -> list[int]:
    """N_LANES random canonical values, 0, 1 and p - 1 first."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(48), "little") % fp.p for _ in range(N_LANES)]
    vals[:3] = [0, 1, fp.p - 1]
    return vals


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
@pytest.mark.parametrize("impl", ["mxu", "mxuf"])
def test_matches_jax_mxu_ops(field, impl):
    """Canonical outputs identical to the JAX module's, limb for limb, for
    the product and the squaring at both limb widths."""
    fp = get_field(field)
    fc = jlo.field_consts(fp, mul_impl=impl)
    a, b = _canonical(fp, 1), _canonical(fp, 2)[::-1]
    A, B = encode_ints(a, fp), encode_ints(b, fp)
    JA, JB = jlo.encode_ints(a, fp), jlo.encode_ints(b, fp)
    np.testing.assert_array_equal(np.asarray(jmx.mont_mul_mxu(JA, JB, fc.mxu, fc, lazy=False)),
                                  mx.mont_mul_mxu(A, B, fp).numpy())
    want = np.asarray(jlo.canonicalize(jmx.mont_sqr_mxu(JA, fc.mxu, fc), fc))
    np.testing.assert_array_equal(want, mx.mont_sqr_mxu(A, fp).numpy())
    assert mx.selects_mma(impl)


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_matches_golden_arithmetic(field):
    """a b and a^2 in Montgomery form against Python ints, canonical limbs."""
    fp = get_field(field)
    a, b = _canonical(fp, 3), _canonical(fp, 4)
    A, B = encode_ints(a, fp), encode_ints(b, fp)
    out = mx.mont_mul_mxu(A, B, fp)
    assert out.dtype == torch.int32 and out.min() >= 0 and out.max() < 1 << 13
    assert decode_ints(out, fp) == [x * y % fp.p for x, y in zip(a, b)]
    assert decode_ints(mx.mont_sqr_mxu(A, fp), fp) == [x * x % fp.p for x in a]


def _value(byte_rows: np.ndarray) -> list[int]:
    return [sum(int(v) << (8 * i) for i, v in enumerate(col)) for col in byte_rows.T]


@pytest.mark.parametrize("field", FIELD_NAMES)
def test_consts(field):
    """p p' = -1 mod R'; each Toeplitz product equals the integer product on
    random bytes (m's truncated mod R'); the fragment order undoes to the
    plain matrices; the packed fragments are the fragment order's."""
    fp = get_field(field)
    mc = mx.mxu_consts(field)
    nw = mc.words
    kb, r = 4 * nw, 1 << (32 * nw)
    assert nw == fp.kernel_words and fp.p * mc.pprime % r == r - 1
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (kb, 64))
    assert [v % r for v in _value(mc.w_pprime.astype(np.int64) @ x)] == [v * mc.pprime % r for v in _value(x)]
    assert _value(mc.w_p.astype(np.int64) @ x) == [v * fp.p for v in _value(x)]
    pin = mx.input_order(nw)
    assert sorted(pin) == list(range(kb)) and sorted(mx.m_order(nw)) == list(range(kb))
    assert sorted(mx.u_order(nw)) == list(range(2 * kb))
    np.testing.assert_array_equal(mx.from_fragment_order(mc.w_pprime_frag, mx.m_order(nw), pin), mc.w_pprime)
    np.testing.assert_array_equal(mx.from_fragment_order(mc.w_p_frag, mx.u_order(nw), pin), mc.w_p)
    # the packed B fragments hold the fragment order's tiles: K slot kappa, column 8 tile + g
    words = mx.fragment_words(field)
    m_tiles, u_tiles = mx.fragment_tiles(nw)
    regs = mx.fragment_regs(nw)
    assert words.shape == ((m_tiles + u_tiles) * regs * 32,)
    frag = words.reshape(m_tiles + u_tiles, regs, 32)
    for tile, (w_frag, j) in enumerate([(mc.w_pprime_frag, j) for j in range(m_tiles)]
                                       + [(mc.w_p_frag, j) for j in range(u_tiles)]):
        for lane in (0, 5, 31):
            g, t = divmod(lane, 4)
            for reg in range(regs):
                got = [(int(frag[tile, reg, lane]) >> (8 * i)) & 0xFF for i in range(4)]
                assert got == [int(w_frag[8 * j + g, 16 * reg + 4 * t + i]) for i in range(4)]


def test_fragment_packing_round_trip():
    """pack_a / pack_b place every element of A and B once; unpack_d reads
    back what a register layout of D holds."""
    rng = np.random.default_rng(6)
    for k in (32, 16):
        a, b = rng.integers(0, 256, (16, k)), rng.integers(0, 256, (k, 8))
        pa, pb = mx.pack_a(a), mx.pack_b(b)
        assert pa.shape == (32, k // 8) and pb.shape == (32, k // 16)
        assert sorted(((int(w) >> (8 * i)) & 0xFF for w in pa.reshape(-1) for i in range(4))) == sorted(a.reshape(-1))
        assert sorted(((int(w) >> (8 * i)) & 0xFF for w in pb.reshape(-1) for i in range(4))) == sorted(b.reshape(-1))
    d = np.arange(128, dtype=np.int32).reshape(32, 4)
    assert sorted(mx.unpack_d(d).reshape(-1)) == list(range(128))


def test_selects_mma():
    assert all(mx.selects_mma(n) for n in ("mxu", "mxu2", "mxu3", "mxus", "mxuf"))
    assert not any(mx.selects_mma(n) for n in (None, "cios", "cios2", "parallel"))
