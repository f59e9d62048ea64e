"""The port's smaller remainders against the JAX package, on the CPU.

Tolerance: exact.  ``FieldParams.n0_inv``, ``inv_alpha_windows`` and
``inv_alpha_sliding_schedule`` of all seven fields; ``double_mod``,
``mul_const`` and ``exp_alpha`` against the JAX package's limb operations
(run eagerly, no jit); the 3- to 6-column MDS layers of
``tests/test_mds_wide.py``'s synthetic instances against the JAX
``_mds_layer`` and the golden model; the generic matrix fallback of a
7-column instance against the golden model, and its error without a
matrix.
"""

import dataclasses

import numpy as np
import pytest
import torch

from anemoi_tpu.ff import golden as jgolden
from anemoi_tpu.ff import limb_ops as jlo
from anemoi_tpu.fields import params as jparams
from anemoi_tpu.modes.batched import encode_states as j_encode_states
from anemoi_tpu.permutation.batched import _mds_layer as j_mds_layer
from anemoi_tpu_torch.ff import golden
from anemoi_tpu_torch.ff import limb_ops as lo
from anemoi_tpu_torch.fields import params
from anemoi_tpu_torch.modes.batched import decode_states, encode_states
from anemoi_tpu_torch.permutation.batched import _mds_layer


@pytest.mark.parametrize("field", params.FIELD_NAMES)
def test_params_remainders_match_jax(field):
    mine, ref = params.get_field(field), jparams.get_field(field)
    assert mine.n0_inv == ref.n0_inv
    assert mine.n0_inv * mine.p % (1 << params.LIMB_BITS) == (1 << params.LIMB_BITS) - 1
    assert mine.inv_alpha_windows == ref.inv_alpha_windows
    assert mine.inv_alpha_sliding_schedule == ref.inv_alpha_sliding_schedule
    # the schedule evaluates to x^inv_alpha
    x, acc = 7, None
    for squarings, v in mine.inv_alpha_sliding_schedule:
        acc = pow(x, v, mine.p) if acc is None else pow(acc, 1 << squarings, mine.p) * pow(x, v, mine.p) % mine.p
    assert acc == pow(x, mine.inv_alpha, mine.p)


def _values(fp, n, seed):
    rng = np.random.default_rng(seed)
    return [int(rng.integers(0, 2**62)) * int(rng.integers(0, 2**62)) % fp.p for _ in range(n)]


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_limb_remainders_match_jax(field):
    fp, jfp = params.get_field(field), jparams.get_field(field)
    fc, jfc = lo.field_consts(fp), jlo.field_consts(jfp)
    a = _values(fp, 8, 5) + [0, fp.p - 1]
    A, JA = lo.encode_ints(a, fp), jlo.encode_ints(a, jfp)
    got = lo.double_mod(A, fc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlo.double_mod(JA, jfc)))
    assert lo.decode_ints(got, fp) == [2 * x % fp.p for x in a]
    c = 0xC0FFEE123456789
    const = params.limbs_from_int(fp.to_mont(c), fp.n_limbs)
    got = lo.mul_const(A, const, fc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlo.mul_const(JA, const, jfc)))
    assert lo.decode_ints(got, fp) == [x * c % fp.p for x in a]
    for alpha in sorted({fp.alpha, 11}):
        got = lo.exp_alpha(A, fc, alpha)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jlo.exp_alpha(JA, jfc, alpha)), err_msg=str(alpha))
        assert lo.decode_ints(got, fp) == [pow(x, alpha, fp.p) for x in a]


def _wide(module, cols, mds=None):
    base = module.get_instance("vesta", "anemoi_2_1")
    return dataclasses.replace(base, name=f"synthetic_{2 * cols}_{2 * cols - 1}", width=2 * cols,
                               rate=2 * cols - 1, columns=cols, mds=mds)


def _states(fp, width, n, seed):
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(0, 1 << 62)) % fp.p for _ in range(width)] for _ in range(n)]


@pytest.mark.parametrize("cols", [1, 2, 3, 4, 5, 6])
def test_wide_mds_matches_jax(cols):
    """tests/test_mds_wide.py's synthetic instances (and the shipped 1 and
    2 columns), 4 random states each."""
    inst, jinst = _wide(params, cols), _wide(jparams, cols)
    fc = lo.field_consts(inst.field)
    states = _states(inst.field, inst.width, 4, 1234 + cols)
    arr = encode_states(inst, states, device="cpu")
    got = torch.stack(_mds_layer(list(arr.unbind(0)), cols, fc))
    jarr = j_encode_states(jinst, states)
    want = np.stack(j_mds_layer([jarr[i] for i in range(jinst.width)], cols, jlo.field_consts(jinst.field)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert decode_states(inst, got) == [jgolden.mds_layer(jinst, s) for s in states]


def test_generic_mds_matrix_matches_golden():
    """Seven columns with an explicit matrix take the generic fallback in
    the port, as in both golden models; without a matrix the port raises
    NotImplementedError, as the JAX ``_mds_layer`` does."""
    cols = 7
    rng = np.random.default_rng(7)
    mds = tuple(int(v) for v in rng.integers(0, 1 << 40, size=cols * cols))
    inst, jinst = _wide(params, cols, mds), _wide(jparams, cols, mds)
    fc = lo.field_consts(inst.field)
    states = _states(inst.field, inst.width, 3, 70)
    arr = encode_states(inst, states, device="cpu")
    got = decode_states(inst, torch.stack(_mds_layer(list(arr.unbind(0)), cols, fc, inst.mds)))
    assert got == [jgolden.mds_layer(jinst, s) for s in states] == [golden.mds_layer(inst, s) for s in states]
    with pytest.raises(NotImplementedError):
        _mds_layer(list(arr.unbind(0)), cols, fc)
    jarr = j_encode_states(jinst, states)
    with pytest.raises(NotImplementedError):
        j_mds_layer([jarr[i] for i in range(jinst.width)], cols, jlo.field_consts(jinst.field))
