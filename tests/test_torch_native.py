"""The port's native oracle against the JAX package's, on the CPU.

Tolerance: exact.  ``permute_batch_canonical`` and ``jive_batch_canonical``
of all 14 instances on ``random_canonical`` states (a few lanes each)
against ``anemoi_tpu.ff.native``'s functions of the same names and the
golden model; the whole-array repacking between 13-bit limbs and 64-bit
words against the JAX package's row-by-row repacker at the values 0,
p - 1 and 2^bits - 1, and back.
"""

import numpy as np
import pytest

from anemoi_tpu.ff import native as jnative
from anemoi_tpu.fields import params as jparams
from anemoi_tpu_torch.ff import golden, native
from anemoi_tpu_torch.ff.limb_ops import random_canonical
from anemoi_tpu_torch.fields import params
from anemoi_tpu_torch.fields.params import int_from_limbs, limbs_from_int

ALL = [(i.field.name, i.name) for i in params.all_instances()]
LANES = 5


def _ints(arr) -> list:
    return [[int_from_limbs(row) for row in state] for state in arr]


@pytest.mark.parametrize("field,iname", ALL)
def test_oracle_matches_jax_and_golden(field, iname):
    inst, jinst = params.get_instance(field, iname), jparams.get_instance(field, iname)
    rng = np.random.default_rng(len(field) * 7 + inst.width)
    states = np.ascontiguousarray(random_canonical(inst.field, (inst.width, LANES), rng).transpose(2, 1, 0))
    states[0] = 0  # the zero state among them
    got = native.permute_batch_canonical(inst, states)
    assert got.dtype == np.int32 and got.shape == states.shape
    np.testing.assert_array_equal(got, jnative.permute_batch_canonical(jinst, states))
    assert _ints(got) == [golden.permutation(inst, s) for s in _ints(states)]
    for k in (2, 4) if inst.width == 4 else (2,):
        got = native.jive_batch_canonical(inst, states, k)
        assert got.shape == (LANES, inst.width // k, inst.field.n_limbs)
        np.testing.assert_array_equal(got, jnative.jive_batch_canonical(jinst, states, k), err_msg=f"k={k}")
        assert _ints(got) == [golden.jive_compress_k(inst, s, k) for s in _ints(states)]


@pytest.mark.parametrize("field", params.FIELD_NAMES)
def test_repacking_matches_jax(field):
    fp, jfp = params.get_field(field), jparams.get_field(field)
    values = [0, fp.p - 1, (1 << fp.bits) - 1]
    limbs = np.stack([limbs_from_int(v, fp.n_limbs) for v in values])[None]  # [1, 3, L]
    words = native.limbs_to_words(limbs, fp)
    assert words.dtype == np.uint64 and words.shape == (1, 3, native.words64(fp))
    np.testing.assert_array_equal(words, jnative._to64(limbs, jfp))
    assert [sum(int(w) << (64 * i) for i, w in enumerate(row)) for row in words[0]] == values
    back = native.words_to_limbs(words, fp)
    np.testing.assert_array_equal(back, jnative._to13(words, jfp))
    np.testing.assert_array_equal(back, limbs)


def test_oracle_rejects_bad_input():
    inst = params.get_instance("vesta", "anemoi_2_1")
    with pytest.raises(ValueError):
        native.permute_batch_canonical(inst, np.zeros((2, 3, 20), dtype=np.int32))  # width 3
    with pytest.raises(ValueError):
        native.limbs_to_words(np.full((1, 20), 1 << 13, dtype=np.int32), inst.field)  # a limb of 14 bits
    with pytest.raises(ValueError):
        native.jive_batch_canonical(inst, np.zeros((1, 2, 20), dtype=np.int32), 4)
