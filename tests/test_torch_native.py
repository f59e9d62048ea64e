"""The port's native oracle against the JAX package's, on the CPU.

Tolerance: exact.  ``permute_batch_canonical`` and ``jive_batch_canonical``
of all 14 instances on ``random_canonical`` states (a few lanes each)
against ``anemoi_tpu.ff.native``'s functions of the same names and the
golden model; the whole-array repacking between 13-bit limbs and 64-bit
words against the JAX package's row-by-row repacker at the values 0,
p - 1 and 2^bits - 1, and back.  What the port's checks build on the
oracle (``threaded``, ``canonical_host`` / ``montgomery``,
``host_sponge``, ``tree_levels``) against the golden model.
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


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_canonical_host_and_montgomery_invert(field):
    """``canonical_host`` against the golden ints of Montgomery limbs, at
    both layouts it takes; ``montgomery`` back to the same limbs."""
    from anemoi_tpu_torch.ff.limb_ops import decode_ints
    from anemoi_tpu_torch.modes.batched import encode_states

    inst = params.get_instance(field, "anemoi_4_3")
    rng = np.random.default_rng(3)
    states = [[int(rng.integers(0, 2**62)) * int(rng.integers(1, 2**62)) % inst.field.p for _ in range(4)]
              for _ in range(LANES)]
    states[0] = [0, 1, inst.field.p - 1, 2]
    x = encode_states(inst, states, device="cpu")  # [4, L, n] Montgomery
    canon = native.canonical_host(inst, x)
    assert canon.shape == (LANES, 4, inst.field.n_limbs) and _ints(canon) == states
    np.testing.assert_array_equal(native.canonical_host(inst, x.reshape(4 * inst.field.n_limbs, LANES)), canon)
    back = native.montgomery(inst, canon)
    assert back.dtype == x.dtype and back.shape == x.shape and bool((back == x).all())
    assert decode_ints(back[1], inst.field) == [s[1] for s in states]


@pytest.mark.parametrize("field,iname,E", [("vesta", "anemoi_4_3", 7), ("vesta", "anemoi_2_1", 2),
                                           ("bls12_377", "anemoi_4_3", 3), ("jubjub", "anemoi_2_1", 0)])
def test_host_sponge_matches_golden(field, iname, E):
    """The host sponge (the oracle's permutation, Python-int rate adds and
    sigma) against ``golden.hash_field``: a tail, whole rate blocks, and
    the empty message."""
    inst = params.get_instance(field, iname)
    messages = np.ascontiguousarray(random_canonical(inst.field, (E, 3), np.random.default_rng(E)).transpose(2, 1, 0))
    got = native.host_sponge(inst, messages)
    assert got.shape == (3, inst.digest_size, inst.field.n_limbs)
    assert _ints(got) == [golden.hash_field(inst, m) for m in _ints(messages)]


@pytest.mark.parametrize("iname,n", [("anemoi_2_1", 16), ("anemoi_4_3", 64)])
def test_tree_levels_and_threaded_match_golden(iname, n):
    """``tree_levels`` level by level against the golden model's Jive, and
    ``threaded`` against one oracle call."""
    inst = params.get_instance("vesta", iname)
    k = inst.width // inst.digest_size
    leaves = np.ascontiguousarray(random_canonical(inst.field, (n,), np.random.default_rng(n)).T)
    levels = native.tree_levels(inst, leaves)
    want = [int_from_limbs(v) for v in leaves]
    assert len(levels) == {2: 4, 4: 3}[inst.width]
    for level in levels:
        want = [golden.jive_compress_k(inst, want[i:i + inst.width], k)[0] for i in range(0, len(want), inst.width)]
        assert [int_from_limbs(v) for v in level] == want
    states = leaves.reshape(-1, inst.width, inst.field.n_limbs)
    np.testing.assert_array_equal(native.threaded(native.jive_batch_canonical, inst, states, k),
                                  native.jive_batch_canonical(inst, states, k))
