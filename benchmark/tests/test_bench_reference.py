"""The plain reference against the SAGE test vectors, read as data."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.reference import anemoi as ref
from benchmark.reference import work

VECTORS = Path(__file__).resolve().parents[2] / "tests" / "vectors"
CASES = [(f, n) for f in ("vesta", "bls12_377") for n in ("anemoi_2_1", "anemoi_4_3")]


def _to_int(obj):
    if isinstance(obj, list):
        return [_to_int(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_int(v) for k, v in obj.items()}
    return int(obj)


def _vectors(field, name):
    return _to_int(json.loads((VECTORS / f"{field}_{name}.json").read_text()))


@pytest.mark.parametrize("field,name", CASES)
@pytest.mark.parametrize("mode", ["sbox", "jive", "hash_field", "hash_bytes"])
def test_reference_matches_sage_vectors(field, name, mode):
    inst = ref.instance(field, name)
    vec = _vectors(field, name)
    if mode == "jive":
        for pair, k in zip(vec["jive"], (2, 4)):
            for elems, want in zip(pair["input"], pair["output"]):
                assert ref.jive(inst, elems, k) == want
        return
    for elems, want in zip(vec[mode]["input"], vec[mode]["output"]):
        if mode == "sbox":
            assert ref.sbox(inst, elems) == want
        elif mode == "hash_field":
            assert ref.hash_field(inst, elems) == want
        else:  # each element as its low byte_chunk bytes, as the reference's test serialises it
            assert ref.hash_bytes(inst, b"".join(e.to_bytes(inst.byte_chunk, "little") for e in elems)) == want


@pytest.mark.parametrize("field,name", CASES)
def test_pht_terms_sum_to_the_digest(field, name):
    inst = ref.instance(field, name)
    for elems in ([], [3], [1, 2, 3], [5, 6, 7, 8, 9, 10]):
        pairs = ref.hash_field(inst, elems, pht_terms=True)
        assert [(a + b) % inst.p for a, b in pairs] == ref.hash_field(inst, elems)


def test_limbs_and_montgomery_form():
    inst = ref.instance("vesta", "anemoi_2_1")
    vals = [0, 1, inst.p - 1, 123456789 << 200]
    limbs = np.array([[(v >> (13 * i)) & 8191 for v in vals] for i in range(inst.n_limbs)], dtype=np.int32)
    assert ref.limbs_to_ints(limbs) == vals
    assert all(ref.from_mont(inst, ref.to_mont(inst, v % inst.p)) == v % inst.p for v in vals)
    assert inst.n_limbs == 20 and ref.instance("bls12_377", "anemoi_2_1").n_limbs == 30


def test_work_tasks_and_their_control():
    """The tasks agree with the plain functions; the control's answers are
    the same values unreduced, so they differ on some items and never on
    the value modulo p."""
    inst = ref.instance("vesta", "anemoi_2_1")
    states = [[ref.to_mont(inst, a), ref.to_mont(inst, b)] for a, b in [(1, 2), (3, 4), (5, 6), (7, 8), (9, 10)]]
    out = work.run(("jive", "vesta", "anemoi_2_1", 2, states))
    for (want, lazy), s in zip(out, states):
        plain = ref.jive(inst, [ref.from_mont(inst, v) for v in s])
        assert want == [ref.to_mont(inst, v) for v in plain]
        assert [v % inst.p for v in lazy] == want
    assert any(w != lz for w, lz in out)
    leaves = [ref.to_mont(inst, v) for v in range(8)]
    (want, _), = work.run(("tree", "vesta", "anemoi_2_1", 2, 2, leaves))
    level = list(range(8))
    while len(level) > 1:
        level = [ref.jive(inst, level[i:i + 2])[0] for i in range(0, len(level), 2)]
    assert want == [ref.to_mont(inst, level[0])]
    msg = bytes(range(70))
    (want, _), = work.run(("bytes", "vesta", "anemoi_2_1", [msg]))
    assert want == [ref.to_mont(inst, v) for v in ref.hash_bytes(inst, msg)]
    elems = [ref.to_mont(inst, v) for v in (4, 5, 6)]
    (want, _), = work.run(("field", "vesta", "anemoi_2_1", [elems]))
    assert want == [ref.to_mont(inst, v) for v in ref.hash_field(inst, [4, 5, 6])]
