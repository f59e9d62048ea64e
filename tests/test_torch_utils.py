"""The port's utils against the JAX package's, on the CPU.

Tolerance: exact.  ``check_limbs`` takes what the JAX ``check_limbs``
takes and rejects what it rejects (digits out of range, the wrong dtype),
on arrays and on CPU tensors; where the JAX function's value check is
void (it decodes with ``% p``, so no value can exceed p), the port's
catches a value of p or more.  ``maybe_check`` runs only under
``ANEMOI_DEBUG``.  ``trace`` writes a Chrome trace of the block, and
``Timer`` reports as the JAX ``Timer`` does.
"""

import json

import numpy as np
import pytest
import torch

from anemoi_tpu.fields import params as jparams
from anemoi_tpu.utils import debug as jdebug
from anemoi_tpu.utils.profiling import Timer as JTimer
from anemoi_tpu_torch.ff import limb_ops as lo
from anemoi_tpu_torch.fields.params import LIMB_MASK, get_field, limbs_from_int
from anemoi_tpu_torch.utils import debug, profiling


def _limbs(fp, values):
    return np.stack([limbs_from_int(v, fp.n_limbs) for v in values], axis=1)


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_check_limbs_matches_jax(field):
    fp, jfp = get_field(field), jparams.get_field(field)
    ok = _limbs(fp, [0, 1, fp.p - 1, fp.p // 3])
    for arr in (ok, torch.from_numpy(ok), ok[None], torch.from_numpy(ok)[None]):  # [L, N] and [1, L, N]
        debug.check_limbs(arr, fp)
        jdebug.check_limbs(np.asarray(arr), jfp)
    lazy = _limbs(fp, [fp.p, 2 * fp.p - 1])  # in [p, 2p)
    debug.check_limbs(lazy, fp, lazy=True)
    jdebug.check_limbs(lazy, jfp, lazy=True)
    relaxed = ok.copy()
    relaxed[0, 0] = LIMB_MASK + (1 << 4)  # a lazy sweep's residue: value 1 + 2^13 + 2^4 - 1
    debug.check_limbs(relaxed, fp, relaxed=True)
    jdebug.check_limbs(relaxed, jfp, relaxed=True)
    for bad, kw in ((relaxed, {}), (ok.astype(np.int64), {}), (-ok - 1, {}), (ok + (1 << 14), {"relaxed": True})):
        with pytest.raises(AssertionError):
            debug.check_limbs(bad, fp, **kw)
        with pytest.raises(AssertionError):
            jdebug.check_limbs(bad, jfp, **kw)


@pytest.mark.parametrize("field", ["vesta", "bls12_381"])
def test_check_limbs_catches_values_above_p(field):
    """The JAX function passes these (its decode reduces mod p); the
    port's raises, as both docstrings promise."""
    fp = get_field(field)
    for values, kw in (([fp.p], {}), ([2 * fp.p], {"lazy": True}), ([(1 << (13 * fp.n_limbs)) - 1], {"lazy": True})):
        with pytest.raises(AssertionError, match="exceed"):
            debug.check_limbs(_limbs(fp, values), fp, **kw)
        jdebug.check_limbs(_limbs(fp, values), jparams.get_field(field), **kw)
    # p + t (t < 2^13) written with a relaxed low digit of 2^13: its carry lifts the value past p
    x = _limbs(fp, [fp.p + (-fp.p) % (1 << 13)])
    j = next(i for i in range(1, fp.n_limbs) if x[i, 0])
    x[j, 0] -= 1
    x[1:j, 0] = LIMB_MASK
    x[0, 0] = 1 << 13
    with pytest.raises(AssertionError, match="exceed"):
        debug.check_limbs(x, fp, relaxed=True)


def test_maybe_check_follows_anemoi_debug(monkeypatch):
    fp = get_field("vesta")
    bad = _limbs(fp, [fp.p])
    monkeypatch.setattr(debug, "DEBUG", False)
    debug.maybe_check(bad, fp)
    monkeypatch.setattr(debug, "DEBUG", True)
    with pytest.raises(AssertionError):
        debug.maybe_check(bad, fp)
    debug.maybe_check(lo.encode_ints([5, 6], fp), fp)


def test_trace_writes_a_chrome_trace(tmp_path):
    fp = get_field("vesta")
    x = lo.encode_ints([3, 4], fp)
    with profiling.trace(tmp_path / "t") as prof:
        lo.mont_mul(x, x, lo.field_consts(fp))
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    assert prof.trace_path.parent == tmp_path / "t"
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)


def test_timer_reports_as_jax(monkeypatch):
    timer = profiling.Timer(device="cpu")
    with timer.section("pack"):
        pass
    with timer.section("hash"):
        pass
    with timer.section("pack"):
        pass
    assert list(timer.sections) == ["pack", "hash"]
    ref = JTimer()
    ref.sections = timer.sections = {"pack": 0.003, "hash": 0.001}
    assert timer.report() == ref.report() == "pack: 3.00 ms (75%)\nhash: 1.00 ms (25%)"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        profiling.Timer()
