"""The check's own test: the harness's run, past its look for a card, on
the program's plain path on the CPU at a small size, with the timed path
broken underneath.  Each fault must come out not correct, and so must the
control; the sound run must come out correct.

The faults are those a hash call can have: a step that returns its state
unchanged (nothing permuted), half of the batch left out, and an answer
altered where it is produced.  The cells run on one card, so no exchange
between cards can be left out.
"""

import sys
import time
import types

import pytest
import torch

from benchmark import harness

SMALL = {
    "vesta_2_1.root_2p20": {"leaves": 4, "warmup_calls": 0,
                            "check": {"nodes_per_level": 2, "subtree_leaves": 2}},
    "vesta_2_1.jive_2p20": {"states": 4, "warmup_calls": 0, "check": {"lanes": 4}},
    "vesta_2_1.sponge_bytes_4096x10kb": {"messages": 8, "message_bytes": 31, "warmup_calls": 0,
                                         "check": {"messages": 8}},
}


def _unchanged(real):
    """The state comes back as it went in: the output is its first rows."""
    return lambda inst, k_or_e, x, *a, **kw: x[: real(inst, k_or_e, x, *a, **kw).shape[0]].clone()


def _half(real):
    def f(*args, **kw):
        out = real(*args, **kw).clone()
        out[:, out.shape[1] // 2:] = 0
        return out
    return f


def _altered(real):
    def f(*args, **kw):
        out = real(*args, **kw).clone()
        out[0, -1] ^= 1
        return out
    return f


FAULTS = {"unchanged": _unchanged, "half_batch": _half, "altered_answer": _altered}


def _run(cell, **kw):
    return harness.run_cell(cell, 2**31 + 11, 0.0, False, t_start=time.perf_counter(), device="cpu",
                            traffic_overrides=SMALL[cell], workers=0, **kw)


@pytest.mark.parametrize("cell", list(SMALL))
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"] and result["failed"] == 0
    (check,) = result["checks"].values()
    assert check["value"] == 0 and check["of"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", list(SMALL))
def test_control_is_not_correct(cell):
    result = _run(cell, control=True)
    assert not result["correct"]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", list(SMALL))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from anemoi_tpu_torch.ff import cuda_backend

    target = "sponge" if "sponge" in cell else "jive"
    monkeypatch.setattr(cuda_backend, target, FAULTS[fault](getattr(cuda_backend, target)))
    result = _run(cell)
    assert not result["correct"]
    assert next(iter(result["checks"].values()))["value"] > 0


def test_jax_loaded_after_the_window_ends_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    with pytest.raises(harness.ForbiddenModules):
        _run("vesta_2_1.jive_2p20")


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """On the card: one short run of the Vesta Jive cell through the command."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import json
    import subprocess

    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "vesta_2_1.jive_2p20", "--seed",
                        str(2**31 + 3), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=str(harness.spec.ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import subprocess

    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "vesta_2_1.jive_2p20", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=str(harness.spec.ROOT))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_returned_root_apart_from_its_level_is_not_correct(monkeypatch):
    """The root the call returns is judged too, not only the kept top level."""
    from anemoi_tpu_torch.merkle import tree

    real = tree.MerkleTree.root

    def root(self, *a, **kw):
        top, levels = real(self, *a, **kw)
        top = top.clone()
        top[-1, 0] ^= 1
        return top, levels

    monkeypatch.setattr(tree.MerkleTree, "root", root)
    result = _run("vesta_2_1.root_2p20")
    assert not result["correct"] and result["checks"]["wrong_nodes"]["value"] == 1  # the one call's root
