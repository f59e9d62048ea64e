"""The arity-4 root cell's check, on the program's plain path on the CPU at
16 leaves (two Jive-4 levels): the sound run must come out correct, and the
control and each of ``test_bench_faults.FAULTS`` underneath the timed path
must come out not correct."""

import time

import pytest

from benchmark import harness
from benchmark.tests.test_bench_faults import FAULTS

CELL = "vesta_4_3.root_2p24_arity4"
SMALL = {"leaves": 16, "warmup_calls": 0, "check": {"nodes_per_level": 2, "subtree_leaves": 4}}


def _run(**kw):
    return harness.run_cell(CELL, 2**31 + 13, 0.0, False, t_start=time.perf_counter(), device="cpu",
                            traffic_overrides=SMALL, workers=0, **kw)


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"] and result["failed"] == 0
    (check,) = result["checks"].values()
    # the one call's set: 2 nodes of level 1, the top node, the returned root and two 4-leaf subtrees
    assert check == {"value": 0, "limit": 0, "of": 2 + 1 + 1 + 2}
    assert set(result["metrics"]) == {"root_ms", "root_ms_p90", "setup_s"}


def test_control_is_not_correct():
    assert not _run(control=True)["correct"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    from anemoi_tpu_torch.ff import cuda_backend

    monkeypatch.setattr(cuda_backend, "jive", FAULTS[fault](cuda_backend.jive))
    result = _run()
    assert not result["correct"]
    assert result["checks"]["wrong_nodes"]["value"] > 0
