"""The port's verifier and multi-process demo on the CPU.

Tolerance: exact.  ``tools/verify_cuda.py --device cpu --fields vesta``
runs its checks (both permutations, Jive-2 and Jive-4, the 4_3 sponge,
a root) against the golden model and the native oracle, here with the
plain versions replaced by the oracle (test_torch_bench.py), so the
golden model is what holds them; a Jive that flips one limb must give a
FAIL line and exit 1.  ``tools/multihost_demo.py`` runs two gloo workers
of its own over 64 leaves (the plain versions replaced in them too), and
a demo whose group cannot form exits 2.
"""

import os
import time

import pytest
import torch.distributed as dist

from anemoi_tpu_torch.dist import ranks
from anemoi_tpu_torch.dist.ranks import rank_env
from anemoi_tpu_torch.ff import cuda_backend
from anemoi_tpu_torch.tools import multihost_demo, verify_cuda

from .test_torch_bench import flip_lane_1, oracle_jive, oracle_plain, oracle_ranks  # noqa: F401  (fixtures)


def _lines(capsys):
    return capsys.readouterr().out.strip().splitlines()


def test_verify_cpu_all_pass(oracle_plain, capsys):
    assert verify_cuda.main(["--device", "cpu", "--fields", "vesta", "--mul-impl", "cios2", "--ladder", "sw4"]) == 0
    lines = _lines(capsys)
    checks = [line for line in lines if line.startswith(("PASS", "FAIL"))]
    assert len(checks) == 6 and all(line.startswith("PASS") for line in checks)
    for what in ("anemoi_2_1 permutation", "anemoi_4_3 permutation", "jive-2", "jive-4", "sponge (E=7)",
                 "merkle root, 16 leaves"):
        assert any(what in line for line in checks), what
    assert lines[-2] == ('launches: {"jive": 0, "jive_pasta": 0, "jive_mma": 0, "permutation": 0, "four_lane": 0, '
                         '"sponge": 0, "permutation_mma": 0, "permutation_mma_thread": 0, "sponge_mma": 0, '
                         '"unpack": 0}')
    assert lines[-1].endswith("ALL PASS")


def test_verify_reports_a_wrong_jive(oracle_plain, monkeypatch, capsys):
    monkeypatch.setattr(cuda_backend, "jive_plain", flip_lane_1(oracle_jive))
    assert verify_cuda.main(["--device", "cpu", "--fields", "vesta"]) == 1
    lines = _lines(capsys)
    assert any(line.startswith("FAIL vesta/anemoi_2_1 jive-2") for line in lines)
    assert any(line.startswith("PASS vesta/anemoi_2_1 permutation") for line in lines)
    assert lines[-1].endswith("FAILURES")


def test_verify_arguments():
    assert verify_cuda.main(["--fields", "vesta"]) == 2  # no card and no --device cpu
    for bad in (["--mul-impl", "nope"], ["--ladder", "nope"], ["--fields", "nope"]):
        with pytest.raises(SystemExit):
            verify_cuda.main(["--device", "cpu", *bad])


def test_demo_two_gloo_workers(oracle_ranks, capsys):
    assert multihost_demo.main(["--procs", "2", "--leaves", "64", "--device", "cpu"]) == 0
    assert _lines(capsys)[-1] == "multihost demo: OK"


def test_demo_group_that_cannot_form_exits_2(tmp_path, monkeypatch, capsys):
    """Rank 1 of 2 starts too late (a sitecustomize on its path sleeps
    before anything else): rank 0 meets nobody within its 1 s timeout and
    fails, and the demo exits 2 without waiting for rank 1."""
    late = tmp_path / "late"
    late.mkdir()
    (late / "sitecustomize.py").write_text("import time\ntime.sleep(600)\n")
    started = []

    def env(device, world):
        e = rank_env(device, world)
        if started:  # rank 1
            e["PYTHONPATH"] = os.pathsep.join([str(late), e["PYTHONPATH"]])
        started.append(e)
        return e

    monkeypatch.setattr(ranks, "rank_env", env)
    t0 = time.monotonic()
    rc = multihost_demo.main(["--procs", "2", "--leaves", "64", "--device", "cpu", "--timeout", "1"])
    lines = _lines(capsys)
    assert rc == 2 and len(started) == 2 and not dist.is_initialized()
    assert "did not form" in lines[0] and "rank 0 of 2 exited 1" in "\n".join(lines)
    assert time.monotonic() - t0 < 60  # rank 1 was not waited for


def test_demo_on_cards_needs_a_card_a_process(capsys):
    assert multihost_demo.main(["--procs", "2", "--device", "cuda"]) == 2
