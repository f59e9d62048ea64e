"""The port's bench (``anemoi_tpu_torch/bench.py``) on the CPU.

Tolerance: exact.  The plain PyTorch version costs about 2.5 s a call and
47 ms a lane on one CPU core, and a 10 KB Vesta message is 111
permutations, so the bench's configs run here with the plain versions
replaced by the native oracle (``ff/native.py``: C++ 64-bit Montgomery,
independent of the port's limb code; ``oracle_plain``), in this process
and, through a
``sitecustomize`` module on their path, in the processes a test starts
(``oracle_ranks``: the dry run's gloo ranks).  That keeps what these tests
check -- the bench's sizes, its parity checks against the golden model,
its metric names, its tables and its dry run -- within seconds; the plain
path itself is held against the JAX package in test_torch_jive.py and,
over two gloo ranks, test_torch_dist.py.  ``bench.py`` is read as text,
never imported: it imports JAX.
"""

import ast
import json
import os
from pathlib import Path

import pytest
import torch

from anemoi_tpu_torch import bench
from anemoi_tpu_torch.ff import cuda_backend, native

ROOT = Path(__file__).resolve().parent.parent


def oracle_jive(inst, k, x):
    out = native.jive_batch_canonical(inst, native.canonical_host(inst, x), k)
    return native.montgomery(inst, out).reshape(-1, x.shape[1])


def oracle_permutation(inst, x):
    return native.montgomery(inst, native.permute_batch_canonical(inst, native.canonical_host(inst, x))).reshape(x.shape)


def oracle_sponge(inst, num_elements, x):
    """``cuda_backend.sponge_plain`` through the oracle's host sponge."""
    return native.montgomery(inst, native.host_sponge(inst, native.canonical_host(inst, x))).reshape(-1, x.shape[1])


ORACLE = {"jive_plain": oracle_jive, "permutation_plain": oracle_permutation, "sponge_plain": oracle_sponge}


def install_oracle_plain():
    """The kernels' plain versions replaced by the native oracle in this
    process, for good: what a started process's sitecustomize calls."""
    for name, fn in ORACLE.items():
        setattr(cuda_backend, name, fn)


@pytest.fixture
def oracle_plain(monkeypatch):
    """The kernels' plain versions replaced by the native oracle for this test."""
    for name, fn in ORACLE.items():
        monkeypatch.setattr(cuda_backend, name, fn)


@pytest.fixture
def oracle_ranks(tmp_path, monkeypatch):
    """The processes this test starts replace the plain versions too: a
    sitecustomize module on their PYTHONPATH calls install_oracle_plain."""
    shim = tmp_path / "oracle_shim"
    shim.mkdir()
    (shim / "sitecustomize.py").write_text("from tests.test_torch_bench import install_oracle_plain\n"
                                           "install_oracle_plain()\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join([str(ROOT), str(shim)]))


def flip_lane_1(fn):
    """``fn`` with one limb of lane 1 (a checked lane) of its output flipped."""

    def wrong(*args):
        out = fn(*args).clone()
        out[0, min(1, out.shape[1] - 1)] ^= 1
        return out

    return wrong


CASES = {  # name: (plain function to break, bench call, lanes, parents or states checked)
    "jive": ("jive_plain", lambda: bench.bench_jive("vesta", "anemoi_4_3", n=64, reps=1, device="cpu"), 64, 4),
    "sponge": ("sponge_plain", lambda: bench.bench_sponge_10kb(n_msgs=6, reps=1, device="cpu"), 6, 4),
    "merkle arity 2": ("jive_plain", lambda: bench.bench_merkle(n_leaves=1 << 6, reps=1, device="cpu"), 64,
                       4 + 4 + 4 + 4 + 2 + 1),
    "merkle arity 4": ("jive_plain", lambda: bench.bench_merkle("vesta", "anemoi_4_3", n_leaves=4**3, reps=1,
                                                                device="cpu"), 64, 4 + 4 + 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bench_runs_pass_parity(case, oracle_plain):
    _, call, n, checked = CASES[case]
    run = call()
    assert run["value"] > 0 and run["n"] == n and run["parity"] == "ok" and run["parity_lanes"] == checked
    assert len(run["times"]) == 1 and isinstance(run["checksum"], int) and run["words"] == 8
    assert run["launches"] == {"jive": 0, "jive_pasta": 0, "jive_mma": 0, "permutation": 0, "four_lane": 0, "sponge": 0,
                               "permutation_mma": 0, "permutation_mma_thread": 0, "sponge_mma": 0,
                               "unpack": 0}  # no kernel on the CPU
    if case == "sponge":
        assert run["elements"] == 331  # ceil(10240 / 31), bench.py:217


@pytest.mark.parametrize("case", list(CASES))
def test_a_wrong_kernel_fails_parity(case, oracle_plain, monkeypatch):
    name, call, _, _ = CASES[case]
    monkeypatch.setattr(cuda_backend, name, flip_lane_1(getattr(cuda_backend, name)))
    with pytest.raises(bench.ParityError):
        call()


def _rows(path):
    return [m.groups() for m in bench._ROW.finditer(Path(path).read_text())]


def test_matrix_writes_14_rows_and_resumes(tmp_path, oracle_plain, capsys):
    out = tmp_path / "matrix.md"
    assert bench.main(["--matrix", "--device", "cpu", "--n", "64", "--out", str(out), "--reps", "1"]) == 0
    rows = _rows(out)
    assert [(f, i) for f, i, *_ in rows] == [(f, i) for f in bench.FIELD_NAMES for i in bench.INSTANCE_NAMES]
    assert all(float(rate.replace(",", "")) > 0 and parity == "4 lanes exact" for _, _, rate, _, parity in rows)
    assert "batch 64" in out.read_text() and "on cpu" in out.read_text()
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["device"] == "cpu" and len(doc["matrix"]) == 14

    # drop 2 rows and give a kept one a value no run gives; resume measures the 2
    drop = ("| bn_254 | anemoi_2_1 ", "| vesta | anemoi_4_3 ", "| bls12_377 | anemoi_2_1 ")
    lines = [line for line in out.read_text().splitlines() if not line.startswith(drop)]
    out.write_text("\n".join(lines + ["| bls12_377 | anemoi_2_1 | 12,345.6 | -- | 4 lanes exact |"]) + "\n")
    assert len(_rows(out)) == 12
    assert bench.main(["--matrix", "--device", "cpu", "--n", "64", "--out", str(out), "--reps", "1", "--resume"]) == 0
    rows = _rows(out)
    assert len(rows) == 14 and rows[0][:3] == ("bls12_377", "anemoi_2_1", "12,345.6")
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(r["field"], r["instance"]) for r in doc["matrix"] if not r.get("kept")] == [
        ("bn_254", "anemoi_2_1"), ("vesta", "anemoi_4_3")]


def _bench_py():
    return ast.parse((ROOT / "bench.py").read_text())


def test_metric_names_match_bench_py():
    tree = _bench_py()
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "try_add"]
    want = [(ast.literal_eval(c.args[0]), ast.literal_eval(c.args[1]),
             ast.literal_eval(c.args[3]) if len(c.args) > 3 else None) for c in calls]
    got = [(metric, unit, ref) for metric, unit, ref, _, _ in bench.secondary_configs(1 << 20, "cpu")]
    assert got == want
    strings = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert {bench.HEADLINE, "multichip_dryrun_collective_bytes_per_device"} <= strings
    assert bench.dryrun_entry({"collective_bytes_per_device": 1, "n_devices": 2, "collective_counts": {},
                               "t1": 1, "tN": 1, "n_leaves": 4})["metric"] in strings

    # --all's loops over (field, instance) pairs, and the reference rates
    all_fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "bench_all")
    loops = [ast.literal_eval(n.iter) for n in ast.walk(all_fn) if isinstance(n, ast.For)
             and isinstance(n.iter, ast.List)]
    names = [f"{f}_{i}_jive_2to1" for f, i in loops[0]] + [f"{f}_{i}_sponge_10kb" for f, i in loops[1]]
    assert [c[0] for c in bench.all_configs(1 << 20, "cpu")] == names + [
        "vesta_anemoi_2_1_merkle_2p20_arity2", "vesta_anemoi_4_3_merkle_2p24_arity4"]
    rates = next(n.value for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "_REF_RATES")
    assert eval(compile(ast.Expression(rates), "bench.py", "eval")) == bench._REF_RATES
    ref = next(n.value for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "REFERENCE_RATE")
    assert eval(compile(ast.Expression(ref), "bench.py", "eval")) == bench.REFERENCE_RATE


def test_default_run_prints_the_headline_first_and_the_document_last(monkeypatch, capsys):
    """main's document around stand-in runs: the order of bench.py:568-660
    and its arithmetic (vs_baseline, vs_reference_core, mb_per_sec)."""

    def run(value, **extra):
        return {"value": value, "ms": 1.5, "n": 4, "words": 8, "parity": "ok", "parity_lanes": 4,
                "launches": {"jive": 1}, **extra}

    monkeypatch.setattr(bench, "bench_jive", lambda *a, **k: run(7723.0 * 2))
    monkeypatch.setattr(bench, "bench_sponge_10kb", lambda *a, **k: run(100.0))
    monkeypatch.setattr(bench, "bench_merkle", lambda *a, **k: run(5.0))
    monkeypatch.setattr(bench, "bench_multichip_dryrun", lambda: {
        "t1": 1.0, "tN": 2.0, "n_devices": 8, "n_leaves": 64, "collective_bytes_per_device": 640,
        "collective_counts": {"all-gather": 1}, "collective_ops": []})
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    head, doc = json.loads(lines[0]), json.loads(lines[-1])
    assert head == {"metric": bench.HEADLINE, "value": 15446.0, "unit": "hashes/s",
                    "vs_baseline": round(15446.0 / (1.0 / 129.48e-6), 2)}
    assert {k: doc[k] for k in head} == head and doc["device"] == "cpu" and doc["parity"] == "ok"
    configs = {c["metric"]: c for c in doc["configs"]}
    assert list(configs) == ["multichip_dryrun_collective_bytes_per_device"] + [
        c[0] for c in bench.secondary_configs(1 << 20, "cpu")]
    assert configs["vesta_anemoi_4_3_jive_2to1"]["vs_reference_core"] == round(15446.0 / (1e6 / 176.58), 2)
    assert configs["vesta_anemoi_4_3_sponge_10kb"]["mb_per_sec"] == round(100 * 10240 / 1e6, 1)
    assert configs["multichip_dryrun_collective_bytes_per_device"]["value"] == 640
    assert all(c["parity"] == "ok" and c["value"] > 0 for c in doc["configs"])


def test_no_card_no_result(capsys):
    """Without a card and without --device cpu the bench exits non-zero
    and prints no result: no fallback to the CPU."""
    assert not torch.cuda.is_available()
    assert bench.main(["--headline-only"]) == 2
    assert capsys.readouterr().out == ""


def test_multichip_dryrun_two_ranks(oracle_plain, oracle_ranks):
    """Two gloo ranks over 64 leaves, against the one-process root; the
    forest's one all-gather brings every rank the 2 roots of L = 20 int32
    limbs of 4 bytes: 2 * 20 * 4 = 160 bytes a rank."""
    d = bench.bench_multichip_dryrun(2, 64)
    assert d["n_devices"] == 2 and d["n_leaves"] == 64 and d["t1"] > 0 and d["tN"] > 0
    assert d["collective_bytes_per_device"] == 2 * 20 * 4
    assert d["collective_counts"] == {"all-gather": 1}
    assert d["collective_ops"] == [{"op": "all-gather", "shape": "s32[2,20]", "bytes_per_device": 160}]
