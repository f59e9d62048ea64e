"""BENCHMARK.json against its contract, and every piece it names found by name."""

import json
import re

import pytest

from benchmark import generator, spec
from benchmark.reference import anemoi as ref

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[group]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and spec.config(c["name"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_pieces(cell):
    w = spec.workload(BENCH, cell)
    assert w["config"] in {c["name"] for c in BENCH["configs"]}
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert cfg["reduced"] == [] and set(cfg) == {"field", "instance", "source", "reduced", "guarantees", "assumed"}
    assert ref.instance(cfg["field"], cfg["instance"]).rounds > 0  # the reference defines the instance
    assert (spec.HERE / "entries" / f"{traffic['entry']}.py").exists()
    assert callable(spec.loop(traffic.get("loop", "closed")).run)
    e2e = spec.metrics_for(BENCH, cell, trace=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert spec.metrics_for(BENCH, cell, trace=True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_per_layer_metrics_name_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))


def test_every_seed_gives_the_same_sizes():
    s1, s2 = generator.set_seed(2**31 + 5, 0), generator.set_seed(2**31 + 5, 1)
    assert s1 != s2 and 0 <= s1 < 2**64 and generator.set_seed(-3, 0) >= 0
    import numpy as np

    a = generator.sample(np.random.default_rng(1), 1000, 32, 100)
    b = generator.sample(np.random.default_rng(2), 1000, 32, 100)
    assert len(a) == len(b) == 100 and list(a[:32]) == list(range(32)) and list(a[-32:]) == list(range(968, 1000))
    assert list(generator.sample(np.random.default_rng(1), 8, 8, 4)) != [] and len(set(a)) == 100
