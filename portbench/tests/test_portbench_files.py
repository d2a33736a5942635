"""Every file a cell names exists and loads, and BENCHMARK.json keeps the
shape the benchmark's contract gives it."""

import json
import os
import re

import pytest

import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        lines = [e[k] for k in ("why", "layer") if k in e]
        if section == "configs":
            lines.append(e["source"])
        for line in lines:
            assert 1 <= len(line) <= 200 and "\n" not in line and "\t" not in line


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = os.path.join(harness.ROOT, config["file"])
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    data = json.load(open(path))
    assert data["name"] == config["name"] and data["source"] == config["source"]
    for key in config["reduced"]:
        assert NAME.match(key) and key in data and key in data["source_values"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    module = data["reference"].split(":")[0]
    assert os.path.exists(os.path.join(harness.HERE, "reference", f"{module}.py"))
    model = harness.reference_model(data)
    assert sum(p.numel() for p in model.parameters()) == data["parameters"]
    without = {k: v for k, v in data.items() if k != "reference"}
    with pytest.raises(KeyError, match=f"configs/{config['name']}.json"):
        harness.reference_model(without)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_and_metrics(name):
    cell = harness.cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    drv = harness.driver(cell.traffic["driver"])
    assert callable(drv.run) and callable(drv.control)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]).read)
    assert set(cell.limits) in ({"excess_gap"}, {"max_gap"},
                                {"first_loss_gap", "grad_gap", "change_gap"})


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            cell = harness.cell(w)
            assert m["moves"] in {x["name"] for x in cell.end_to_end}
        base = m["name"].split(".")[0]
        assert layers.setdefault(base, m["layer"]) == m["layer"]
        if base.endswith("_roofline"):
            assert m["unit"] == "%"


def test_paths_hold_only_the_benchmark():
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(harness.HERE, "limits", f"{w['name']}.json"))
