"""BENCHMARK.json against the benchmark's contract: keys, names, units,
and a file for every configuration, traffic mix and metric it names; and
each traffic file's optional keys."""

import json
import numbers
import re

import pytest

from demux_bench.cells import HERE, ROOT
from demux_bench.run import DEADLINE_S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def text(value):
    return isinstance(value, str) and 1 <= len(value) <= 200 and "\n" not in value and "\t" not in value


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["demux_bench"]
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert all(text(word) for word in manifest["command"]) and len(manifest["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    for config in manifest["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(config["name"]) and config["name"] in used
        assert text(config["source"]) and text(config["why"])
        assert config["file"].startswith("demux_bench/") and (ROOT / config["file"]).is_file()
        assert all(NAME.match(key) for key in config["reduced"]) and len(config["reduced"]) <= 16
        body = json.loads((ROOT / config["file"]).read_text())
        assert body["name"] == config["name"] and body["reduced"] == config["reduced"]


def test_workloads(manifest):
    names = [w["name"] for w in manifest["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for cell in manifest["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and text(cell["why"])
        assert cell["chips"] in (1, 4)
        assert (ROOT / "demux_bench" / "traffic" / f"{cell['traffic']}.json").is_file()
    assert sum(c["chips"] == 4 for c in manifest["workloads"]) <= max(1, len(names) // 4)


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    end = {m["name"]: m for m in manifest["end_to_end"]}
    names = list(end) + [m["name"] for m in manifest["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in end and end["setup_s"]["bound"] <= 0.25
    for metric in manifest["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in manifest["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in end and text(metric["layer"])
        moved = end[metric["moves"]].get("workloads", sorted(cells))
        assert set(metric.get("workloads", cells)) <= set(moved)
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
        assert set(metric.get("workloads", cells)) <= cells
        assert (ROOT / "demux_bench" / "metrics" / f"{metric['name']}.py").is_file()


def test_every_cell_reports_enough(manifest):
    for cell in manifest["workloads"]:
        def mine(metrics):
            return [m for m in metrics if cell["name"] in m.get("workloads", [cell["name"]])]
        ends = mine(manifest["end_to_end"])
        assert "setup_s" in [m["name"] for m in ends] and len(ends) >= 2
        assert mine(manifest["per_layer"])


def setup_deadline_ok(plan):
    """A traffic file's ``setup_deadline_s``, where it has one: a positive
    number of seconds, no later than the run's own deadline."""
    value = plan.get("setup_deadline_s")
    if value is None:
        return "setup_deadline_s" not in plan
    return isinstance(value, numbers.Real) and not isinstance(value, bool) and 0 < value <= DEADLINE_S


@pytest.mark.parametrize("path", sorted((HERE / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_traffic_files(path):
    assert setup_deadline_ok(json.loads(path.read_text()))


@pytest.mark.parametrize("value, accepted", [
    (180, True), (4.5, True), (DEADLINE_S, True),
    (0, False), (-1, False), ("180", False), (True, False), (None, False), (DEADLINE_S + 1, False)])
def test_setup_deadline_in_a_traffic_file(value, accepted):
    plan = json.loads((HERE / "traffic" / "tenx-v2-fast.json").read_text())
    plan["setup_deadline_s"] = value
    assert setup_deadline_ok(json.loads(json.dumps(plan))) == accepted
