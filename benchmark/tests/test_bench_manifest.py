"""BENCHMARK.json against the manifest's schema, and every file a cell, a
configuration, a traffic mix or a metric needs, found by its name."""

import json
import math
import os
import re

import pytest

from benchmark.run import find_kind

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(manifest["command"]) <= 32 and all(_text(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_run_seconds_fit_the_check(manifest):
    # a full check: 2 + 14 x cells runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare, at 24 cells
    rs = manifest["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names + [w["traffic"] for w in manifest["workloads"]] + [w["config"] for w in manifest["workloads"]]:
        assert NAME.match(n), n
    assert len({c["name"] for c in manifest["configs"]}) == len(manifest["configs"])
    assert len({w["name"] for w in manifest["workloads"]}) == len(manifest["workloads"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_entries_have_the_schema_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text(m["layer"])


def test_setup_and_one_more_metric_in_every_cell(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in manifest["workloads"]:
        mine = [m for m in manifest["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in manifest["per_layer"])


def test_per_layer_metrics_move_a_metric_their_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert w in moved.get("workloads", cells)


def test_four_chip_cells_are_few(manifest):
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, math.floor(0.25 * len(manifest["workloads"])))


def test_every_file_is_found_by_name(manifest):
    bench = manifest["paths"][0]
    files = set()
    for c in manifest["configs"]:
        assert c["file"].startswith(bench + "/")
        path = os.path.join(ROOT, c["file"])
        with open(path) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        files.add(c["file"])
        if "weights" in conf:
            assert os.path.exists(os.path.join(ROOT, conf["weights"]))
    assert len(files) == len(manifest["configs"])
    for w in manifest["workloads"]:
        with open(os.path.join(ROOT, bench, "traffic", f"{w['traffic']}.json")) as f:
            kind = json.load(f)["kind"]
        assert find_kind(kind).KIND == kind
        with open(os.path.join(ROOT, bench, "limits", f"{w['name']}.json")) as f:
            assert all(v >= 0 for v in json.load(f).values())
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, bench, "metrics", f"{m['name']}.py")), m["name"]
