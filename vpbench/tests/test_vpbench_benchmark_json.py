"""BENCHMARK.json keeps to the benchmark's contract: keys, names and
units in the allowed characters, a file for every configuration, traffic
mix and metric, every per-layer metric's cells reporting the end-to-end
metric it moves, and every configuration used by a cell."""

import json
import math
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(map(line, BENCH["command"]))
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (REPO / "vpbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len({w["name"] for w in cells}) == len(cells)
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, math.floor(0.25 * len(cells)))


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e, per = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        moved = next(x for x in e2e if x["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(moved, cell)
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (REPO / "vpbench" / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", []):
            assert cell in cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m for m in BENCH["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    moved = {m["name"] for m in e2e}
    per = [m for m in BENCH["per_layer"]
           if cell in m.get("workloads", [cell] if m["moves"] in moved
                            else [])]
    assert per


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
