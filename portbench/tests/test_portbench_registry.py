"""The runner finds configurations, traffic mixes, load kinds, limits and
per-layer metrics by the names in BENCHMARK.json, and BENCHMARK.json keeps
to its format: names, units, bounds, and the cells each metric lists."""

import json
import re
import shutil

import pytest

from portbench import harness
from portbench.tests.conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.find_cell(ROOT, name)
    assert cell.config["scene"] and cell.config["width"] == 1280
    assert harness.load_kind(cell.traffic["kind"]).__name__ == "Load"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_GiB"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(ROOT, m["name"]))
    assert cell.limits, "every cell has its limits file"


# The end-to-end metrics each cell reports: a time only where the card
# paces the cell; the host paces the scene2 cells.
REPORTED = {
    "scene2.render": {"peak_mem_GiB", "setup_s"},
    "scene2.train": {"peak_mem_GiB", "setup_s"},
    "scene2.fit_invert": {"peak_mem_GiB", "setup_s"},
    "objects1024.render": {"frame_ms", "peak_mem_GiB", "setup_s"},
}


@pytest.mark.parametrize("name", sorted(REPORTED))
def test_end_to_end_metrics_scoped_by_workloads(name):
    cell = harness.find_cell(ROOT, name)
    assert {m["name"] for m in cell.end_to_end} == REPORTED[name]
    assert all(m["moves"] in REPORTED[name] for m in cell.per_layer)


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A later change adds a configuration, a mix and a per-layer metric as
    new files and new entries; nothing that is there changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench/configs/scene2.json").read_text())
    conf["name"] = "scene2_b"
    (tmp_path / "portbench/configs/scene2_b.json").write_text(json.dumps(conf))
    traffic = json.loads((ROOT / "portbench/traffic/render.json").read_text())
    traffic["in_flight"] = 3
    (tmp_path / "portbench/traffic/render3.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/answer_ms.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "scene2_b", "source": "https://example.org/b",
                             "file": "portbench/configs/scene2_b.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "scene2_b.render3", "config": "scene2_b",
                               "traffic": "render3", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "answer_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "renderer",
                               "moves": "peak_mem_GiB", "workloads": ["scene2_b.render3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell(tmp_path, "scene2_b.render3")
    assert cell.config["name"] == "scene2_b" and cell.traffic["in_flight"] == 3
    assert [m["name"] for m in cell.per_layer] == ["answer_ms"]
    assert harness.metric_reader(tmp_path, "answer_ms")(None) == 42.0


def test_benchmark_json_is_well_formed():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        names.add(c["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == names
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
        cells.add(w["name"])
    e2e = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        if "workloads" in m:
            assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e
    for cell in cells:
        assert e2e["setup_s"] >= {cell}
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s")
    layered = set()
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        for cell in m.get("workloads", e2e[m["moves"]]):
            assert cell in e2e[m["moves"]], (m["name"], cell)
            layered.add(cell)
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    assert layered == cells
