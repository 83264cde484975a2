"""The benchmark's data files: every configuration and cell parses, names
only what a name may hold, and agrees with BENCHMARK.json, whose entries
each find their files."""

import json
import re

import pytest

from port_bench.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CONFIGS = sorted(p.stem for p in (core.BENCH_DIR / "configs").glob("*.json"))
CELLS = sorted(p.stem for p in (core.BENCH_DIR / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_config_parses_and_names(name):
    conf = core.config_spec(name)
    assert NAME.match(name)
    assert {"arch", "source", "precision", "model", "reduced", "assumed"} <= set(conf)
    assert len(conf["source"]) <= 200 and conf["source"].startswith("https://")
    assert all(NAME.match(k) for k in conf["model"]) and all(NAME.match(k) for k in conf["reduced"])
    core.reference_module(conf["arch"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_parses_and_names(name):
    cell = core.cell_spec(name)
    assert NAME.match(name) and NAME.match(cell["config"]) and NAME.match(cell["traffic"]["name"])
    assert cell["config"] in CONFIGS and cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    assert (core.BENCH_DIR / "traffic" / f"{cell['traffic']['kind']}.py").is_file()
    assert cell["checks"] and all(v > 0 for v in cell["checks"].values())


def test_benchmark_json_finds_its_files():
    bench = core.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"] and 1 <= bench["run_seconds"] <= 51
    for conf in bench["configs"]:
        spec = core.config_spec(conf["name"])
        assert conf["file"] == f"port_bench/configs/{conf['name']}.json"
        assert conf["source"] == spec["source"] and conf["reduced"] == spec["reduced"]
    for w in bench["workloads"]:
        cell = core.cell_spec(w["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell["config"], cell["traffic"]["name"], cell["chips"], cell["why"])
    cells = {w["name"] for w in bench["workloads"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert (core.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= cells
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    json.dumps(bench)


def test_every_cell_reports_what_the_contract_asks():
    bench = core.benchmark()
    for w in bench["workloads"]:
        e2e = [m["name"] for m in core.metrics_of(bench, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.metrics_of(bench, w["name"], "per_layer")
