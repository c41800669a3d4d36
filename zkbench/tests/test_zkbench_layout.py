"""BENCHMARK.json against the benchmark format's shape, and every name in it
resolved to its file under zkbench/."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ZK = ROOT / "zkbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["zkbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=CELLS)
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    config = json.loads((ZK / "configs" / f"{cell['config']}.json").read_text())
    assert config["name"] == cell["config"]
    traffic = json.loads((ZK / "traffic" / f"{cell['traffic']}.json").read_text())
    kind = importlib.import_module(f"zkbench.kinds.{traffic['kind']}")
    assert hasattr(kind, "Cell") and all(len(t) == 3 for t in kind.SPANS)
    for key in ("proof_sample", "profile_rounds"):
        assert isinstance(traffic[key], int) and traffic[key] >= 0
    assert callable(importlib.import_module(f"zkbench.plain.{traffic['kind']}").expect)
    pins = json.loads((ZK / "plain" / "ic" / f"{cell['config']}.json").read_text())
    assert set(pins) == {"measured", "rehearse"}


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_resolves(metric):
    assert callable(importlib.import_module(f"zkbench.metrics.{metric['name']}").read)
    assert set(metric["workloads"]) <= set(CELLS) if "workloads" in metric else True
    if metric in BENCH["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200
    else:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert all(m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
               for m in METRICS)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in METRICS:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs_used_and_their_files():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert {c["name"] for c in BENCH["configs"]} == used and len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"zkbench/configs/{c['name']}.json" and (ROOT / c["file"]).exists()
        assert c["source"].startswith("https://") and len(c["source"]) <= 200


def test_every_file_under_paths_has_a_name_of_allowed_characters():
    for path in ZK.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
