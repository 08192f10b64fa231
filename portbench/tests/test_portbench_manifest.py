"""The manifest and every file it names: they parse, keep to the
contract's names, units and keys, and each cell finds what it needs."""

import json
import re
from pathlib import Path

import pytest

from portbench import cell as cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRIC_KEYS = {"name", "unit", "better", "source"}
FAMILY = ("KINDS", "SPANS", "build", "param_shapes", "is_norm_scale",
          "decays", "fp32_exact", "one_tower_logits", "item_embedding",
          "two_tower_probs", "run_steps", "forward_flop", "train_flop",
          "pair_score_flop", "attention_record")


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_text():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            assert NAME.match(entry["name"]), entry["name"]
    for entry in BENCH["configs"]:
        assert line(entry["why"]) and line(entry["source"])
    for entry in BENCH["workloads"]:
        assert line(entry["why"])
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert line(m["layer"])
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[kind]}) == len(BENCH[kind])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entry_keys_and_bounds():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=lambda c: c["name"])
def test_config_file(config):
    path = ROOT / config["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    assert all(NAME.match(k) for k in config["reduced"])
    assert data["dtype"] in ("bfloat16", "float32")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    c = cells.load(name)
    assert hasattr(cells.job_module(c.workload["job"]), "Job")
    family = c.family()
    assert all(hasattr(family, key) for key in FAMILY), family
    assert c.workload["model"] in family.KINDS
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer
    for metric in c.per_layer:
        assert hasattr(cells.reader(metric), "read")
        moves = next(m["moves"] for m in BENCH["per_layer"]
                     if m["name"] == metric)
        assert moves in c.end_to_end
    assert c.workload["check"]["limits"]
    assert all(v >= 0 for v in c.workload["check"]["limits"].values())


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
