"""The harness: cells, mixes and readers found by name, the import guard,
and the result line a run prints."""

import json
import shutil

import numpy as np
import pytest
from conftest import TINY

from portbench import cell as cells
from portbench import guard, run
from portbench.trace import Trace, group_of

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_an_added_cell_is_found_by_name(tmp_path):
    """A new cell, mix and metric reader are files and manifest entries
    only; nothing that is there changes."""
    root = tmp_path / "portbench"
    shutil.copytree(cells.PACKAGE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(cells.MANIFEST.read_text())
    (root / "traffic" / "pairs-b8-s510.json").write_text(json.dumps(
        {"kind": "pairs", "rows": 8, "seq_len": 510, "min_len": 127,
         "pool": 4, "labels": False}))
    (root / "workloads" / "large-score-s510-b8.json").write_text(json.dumps(
        {"job": "score", "model": "one_tower", "trace_steps": 5,
         "check": {"requests": 4, "block_rows": 8,
                   "limits": {"prob_gap": 0.01}}}))
    (root / "metrics" / "launches.py").write_text(
        "def read(name, rec):\n    return 7.0\n")
    bench["workloads"].append({"name": "large-score-s510-b8",
                               "config": "roberta-large",
                               "traffic": "pairs-b8-s510", "chips": 1,
                               "why": "small requests"})
    bench["per_layer"].append({"name": "launches.score", "unit": "1",
                               "better": "lower", "source":
                               "program_counter", "layer": "kernels",
                               "moves": "score_pairs_per_s",
                               "workloads": ["large-score-s510-b8"]})
    for m in bench["end_to_end"]:
        if "large-score-s510" in m.get("workloads", []):
            m["workloads"].append("large-score-s510-b8")
    c = cells.load("large-score-s510-b8", bench, root)
    assert c.traffic["rows"] == 8 and c.workload["job"] == "score"
    assert c.end_to_end == ["score_pairs_per_s", "score_batch_p95_ms",
                            "setup_s"]
    assert "launches.score" in c.per_layer
    assert cells.reader("launches.score", root).read("launches.score",
                                                      {}) == 7.0
    assert hasattr(cells.job_module("score", root), "Job")
    with pytest.raises(KeyError):
        cells.load("large-score-s510-b8")  # not in the real manifest


@pytest.mark.parametrize("name,refused", [
    ("jax.numpy", True), ("jax", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("optax", True), ("item_alignment_tpu", True),
    ("item_alignment_tpu.models", True), ("item_alignment_torch.ops", False),
    ("item_alignment_torch", False), ("jaxtyping", False),
    ("portbench.run", False)])
def test_import_guard(name, refused):
    assert guard.refused([name]) == ([name] if refused else [])


def test_guard_reads_the_sources(tmp_path):
    assert guard.problems(modules=[]) == []
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "a.py").write_text(
        "import item_alignment_torch.ops\n")
    (tmp_path / "b.py").write_text(
        "def f():\n    from jax import numpy\n")
    (tmp_path / "c.py").write_text("import item_alignment_torch\n")
    assert guard.problems(modules=["item_alignment_tpu.ops"],
                          root=tmp_path) == [
        "loaded: item_alignment_tpu.ops",
        f"{tmp_path.name}/b.py imports jax",
        f"{tmp_path.name}/reference/a.py imports item_alignment_torch.ops"]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(tiny, trace):
    c = tiny("large-score-s510")
    line = run.run_cell(c, 2 ** 31 + 5, 0.2, bool(trace), "cpu", TINY)
    keys = list(line)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert set(keys) <= set(RESULT_KEYS) | {"breakdown", "checks"}
    assert (trace == 1) == ("breakdown" in line)
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == set(c.end_to_end)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for ch in line["checks"].values():
        assert set(ch) == {"value", "limit"}
    json.dumps(line, allow_nan=False)


def test_trace_union_gaps_and_groups():
    tr = Trace(0.0, 100.0, [(10, 30, "sm90_xmma_gemm_bf16"),
                            (20, 40, "flash_fwd_bf16"),
                            (60, 70, "elementwise_kernel"),
                            (80, 90, "Memcpy HtoD")],
               [(0, 100, "portbench.window"), (40, 60, "aten::copy_"),
                (45, 49, "cudaStreamSynchronize")], 1e-4)
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.idle_gaps(2) == [["aten::copy_", pytest.approx(20e-6)],
                               ["no host range", pytest.approx(10e-6)]]
    groups = tr.group_s()
    assert groups["products"] == pytest.approx(20e-6)
    assert groups["attention"] == pytest.approx(20e-6)
    assert groups["rest"] == pytest.approx(10e-6)
    assert groups["memory"] == pytest.approx(10e-6)
    assert group_of("nvjet_tst_128x256") == "products"


def test_logodds_scatter_reads_scatter_not_shift():
    from portbench import compare

    gen = np.random.default_rng(0)
    logits = gen.normal(size=(256, 2))
    margin = logits[:, 1] - logits[:, 0]

    def probs(m):
        return 1.0 / (1.0 + np.exp(-m))

    assert compare.logodds_scatter(probs(margin), logits) < 1e-9
    assert compare.logodds_scatter(probs(margin + 0.3), logits) < 1e-9
    noisy = margin + gen.normal(scale=0.01, size=256)
    assert abs(compare.logodds_scatter(probs(noisy), logits) - 0.01) < 2e-3
    assert compare.logodds_scatter([np.nan] * 256, logits) == np.inf
