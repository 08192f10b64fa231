"""The harness: cells, mixes and readers found by name, the import guard,
and the result line a run prints."""

import hashlib
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


TOY_FAMILY = '''"""A toy family for scoring cells on the CPU: embeddings, a token-wise
mixer under a span of its own (``mixer``), a masked mean and a two-way
head; what the score job calls and no more."""

import contextlib

import torch
import torch.nn.functional as F

from item_alignment_torch.engine.observability import span
from item_alignment_torch.models.outputs import PairClassifierOutput

from portbench import weights

KINDS = ("one_tower",)
SPANS = ("mixer",)


def param_shapes(sizes, kind):
    V, H = sizes["vocab_size"], sizes["hidden_size"]
    return [("embed.weight", (V, H)), ("mix.weight", (H, H)),
            ("mix.bias", (H,)), ("head.weight", (2, H)), ("head.bias", (2,))]


def is_norm_scale(name):
    return False


def _logits(w, ids, mask, mixer):
    x = w["embed.weight"][ids]
    with mixer():
        x = torch.tanh(F.linear(x, w["mix.weight"], w["mix.bias"]))
    m = mask.float()[..., None]
    pooled = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    return F.linear(pooled, w["head.weight"], w["head.bias"]), pooled


class Toy(torch.nn.Module):
    def __init__(self, sizes):
        super().__init__()
        V, H = sizes["vocab_size"], sizes["hidden_size"]
        self.embed = torch.nn.Embedding(V, H)
        self.mix = torch.nn.Linear(H, H)
        self.head = torch.nn.Linear(H, 2)

    def forward(self, input_ids, attention_mask, deterministic=True, **kw):
        w = dict(self.named_parameters())
        logits, pooled = _logits(w, input_ids, attention_mask,
                                 lambda: span("mixer"))
        return PairClassifierOutput(logits=logits,
                                    probs=logits.softmax(-1)[:, 1],
                                    src_embeds=pooled, tgt_embeds=pooled)


def build(kind, sizes, dtype, seed, device, **overrides):
    model = Toy(sizes).to(device)
    weights.load_into(model, weights.make(param_shapes(sizes, kind), seed,
                                          device, is_norm_scale))
    return model


def one_tower_logits(w, sizes, batch, rows, total, precision="fp32"):
    return _logits(w, batch["input_ids"], batch["attention_mask"],
                   contextlib.nullcontext)[0]


def forward_flop(sizes, kind, rows, S):
    H = sizes["hidden_size"]
    return 2 * rows * S * H * H + 2 * rows * H * 2


def attention_record(sizes, mask, rate, backward, device):
    return {}
'''


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_family_is_files_alone(tmp_path):
    """A cell of a new model family, whose program opens a module span of
    its own, runs and is read from added files and manifest entries
    alone: the family, its configuration, a score workload, a mix and a
    reader."""
    root = tmp_path / "portbench"
    shutil.copytree(cells.PACKAGE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _hashes(root)
    bench = json.loads(cells.MANIFEST.read_text())
    added = {
        "families/toy.py": TOY_FAMILY,
        "configs/toy-mixer.json": json.dumps(
            {"name": "toy-mixer", "source": "https://example.org/toy",
             "reduced": [], "family": "toy", "dtype": "float32",
             "model": {"vocab_size": 64, "hidden_size": 16}}),
        "traffic/pairs-b4-s16.json": json.dumps(
            {"kind": "pairs", "rows": 4, "seq_len": 16, "min_len": 4,
             "pool": 3, "labels": False}),
        "workloads/toy-score.json": json.dumps(
            {"job": "score", "model": "one_tower", "trace_steps": 3,
             "check": {"requests": 4, "block_rows": 3,
                       "limits": {"prob_gap": 1e-6,
                                  "logodds_scatter": 1e-5}}}),
        "metrics/span_calls.py":
            "from portbench import spans\n\n\n"
            "def read(name, rec):\n"
            "    s = spans.of(rec)\n"
            "    return None if s is None else "
            "s['calls'].get(name.split('.')[2])\n"}
    for path, text in added.items():
        (root / path).write_text(text)
    bench["configs"].append({"name": "toy-mixer",
                             "source": "https://example.org/toy",
                             "file": "portbench/configs/toy-mixer.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy-score", "config": "toy-mixer",
                               "traffic": "pairs-b4-s16", "chips": 1,
                               "why": "a toy family's scoring"})
    for m in bench["end_to_end"]:
        if "large-score-s510" in m.get("workloads", []):
            m["workloads"].append("toy-score")
    bench["per_layer"].append({"name": "span_calls.toy.mixer", "unit": "1",
                               "better": "lower", "source": "program_span",
                               "layer": "model step",
                               "moves": "score_pairs_per_s",
                               "workloads": ["toy-score"]})
    c = cells.load("toy-score", bench, root)
    line = run.run_cell(c, 2 ** 31 + 11, 0.2, True, "cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0
    assert line["metrics"]["span_calls.toy.mixer"]["value"] == 1.0
    after = _hashes(root)
    assert {k: after[k] for k in before} == before
    assert {str(p) for p in set(after) - set(before)
            if "__pycache__" not in p.parts} == set(added)


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
