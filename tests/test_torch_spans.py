"""The port's spans (``engine/observability.py``): off they do nothing; on
they nest as the step runs, carry the step's index, change no arithmetic
and sit on the profiler's clock; ``profile_trace`` carries their ranges."""

import contextlib
import json
import statistics

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from item_alignment_torch.config import (
    ModelConfig,
    OptimizerConfig,
    TrainConfig,
)
from item_alignment_torch.engine import observability as obs
from item_alignment_torch.engine.inference import (
    TwoTowerInference,
    two_tower_encode_fn,
    two_tower_head_fn,
)
from item_alignment_torch.engine.train import Trainer
from item_alignment_torch.models import RobertaOneTower, RobertaTwoTower

torch.set_num_threads(1)

ROWS = 4


def _config(**kw):
    return ModelConfig(hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=64,
                       vocab_size=128, max_position_embeddings=64,
                       max_seq_len=6, max_seq_len_pv=2, dtype="bfloat16",
                       **kw)


def _trainer(seed=0):
    model = RobertaOneTower(_config(), device="cpu", seed=seed)
    return Trainer(model, TrainConfig(
        seed=1, train_batch_size=ROWS, eval_batch_size=ROWS,
        optimizer=OptimizerConfig(fused=True)), device="cpu").setup()


def _batch(step=0, labels=True):
    rng = np.random.default_rng(step)
    S = 2 * _config().pair_seq_len
    out = {"input_ids": rng.integers(5, 100, (ROWS, S)),
           "attention_mask": np.ones((ROWS, S), np.int64)}
    if labels:
        out["labels"] = np.array([0, 1, 1, 0])
    return out


def _mine_round():
    model = RobertaTwoTower(_config(interaction_type="two_tower"),
                            device="cpu", seed=0).eval()
    inf = TwoTowerInference(two_tower_encode_fn(model),
                            two_tower_head_fn(model), batch_size=ROWS,
                            device="cpu")
    ids = torch.randint(5, 100, (2 * ROWS, 8))
    mask = torch.ones_like(ids)
    inf.build_cache([str(i) for i in range(2 * ROWS)],
                    ({"input_ids": ids[s:s + ROWS],
                      "attention_mask": mask[s:s + ROWS]}
                     for s in (0, ROWS)))
    return inf.score_pairs(np.arange(ROWS), np.arange(ROWS, 2 * ROWS))


def _counted(monkeypatch):
    calls = {"record_function": 0, "clock": 0}
    rf, clock = obs.record_function, obs.clock_ns

    def record_function(name):
        calls["record_function"] += 1
        return rf(name)

    def counted_clock():
        calls["clock"] += 1
        return clock()

    monkeypatch.setattr(obs, "record_function", record_function)
    monkeypatch.setattr(obs, "clock_ns", counted_clock)
    return calls


def test_off_records_nothing(monkeypatch):
    calls = _counted(monkeypatch)
    tr = _trainer()
    tr.train_step(_batch())
    tr._eval_outputs(_batch(labels=False))
    _mine_round()
    assert calls == {"record_function": 0, "clock": 0}
    assert obs.span("step") is obs.span("layernorm")
    with obs.tracing() as record:
        tr.train_step(_batch())
    assert calls["clock"] == 2 * len(record.spans) > 0
    assert calls["record_function"] == 0  # no profiler ran


def test_step_spans_nest_and_carry_the_index():
    tr = _trainer()
    tr.train_step(_batch())
    with obs.tracing() as record:
        tr.train_step(_batch(1))
    step = next(s for s in record.spans if s.name == "step")
    assert step.index == 1 and step.parent is None
    inside = [s for s in record.spans if s.parent is not None
              and s.start_ns >= step.start_ns]
    assert {s.index for s in inside} == {1}
    top = [s.name for s in inside if s.parent is step]
    assert top == ["forward", "backward", "optim"]
    forward = next(s for s in inside if s.name == "forward")

    def under(s, ancestor):
        while s is not None and s is not ancestor:
            s = s.parent
        return s is ancestor

    names = {s.name for s in inside if under(s, forward)}
    assert {"embeddings", "layernorm", "dropout", "cast", "attention",
            "gelu"} <= names
    for s in record.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns <= s.end_ns \
                <= s.parent.end_ns
    stage = [s for s in record.spans if s.name == "stage"]
    assert len(stage) == 1 and stage[0].end_ns <= step.start_ns


def test_tracing_changes_no_arithmetic():
    runs = []
    for traced in (False, True):
        tr = _trainer(seed=3)
        losses = []
        with obs.tracing() if traced else contextlib.nullcontext(), \
                profile(activities=[ProfilerActivity.CPU]) if traced \
                else contextlib.nullcontext():
            for k in range(3):
                losses.append(tr.train_step(_batch(k)))
        runs.append((torch.stack(losses),
                     {n: p.detach().clone()
                      for n, p in tr.model.named_parameters()}))
    (l0, p0), (l1, p1) = runs
    assert torch.equal(l0, l1)
    assert p0.keys() == p1.keys()
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name


def test_spans_sit_on_the_profilers_clock():
    tr = _trainer()
    tr.train_step(_batch())
    with obs.tracing() as record, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_step(_batch())  # the first ranges of a session lag
        record.spans.clear()
        tr.train_step(_batch(1))
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("ia."):
            ranges.setdefault(e.name()[3:], []).append(e)
    gaps = []
    for name in {s.name for s in record.spans}:
        mine = [s for s in record.spans if s.name == name]
        theirs = sorted(ranges[name],
                        key=lambda e: e.start_ns())[-len(mine):]
        for s, e in zip(mine, theirs):
            gaps.append((s.start_ns - e.start_ns()) / 1e3)
            gaps.append((e.start_ns() + e.duration_ns() - s.end_ns) / 1e3)
    # each span reads the clock just inside its range, so on one clock no
    # end lies outside it (an offset of a few us would put some outside)
    # and the median end lies within 20 us of the range's; the thread can
    # be preempted between the range's stamp and the span's own, which on
    # a loaded machine delays a few reads by tens of us
    assert len(gaps) == 2 * len(record.spans) > 50
    assert min(gaps) >= -5.0
    assert statistics.median(gaps) <= 20.0


def test_profile_trace_carries_the_ranges(tmp_path):
    tr = _trainer()
    with obs.profile_trace(str(tmp_path)):
        tr.train_step(_batch())
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"ia.step", "ia.forward", "ia.layernorm"} <= names
    assert obs._record is None
