"""The ``Trainer``'s K-step chunks (``scan_steps``) against the JAX
``Trainer``, on the CPU.

The JAX ``Trainer`` runs full chunks of ``scan_steps`` steps in one
``lax.scan`` (the chunk lowered until it divides ``eval_every_steps``), the
remainder one step at a time, and logs the chunk's last loss when a chunk
end crosses a multiple of ``log_steps``.  The port runs the same chunks
step by step from one staged transfer a chunk, so it must log and evaluate
at the same steps with the same losses and end with the same parameters;
and any ``scan_steps`` must give it the parameters and optimizer state of
``scan_steps=1`` exactly.
"""

import json
import re

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TModel
from item_alignment_torch.config import OptimizerConfig as TOpt
from item_alignment_torch.config import TrainConfig as TTrain
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.data.bert_data import align_kwargs
from item_alignment_torch.data.datasets import ArrayDataset as TDataset
from item_alignment_torch.engine import train as ttrain
from item_alignment_torch.models import bert_legacy as tbl
from item_alignment_torch.models import text as ttext

jax = pytest.importorskip("jax")

from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.config import TrainConfig as JTrain  # noqa: E402
from item_alignment_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from item_alignment_tpu.engine import train as jtrain  # noqa: E402
from item_alignment_tpu.models import bert_legacy as jbl  # noqa: E402
from item_alignment_tpu.models import text as jtext  # noqa: E402
from test_torch_adversarial import ALPHA, EPS, _field_rows  # noqa: E402
from test_torch_bert_legacy import LENS, _jf, make_fields  # noqa: E402
from test_torch_bert_legacy import _configs as _bert_configs  # noqa: E402
from test_torch_bert_legacy import _port as _bert_port  # noqa: E402
from test_torch_text import _configs, _port  # noqa: E402
from test_torch_train import TINY, _learning_data, _pair_arrays  # noqa: E402

torch.set_num_threads(1)
B = 8  # the JAX side shards the batch over its 8 CPU devices
LR = 1e-3
OPT = dict(learning_rate=LR, total_steps=30, warmup_proportion=0.1)
LOSS_TOL = 1e-4
PARAM_TOL = 5e-6  # test_torch_train.py's Trainer tolerance
LOG_LINE = re.compile(r"^epoch (\d+) step (\d+) loss ")


class _LogLines:
    """Stands in for a train module's logger: keeps the (epoch, step) of
    each loss line."""

    def __init__(self):
        self.steps = []

    def info(self, msg, *args, **kw):
        m = LOG_LINE.match(msg)
        if m:
            self.steps.append((int(m.group(1)), int(m.group(2))))

    def warning(self, *args, **kw):
        pass


def _train_losses(log_dir):
    rows = [json.loads(line) for line in open(log_dir / "scalars.jsonl")]
    return [(r["step"], r["value"]) for r in rows if r["tag"] == "train/loss"]


def _one_tower(n_rows, eval_rows):
    jcfg, tcfg = _configs()
    arrays = _pair_arrays(n_rows, jcfg.pair_seq_len, seed=21)
    valid = _pair_arrays(eval_rows, jcfg.pair_seq_len, seed=22) \
        if eval_rows else None
    jmodel = jtext.RobertaOneTower(jcfg)
    params, model = _port(ttext.RobertaOneTower, jmodel, tcfg,
                          arrays["input_ids"][:B],
                          arrays["attention_mask"][:B])
    return arrays, valid, jmodel, params, model, {}


def _free_bert(n_rows, eval_rows):
    jcfg, tcfg = _bert_configs()
    arrays = _field_rows(n_rows, seed=23)
    jmodel = jbl.BertAlignModel(jcfg)
    params, model = _bert_port(tbl.BertAlignModel, jmodel, tcfg,
                               _jf(make_fields(B, seed=23)))
    H = tcfg.hidden_size
    spec = {"pvs_noise": (LENS["pvs"], H), "title_noise": (LENS["title"], H)}
    return arrays, None, jmodel, params, model.train(), dict(
        batch_transform=align_kwargs, adversarial=("FREE", EPS, ALPHA),
        noise_spec=spec)


# (steps an epoch, scan_steps, log_steps, eval_every_steps, epochs, model,
#  the (epoch, step) of each loss line, the steps of the evals)
CASES = {
    # the chunk end at 4 crosses 3, 8 crosses 6, the remainder step 9
    # crosses 9; logging at steps % log_steps == 0 gives 3, 6, 9
    "11-steps-chunks-4-log-3": (11, 4, 3, None, 1, _one_tower,
                                [(0, 4), (0, 8), (0, 9)], []),
    # 6 % 4 lowers the chunk to 3: chunk ends 3, 6, 9, then 10 and 11
    "eval-every-6-lowers-chunk-to-3": (11, 4, 4, 6, 1, _one_tower,
                                       [(0, 6), (0, 9)], [6]),
    "scan-steps-1": (11, 1, 3, None, 1, _one_tower,
                     [(0, 3), (0, 6), (0, 9)], []),
    "two-epochs-default-8": (11, 8, 3, None, 2, _one_tower,
                             [(0, 8), (0, 9), (1, 8), (1, 9)], []),
    "free-adversarial-chunks-4-log-2": (7, 4, 2, None, 1, _free_bert,
                                        [(0, 4), (0, 6)], []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_chunks_log_evaluate_and_train_as_jax(case, tmp_path, monkeypatch):
    (steps, scan, log, every, epochs, build, logged,
     evals) = CASES[case]
    arrays, valid, jmodel, params, model, extra = build(
        steps * B, 2 * B if every else 0)
    common = dict(seed=3, train_batch_size=B, eval_batch_size=B,
                  log_steps=log, scan_steps=scan, eval_every_steps=every)
    lines = {"jax": _LogLines(), "port": _LogLines()}
    monkeypatch.setattr(jtrain, "logger", lines["jax"])
    monkeypatch.setattr(ttrain, "logger", lines["port"])
    jt = jtrain.Trainer(jmodel, JTrain(optimizer=JOpt(**OPT), **common),
                        params=params["params"], log_dir=str(tmp_path / "j"),
                        **extra)
    tt = ttrain.Trainer(model, TTrain(optimizer=TOpt(**OPT), **common),
                        device="cpu", log_dir=str(tmp_path / "t"), **extra)
    outs = {"jax": [], "port": []}
    for epoch in range(epochs):
        outs["jax"].append(jt.train_epoch(
            JDataset(arrays), epoch, JDataset(valid) if valid else None))
        outs["port"].append(tt.train_epoch(
            TDataset(arrays), epoch, TDataset(valid) if valid else None))

    assert lines["jax"].steps == lines["port"].steps == logged
    jl, tl = _train_losses(tmp_path / "j"), _train_losses(tmp_path / "t")
    assert [s for s, _ in jl] == [s for s, _ in tl] == [
        e * steps + s for e, s in logged]
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl],
                               rtol=0, atol=LOSS_TOL)
    for jo, to in zip(outs["jax"], outs["port"]):
        assert jo["steps"] == to["steps"] == steps
        np.testing.assert_allclose(to["loss"], jo["loss"], rtol=0,
                                   atol=LOSS_TOL)
        jm, tm = jo.get("mid_evals", []), to.get("mid_evals", [])
        assert [m["step"] for m in jm] == [m["step"] for m in tm] == evals
        np.testing.assert_allclose([m["best_f1"] for m in tm],
                                   [m["best_f1"] for m in jm], rtol=0,
                                   atol=1e-6)

    ours = model.state_dict()
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params}))
    assert ours.keys() == theirs.keys()
    n_steps = steps * epochs
    for name, p in ours.items():
        if name.endswith("attention.key.bias"):
            # zero gradient in exact arithmetic (softmax ignores a shift
            # shared by all keys): both sides move it by fp32 noise that
            # Adam scales up, so each stays within the steps' learning rate
            for x in (p.numpy(), theirs[name].numpy()):
                assert np.abs(x).max() <= n_steps * LR, name
            continue
        np.testing.assert_allclose(p.numpy(), theirs[name].numpy(), rtol=0,
                                   atol=PARAM_TOL, err_msg=name)
    for name, d in (tt.deltas or {}).items():
        np.testing.assert_allclose(d.numpy(), np.asarray(jt.state.deltas[name]),
                                   rtol=0, atol=PARAM_TOL, err_msg=name)


def _equal(a, b) -> bool:
    """Nested state (dicts, lists, tensors, numbers) equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _dropout_one_tower():
    cfg = TModel(**{**TINY, "hidden_dropout_prob": 0.1,
                    "attention_probs_dropout_prob": 0.1})
    model = ttext.RobertaOneTower(cfg, device="cpu", seed=0)
    return model, _learning_data(n=11 * B).arrays, {}


def _mix_bert():
    _, tcfg = _bert_configs(hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1)
    model = tbl.BertAlignModel(tcfg, device="cpu", seed=0)
    H = tcfg.hidden_size
    return model, _field_rows(11 * B, seed=24), dict(
        batch_transform=align_kwargs, adversarial=("MIX", EPS, ALPHA),
        noise_spec={"pvs_noise": (LENS["pvs"], H),
                    "title_noise": (LENS["title"], H)})


@pytest.mark.parametrize("build", [_dropout_one_tower, _mix_bert],
                         ids=["dropout-one-tower", "mix-adversarial"])
def test_any_scan_steps_gives_the_per_step_state_exactly(build):
    """11 steps with dropout 0.1 at scan_steps 4 and 1: the same losses,
    parameters, optimizer state and deltas, bit for bit (each step keeps
    its own dropout seed and noise draws inside a chunk)."""
    runs = []
    for scan in (4, 1):
        model, arrays, extra = build()
        trainer = ttrain.Trainer(
            model, TTrain(seed=5, train_batch_size=B, log_steps=1,
                          scan_steps=scan, optimizer=TOpt(**OPT)),
            device="cpu", **extra)
        out = trainer.train_epoch(TDataset(arrays), 0)
        runs.append((out["loss"], model.state_dict(),
                     trainer.optimizer.state_dict(), trainer.deltas,
                     trainer.step))
    assert runs[0][4] == runs[1][4] == 11
    assert runs[0][0] == runs[1][0]
    for a, b, what in zip(runs[0][1:4], runs[1][1:4],
                          ("parameters", "optimizer state", "deltas")):
        assert _equal(a, b), what
