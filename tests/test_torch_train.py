"""Training parity of the port against the JAX package, on the CPU.

Weights move from JAX to the port with ``state_dict_from_flax``.  At dropout
0 with ``deterministic=False`` the loss and every parameter's gradient must
agree with ``jax.grad``; the port's ``Trainer`` must follow the JAX
``Trainer`` (on the 8-device CPU mesh of ``tests/conftest.py``) step for
step; and a tiny pair task must be learned through the port's ``Trainer``
(loss below half its start, F1 > 0.9).
"""

import json

import numpy as np
import pytest
import torch

from item_alignment_torch.config import MeshConfig as TMesh
from item_alignment_torch.config import ModelConfig as TModel
from item_alignment_torch.config import OptimizerConfig as TOpt
from item_alignment_torch.config import TrainConfig as TTrain
from item_alignment_torch.convert import flax_from_state_dict, state_dict_from_flax
from item_alignment_torch.data.datasets import ArrayDataset as TDataset
from item_alignment_torch.engine import metrics as tmetrics
from item_alignment_torch.engine.train import Trainer as TTrainer
from item_alignment_torch.models import text as ttext

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.config import TrainConfig as JTrain  # noqa: E402
from item_alignment_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from item_alignment_tpu.engine import metrics as jmetrics  # noqa: E402
from item_alignment_tpu.engine.train import Trainer as JTrainer  # noqa: E402
from item_alignment_tpu.models import text as jtext  # noqa: E402
from test_torch_text import _configs, _ids, _port, _t  # noqa: E402

# tiny shapes and many small ops: one thread per test process keeps
# parallel test workers from oversubscribing the CPU
torch.set_num_threads(1)


def _grad_dict(model):
    return {n: p.grad.detach().numpy() for n, p in model.named_parameters()}


def _assert_grads_close(ours, jgrads, what):
    theirs = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert ours.keys() == theirs.keys()
    for name, g in ours.items():
        np.testing.assert_allclose(g, theirs[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{what} d{name}")


@pytest.mark.parametrize("method,cls_layers,cls_pool", [
    ("cls", (1,), "cat"),
    ("cls", (1, 2), "cat"),
    ("cls", (1, 2), "avg"),
    ("vec_sim", (1,), "cat"),
])
def test_one_tower_loss_and_grads_match_jax(method, cls_layers, cls_pool):
    # vec_sim scores one similarity per pair, so it takes the bce loss
    jcfg, tcfg = _configs(classification_method=method, cls_layers=cls_layers,
                          cls_pool=cls_pool,
                          loss_type="bce" if method == "vec_sim" else "ce")
    ids, mask = _ids(4, jcfg.pair_seq_len, seed=6)
    labels = np.array([0, 1, 1, 0], np.int32)
    jmodel = jtext.RobertaOneTower(jcfg)
    params, model = _port(ttext.RobertaOneTower, jmodel, tcfg, ids, mask)

    def loss_fn(p):
        return jmodel.apply(p, jnp.asarray(ids), jnp.asarray(mask),
                            labels=jnp.asarray(labels), deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)}).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = model(_t(ids), _t(mask), labels=_t(labels), deterministic=False,
                dropout_seed=0)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(loss), rtol=0, atol=1e-4)
    _assert_grads_close(_grad_dict(model), grads, f"{method}/{cls_layers}")


def test_two_tower_loss_and_grads_match_jax():
    jcfg, tcfg = _configs(interaction_type="two_tower")
    S = jcfg.item_seq_len
    ids1, mask1 = _ids(3, S, seed=7)
    ids2, mask2 = _ids(3, S, seed=8)
    labels = np.array([1, 0, 1], np.int32)
    jmodel = jtext.RobertaTwoTower(jcfg)
    params, model = _port(ttext.RobertaTwoTower, jmodel, tcfg, ids1, ids2,
                          mask1, mask2)

    def loss_fn(p):
        return jmodel.apply(p, *(jnp.asarray(x) for x in (ids1, ids2, mask1,
                                                          mask2)),
                            labels=jnp.asarray(labels), deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)}).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = model(_t(ids1), _t(ids2), _t(mask1), _t(mask2), labels=_t(labels),
                deterministic=False, dropout_seed=0)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(loss), rtol=0, atol=1e-4)
    _assert_grads_close(_grad_dict(model), grads, "two-tower")


def _pair_arrays(n, S, seed, vocab=200):
    ids, mask = _ids(n, S, seed)
    labels = np.random.RandomState(seed).randint(0, 2, n).astype(np.int32)
    return {"input_ids": ids.astype(np.int32), "attention_mask": mask,
            "labels": labels}


def test_trainer_matches_jax_trainer_for_3_steps():
    """3 steps at dropout 0, batch 8 (the JAX side shards it over its 8 CPU
    devices), one batch per epoch.  Losses agree within 1e-4.  Parameters
    agree within 5e-6: the key biases' gradient is zero in exact arithmetic
    (softmax ignores a shift shared by all keys), so both sides hold only
    fp32 noise there, which Adam (eps 1e-8) scales up toward lr; those move
    apart by ~1e-6, while the other parameters agree to ~1e-7."""
    jcfg, tcfg = _configs()
    B, S = 8, jcfg.pair_seq_len
    arrays = _pair_arrays(3 * B, S, seed=9)
    opt = dict(learning_rate=1e-3, total_steps=10, warmup_proportion=0.1)
    common = dict(seed=3, train_batch_size=B, eval_batch_size=B,
                  log_steps=1000, scan_steps=1)
    jmodel = jtext.RobertaOneTower(jcfg)
    params, model = _port(ttext.RobertaOneTower, jmodel, tcfg,
                          arrays["input_ids"][:B], arrays["attention_mask"][:B])
    jt = JTrainer(jmodel, JTrain(optimizer=JOpt(**opt), **common),
                  params=params["params"])
    tt = TTrainer(model, TTrain(optimizer=TOpt(**opt), **common), device="cpu")
    for epoch in range(3):
        rows = {k: v[epoch * B:(epoch + 1) * B] for k, v in arrays.items()}
        jl = jt.train_epoch(JDataset(rows), epoch)["loss"]
        tl = tt.train_epoch(TDataset(rows), epoch)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4,
                                   err_msg=f"step {epoch}")
    ours = state_dict_from_flax(flax_from_state_dict(model.state_dict()))
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params}))
    for name, p in ours.items():
        np.testing.assert_allclose(p.numpy(), theirs[name].numpy(), rtol=0,
                                   atol=5e-6, err_msg=name)
    rows = {k: v[:B] for k, v in arrays.items()}
    np.testing.assert_allclose(tt.evaluate(TDataset(rows))["probs"],
                               jt.evaluate(JDataset(rows))["probs"],
                               rtol=0, atol=1e-4)


TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, vocab_size=50, max_seq_len=4,
            max_seq_len_pv=4, max_position_embeddings=64)


def _learning_data(seed=0, n=32):
    """The tiny learning task: tgt copies src for positive pairs."""
    cfg = TModel(**TINY)
    rng = np.random.RandomState(seed)
    S = cfg.pair_seq_len
    src = rng.randint(5, 25, (n, S // 2))
    tgt = src.copy()
    neg = rng.rand(n) < 0.5
    tgt[neg] = rng.randint(5, 25, (neg.sum(), S // 2))
    return TDataset({"input_ids": np.concatenate([src, tgt], 1).astype(np.int32),
                     "attention_mask": np.ones((n, S), np.int32),
                     "labels": (~neg).astype(np.int32)},
                    meta={"src_item_id": [f"s{i}" for i in range(n)],
                          "tgt_item_id": [f"t{i}" for i in range(n)]})


@pytest.fixture(scope="module")
def learned():
    cfg = TModel(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                 **TINY)
    ds = _learning_data()
    trainer = TTrainer(
        ttext.RobertaOneTower(cfg, device="cpu", seed=0),
        TTrain(train_batch_size=32, eval_batch_size=16, num_epochs=60,
               log_steps=1000, optimizer=TOpt(learning_rate=1e-3,
                                              total_steps=60,
                                              warmup_proportion=0.0,
                                              weight_decay=1e-4)),
        device="cpu")
    result = trainer.fit(ds)
    return trainer, ds, result


def test_trainer_learns(learned):
    """The tiny learning task through the port's Trainer:
    loss below half its start and F1 > 0.9."""
    trainer, ds, result = learned
    losses = [h["loss"] for h in result["history"]]
    assert losses[-1] < 0.5 * losses[0], losses
    assert trainer.evaluate(ds)["best_f1"] > 0.9


def test_trainer_eval_and_predict(learned, tmp_path):
    trainer, ds, _ = learned
    ev = trainer.evaluate(ds.select(np.arange(19)))  # a padded tail batch
    assert len(ev["probs"]) == 19 and len(ev["sweep"]) == 9
    path = trainer.predict_jsonl(ds, str(tmp_path / "pred.jsonl"),
                                 threshold=0.4)
    rows = [json.loads(line) for line in open(path)]
    assert len(rows) == len(ds) and rows[0]["src_item_id"] == "s0"
    assert rows[0]["threshold"] == 0.4
    p = float(rows[0]["tgt_item_emb"].strip("[]").split(",")[0])
    assert 0.0 <= p <= 1.0


def test_dropout_training_is_reproducible():
    """Two runs with dropout 0.1 and one seed give bitwise equal losses;
    the step seed is a function of (config.seed, step) alone."""
    def run():
        cfg = TModel(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                     **TINY)
        trainer = TTrainer(ttext.RobertaOneTower(cfg, device="cpu", seed=0),
                           TTrain(train_batch_size=8, eval_batch_size=8,
                                  num_epochs=1, eval_every_steps=2),
                           device="cpu")
        ds = _learning_data(n=24)
        out = trainer.train_epoch(ds, 0, valid_ds=ds)
        return [trainer.train_step(b)[()].item()
                for b, _ in ds.batches(8)] + [out["loss"]], out

    a, out = run()
    b, _ = run()
    assert a == b and len(set(a)) > 1
    assert [m["step"] for m in out["mid_evals"]] == [2]


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=TMesh(data=2)), "launch 2 processes"),
    (dict(mesh=TMesh(fsdp=2)), "launch 2 processes"),
])
def test_trainer_raises_on_what_is_not_ported(kw, match):
    """A mesh of more devices than processes raises (the port runs one
    process per device: parallel/mesh.py), before any work."""
    model = ttext.RobertaOneTower(TModel(**TINY), device="cpu", seed=0)
    with pytest.raises(ValueError, match=match):
        TTrainer(model, TTrain(**kw), device="cpu")
    # adversarial training is ported (engine/adversarial.py): it builds,
    # with zero deltas of the noise spec's shapes
    trainer = TTrainer(model, TTrain(train_batch_size=2), device="cpu",
                       adversarial=("FREE", 1.0, 1.0),
                       noise_spec={"noise": (3, 32)})
    assert trainer.deltas["noise"].shape == (2, 3, 32)
    assert not trainer.deltas["noise"].any()


def test_metrics_match_jax():
    rs = np.random.RandomState(5)
    labels = rs.randint(0, 2, 200)
    probs = np.clip(labels * 0.3 + rs.rand(200) * 0.7, 0, 1)
    thresholds = tuple(round(0.1 * i, 1) for i in range(1, 10))
    assert (tmetrics.threshold_sweep(labels, probs, thresholds)
            == jmetrics.threshold_sweep(labels, probs, thresholds))
    assert (tmetrics.find_best_f1_and_threshold(labels, probs)
            == jmetrics.find_best_f1_and_threshold(labels, probs))
    assert (tmetrics.precision_recall_f1(labels, probs > 0.5)
            == jmetrics.precision_recall_f1(labels, probs > 0.5))
