"""``ia-torch coca-pretrain`` and the CoCa finetune vs the JAX package, on
the CPU.

A tiny CoCa (hidden 32, 2 text and ViT layers, 16 px images in 8 px
patches, a 2-deep decoder; dropout 0) on the tests/test_cli.py corpus, with
a JPEG a item:

- ``coca-pretrain --device cpu`` on uint8 shards: its loss and its saved
  parameters equal the JAX ``Trainer``'s, run from the port's initial
  weights converted to Flax, on the same arrays (losses within 1e-4,
  parameters within 5e-6, the key biases, whose gradient is zero in exact
  arithmetic, within the steps' learning rates).
- ``finetune-multimodal --model_name coca_tiny --images_dir`` with ``sum``
  and ``cross_attn``: ``ia-torch`` and ``ia-tpu`` train from one converted
  start (``--pretrained_model_path`` the pretrain's ``.msgpack``,
  ``--file_state_dict`` one converted tree), then evaluate and predict:
  best F1, threshold and predictions within 1e-4.
"""

import json

import numpy as np
import pytest
import torch

from item_alignment_torch import cli as tcli
from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from item_alignment_torch.models import multimodal as tmm

jax = pytest.importorskip("jax")
pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from item_alignment_tpu import cli as jcli  # noqa: E402
from item_alignment_tpu.config import MeshConfig as JMesh  # noqa: E402
from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.config import TrainConfig as JTrain  # noqa: E402
from item_alignment_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from item_alignment_tpu.engine.checkpoint import save_params as jsave  # noqa: E402
from item_alignment_tpu.engine.train import Trainer as JTrainer  # noqa: E402
from item_alignment_tpu.models import multimodal as jmm  # noqa: E402
from test_torch_cli import VOCAB, _keep_torch_rng, _run, corpus  # noqa: E402,F401
from test_torch_coca import TINY  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
COCA = {k: v for k, v in TINY.items()
        if k not in ("model_name", "max_seq_len", "max_seq_len_pv")}
COCA["vocab_size"] = len(VOCAB)


@pytest.fixture(scope="module")
def coca_dir(corpus):
    """The tiny config, uint8 pretrain shards and one JPEG an item."""
    d = corpus / "coca"
    (d / "images").mkdir(parents=True)
    (d / "coca_tiny.json").write_text(json.dumps(COCA))
    rs = np.random.RandomState(0)
    for i in range(30):
        Image.fromarray(rs.randint(0, 256, (20, 24, 3), np.uint8)).save(
            d / "images" / f"i{i}.jpg")
    for k in range(2):
        ids = rs.randint(5, len(VOCAB), (6, 12)).astype(np.int64)
        mask = np.ones_like(ids)
        ids[::2, 9:] = 0
        mask[::2, 9:] = 0
        np.savez(d / f"shard_{k}.npz", input_ids=ids, attention_mask=mask,
                 images=rs.randint(0, 256, (6, 16, 16, 3)).astype(np.uint8))
    return d


def _pretrain_argv(d, *extra):
    return ["coca-pretrain", "--shards", str(d / "shard_0.npz"),
            str(d / "shard_1.npz"), "--output_dir", str(d / "pre"),
            "--config_file", str(d / "coca_tiny.json"), "--batch_size", "4",
            "--epochs", "2", "--learning_rate", "1e-3", "--seed", "3",
            "--log_steps", "1", *extra,
            # the JAX CLI's width flags override the config file's
            *(f"--{k}={COCA[k]}" for k in (
                "vocab_size", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size",
                "multimodal_depth", "coca_heads", "image_size"))]


def test_coca_pretrain_matches_the_jax_trainer(coca_dir, capsys):
    out = _run(tcli.main, _pretrain_argv(coca_dir, "--device", "cpu"),
               capsys)[-1]
    ours = torch.load(coca_dir / "pre" / "coca_pretrain.pt",
                      weights_only=True)

    cfg_kw = dict(COCA, model_name="coca", dtype="float32")
    start = tmm.CoCaForPretraining(TConfig(**cfg_kw), device="cpu", seed=3)
    tree = flax_from_state_dict(start.state_dict(), num_heads=4)
    z = [np.load(coca_dir / f"shard_{k}.npz") for k in range(2)]
    arrays = {k: np.concatenate([s[k] for s in z]) for k in
              ("input_ids", "attention_mask", "images")}
    for k in ("input_ids", "attention_mask"):
        arrays[k] = arrays[k].astype(np.int32)
    jt = JTrainer(jmm.CoCaForPretraining(JConfig(**cfg_kw)), JTrain(
        seed=3, train_batch_size=4, eval_batch_size=4, num_epochs=2,
        log_steps=1, scan_steps=1, output_dir=str(coca_dir / "jpre"),
        mesh=JMesh(data=1, fsdp=1, tensor=1),
        optimizer=JOpt(learning_rate=1e-3, weight_decay=0.01,
                       warmup_proportion=0.1, total_steps=6)),
        params=tree["params"])
    ref = jt.fit(JDataset(arrays))
    assert abs(out["final_loss"] - ref["history"][-1]["loss"]) <= TOL
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params}))
    assert sorted(ours) == sorted(theirs)
    for name, p in ours.items():
        if name.endswith("key.bias"):
            # zero gradient in exact arithmetic (softmax ignores a shift
            # shared by all keys): both sides move it by fp32 noise that
            # Adam scales up, so each stays within the 6 steps' rates
            for x in (p.numpy(), theirs[name].numpy()):
                assert np.abs(x).max() <= 6 * 1e-3, name
            continue
        np.testing.assert_allclose(p.numpy(), theirs[name].numpy(), rtol=0,
                                   atol=5e-6, err_msg=name)
    # the pretrain file as the JAX CLI writes it, for the finetunes below
    jsave(str(coca_dir / "pre" / "coca_pretrain.msgpack"),
          {"params": flax_from_state_dict(ours, num_heads=4)["params"]})


def _finetune_argv(corpus, d, out, ensemble, *extra):
    return ["finetune-multimodal", "--data_dir", str(corpus / "processed"),
            "--output_dir", str(d / out), "--vocab_path",
            str(corpus / "vocab"), "--model_name", "coca_tiny",
            "--config_file", str(d / "coca_tiny.json"), "--images_dir",
            str(d / "images"), "--image_size", "16", "--ensemble", ensemble,
            "--max_seq_len", "6", "--max_seq_len_pv", "4",
            "--train_batch_size", "4", "--eval_batch_size", "4",
            "--epochs", "1", "--learning_rate", "1e-3", "--threshold", "0.4",
            "--pretrained_model_path",
            str(d / "pre" / "coca_pretrain.msgpack"),
            "--file_state_dict", str(d / f"start_{ensemble}.msgpack"),
            "--mesh", "1,1,1", "--do_train", "--do_eval", "--do_pred",
            *extra]


def _probs(path):
    return np.array([float(json.loads(line)["tgt_item_emb"].strip("[]"))
                     for line in open(path)])


@pytest.mark.parametrize("ensemble", ["sum", "cross_attn"])
def test_coca_finetune_matches_jax(corpus, coca_dir, capsys, ensemble):
    if not (coca_dir / "pre" / "coca_pretrain.msgpack").exists():
        test_coca_pretrain_matches_the_jax_trainer(coca_dir, capsys)
    cfg = TConfig(**dict(COCA, model_name="coca_tiny", ensemble=ensemble,
                         max_seq_len=6, max_seq_len_pv=4))
    start = tmm.CoCaForItemAlignment(cfg, device="cpu", seed=5)
    jsave(str(coca_dir / f"start_{ensemble}.msgpack"),
          flax_from_state_dict(start.state_dict(), num_heads=4)["params"])
    ref = _run(jcli.main, _finetune_argv(corpus, coca_dir, "jft", ensemble),
               capsys)
    got = _run(tcli.main, _finetune_argv(corpus, coca_dir, "tft", ensemble,
                                         "--device", "cpu"), capsys)
    ev, ref_ev = ([o for o in lines if "sweep" in o][-1]
                  for lines in (got, ref))
    assert abs(ev["best_f1"] - ref_ev["best_f1"]) <= TOL
    assert abs(ev["best_threshold"] - ref_ev["best_threshold"]) <= TOL
    pred, ref_pred = ([o for o in lines if "prediction_file" in o][-1]
                      for lines in (got, ref))
    assert pred["prediction_split"] == ref_pred["prediction_split"] == "test"
    a, b = _probs(pred["prediction_file"]), _probs(ref_pred["prediction_file"])
    assert len(a) == 4
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    run = coca_dir / "tft" / f"coca_tiny-v1-one_tower-cls-{ensemble}-ce"
    assert (run / "best_f1.pt").exists()
    assert (run / "multimodal_finetune_epoch-1.pt").exists()
