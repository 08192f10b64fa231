"""``ia-torch`` vs ``ia-tpu`` for the legacy BERT member and TextCNN, on
the CPU.

- ``pred-bert``: a tiny 12-head ``BertAlignModel`` is initialised in JAX and
  saved as msgpack for ``ia-tpu pred-bert``; the test converts it with
  ``convert.state_dict_from_flax`` and saves a ``.pt`` for ``ia-torch
  pred-bert``.  The two prediction files agree: the pair ids exactly, the
  probabilities within 1e-4.
- ``bert-pretrain`` then ``finetune-bert --pretrained_model_path``: the
  5-token-type pretrain table overlays the 4-type align model's first rows;
  the outputs (``bert_align.pt``, ``sim_eval_weight.npz``, ``best_f1.pt``)
  are written; the JAX CLI's ``bert_pretrain.msgpack`` and
  ``bert_align.msgpack`` are read as their ``.pt``; a malformed msgpack and
  a row that fills the position table are refused.
- ``finetune-text --model_name textcnn``: the JAX CLI trains a tiny TextCNN
  and the port evaluates and predicts with its converted weights within
  1e-4 (the tests/test_torch_cli.py recipe).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from item_alignment_torch import cli as tcli
from item_alignment_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from item_alignment_torch.engine.checkpoint import load_params, save_params

pytest.importorskip("transformers")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu import cli as jcli  # noqa: E402
from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.data import bert_data as jbd  # noqa: E402
from item_alignment_tpu.data.tokenization import (  # noqa: E402
    load_text_tokenizer as j_tokenizer,
)
from item_alignment_tpu.engine.checkpoint import (  # noqa: E402
    save_params as jsave,
)
from item_alignment_tpu.models.bert_legacy import BertAlignModel  # noqa: E402
from test_torch_bert_data import ITEMS, VOCAB, _rows  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
TINY = {"hidden_size": 96, "num_hidden_layers": 1, "num_attention_heads": 12,
        "intermediate_size": 128, "max_position_embeddings": 512,
        "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _json_lines(out):
    return [json.loads(line) for line in out.strip().splitlines()
            if line.startswith("{")]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return _json_lines(buf.getvalue())


def _short_rows():
    """tests/test_torch_bert_data.py's rows with its truncated pvs pair cut
    to three pvs strings: a pair that fills all 512 tokens is refused (see
    ``test_finetune_bert_refuses_a_msgpack_and_a_full_row``)."""
    rows = _rows()
    rows[3]["src_pvs"] = " ; ".join([ITEMS[3]["item_pvs"]] * 3)
    return rows


def _write_jsonl(path, rows):
    path.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n"
                            for r in rows), encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_cli")
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    (d / "tiny.json").write_text(json.dumps(TINY))
    rows = _short_rows()
    _write_jsonl(d / "train.jsonl", rows * 2)
    _write_jsonl(d / "test.jsonl", [{k: v for k, v in r.items()
                                     if k != "item_label"} for r in rows])
    _write_jsonl(d / "item_info.jsonl",
                 [dict(it, item_id=f"i{i}") for i, it in enumerate(ITEMS)])
    return d


def _common(d):
    return ["--vocab_path", str(d / "vocab"), "--config_file",
            str(d / "tiny.json")]


def test_pred_bert_matches_ia_tpu(legacy, tmp_path):
    """Both CLIs score the test rows with the same weights (batch 2, so a
    padded last batch): the same rows and thresholds, probabilities within
    1e-4, each ``softmax(logits)[:, 1]``."""
    d = legacy
    tok = j_tokenizer(str(d / "vocab"))
    cfg = JConfig.from_json(str(d / "tiny.json"), model_name="bert_legacy",
                            vocab_size=len(tok))
    rows = [dict(r, item_label=0) for r in _short_rows()]
    first = jbd.pairs_to_field_dataset(rows[:2], tok).arrays
    first.pop("labels")
    fields = {k: {kk: jnp.asarray(v) for kk, v in f.items()}
              for k, f in jbd.unflatten_fields(first).items()}
    params = jax.jit(BertAlignModel(cfg).init)(
        {"params": jax.random.PRNGKey(3)}, fields)
    jsave(str(tmp_path / "bert_align.msgpack"), params)
    save_params(str(tmp_path / "bert_align.pt"), state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    argv = ["pred-bert", "--test_file", str(d / "test.jsonl"),
            "--batch_size", "2", "--threshold", "0.3", *_common(d)]
    ref = _run(jcli.main, argv + ["--params", str(tmp_path /
                                                  "bert_align.msgpack"),
                                  "--output", str(tmp_path / "j.jsonl")])
    got = _run(tcli.main, argv + ["--params", str(tmp_path / "bert_align.pt"),
                                  "--output", str(tmp_path / "t.jsonl"),
                                  "--device", "cpu"])
    assert got[-1]["pairs"] == ref[-1]["pairs"] == 5
    ours = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    theirs = [json.loads(line) for line in open(tmp_path / "j.jsonl")]
    strip = [("src_item_id", "tgt_item_id", "src_item_emb", "threshold")]
    for keys in strip:
        assert [[r[k] for k in keys] for r in ours] == \
            [[r[k] for k in keys] for r in theirs]
    p_ours = np.array([float(r["tgt_item_emb"].strip("[]")) for r in ours])
    p_theirs = np.array([float(r["tgt_item_emb"].strip("[]"))
                         for r in theirs])
    np.testing.assert_allclose(p_ours, p_theirs, rtol=0, atol=TOL)
    assert len(set(p_ours.round(6))) > 1


@pytest.fixture(scope="module")
def pretrained(legacy):
    out = legacy / "pre"
    res = _run(tcli.main, ["bert-pretrain", "--item_info",
                           str(legacy / "item_info.jsonl"), "--output_dir",
                           str(out), "--max_seq_len", "30", "--batch_size",
                           "4", "--learning_rate", "1e-3", "--seed", "1",
                           "--device", "cpu", *_common(legacy)])
    assert np.isfinite(res[-1]["final_loss"]) and res[-1]["examples"] >= 8
    return out


def test_bert_pretrain_writes_a_five_type_backbone(pretrained):
    state = load_params(str(pretrained / "bert_pretrain.pt"))
    assert state["bert.post.token_type_embeddings.weight"].shape == (5, 96)
    assert state["mlm_bias"].shape == (len(set(VOCAB)),)  # the vocab size
    assert not any("decoder" in k for k in state)
    assert state["mlm_bias"].abs().max() > 0  # it trained


@pytest.mark.parametrize("adversarial", ["MIX", "FREE", "PGD"])
def test_finetune_bert_from_the_pretrain(legacy, pretrained, tmp_path,
                                         adversarial):
    """At learning rate 0 the align model's backbone is the pretrain's (the
    first 4 of its 5 token-type rows); the noise runs; the three files are
    written and ``sim_eval_weight.npz`` is the NSP head's margin."""
    out = tmp_path / "ft"
    res = _run(tcli.main, [
        "finetune-bert", "--train_file", str(legacy / "train.jsonl"),
        "--valid_file", str(legacy / "train.jsonl"), "--output_dir", str(out),
        "--pretrained_model_path", str(pretrained), "--batch_size", "4",
        "--epochs", "1", "--learning_rate", "0", "--adversarial",
        adversarial, "--device", "cpu", *_common(legacy)])
    assert np.isfinite(res[-1]["final_loss"]) and "best_f1" in res[-1]
    pre = load_params(str(pretrained / "bert_pretrain.pt"))
    align = load_params(str(out / "bert_align.pt"))
    assert (out / "best_f1.pt").exists()
    for name, value in align.items():
        if name == "bert.post.token_type_embeddings.weight":
            assert value.shape == (4, 96)
            assert torch.equal(value, pre[name][:4])
        elif name.startswith("bert."):
            assert torch.equal(value, pre[name]), name
    w = np.load(out / "sim_eval_weight.npz")
    head_w = align["seq_relationship.weight"].numpy()
    head_b = align["seq_relationship.bias"].numpy()
    assert np.array_equal(w["weight"], head_w[1] - head_w[0])
    assert np.array_equal(w["bias"], head_b[1] - head_b[0])


def test_finetune_bert_refuses_a_msgpack_and_a_full_row(legacy, pretrained,
                                                        tmp_path):
    """A Flax ``bert_pretrain.msgpack`` (the JAX CLI's file, alone in its
    directory) loads as its ``.pt`` does; a malformed one raises a
    ``ValueError`` that names it; a row that fills the position table is
    refused before any work."""
    argv = ["finetune-bert", "--train_file", str(legacy / "train.jsonl"),
            "--output_dir", str(tmp_path / "o"), "--batch_size", "4",
            "--epochs", "1", "--device", "cpu", *_common(legacy)]
    pre = load_params(str(pretrained / "bert_pretrain.pt"))
    (tmp_path / "mp").mkdir()
    jsave(str(tmp_path / "mp" / "bert_pretrain.msgpack"),
          flax_from_state_dict(pre)["params"])
    _run(tcli.main, argv[:4] + [str(tmp_path / "mp_out")] + argv[5:] + [
        "--learning_rate", "0", "--pretrained_model_path",
        str(tmp_path / "mp")])
    align = load_params(str(tmp_path / "mp_out" / "bert_align.pt"))
    for name, value in align.items():
        if name.startswith("bert.") and "token_type" not in name:
            assert torch.equal(value, pre[name]), name
    (tmp_path / "bad.msgpack").write_bytes(b"\xc1")
    with pytest.raises(ValueError, match="bad.msgpack"):
        tcli.main(argv + ["--pretrained_model_path",
                          str(tmp_path / "bad.msgpack")])
    rows = _short_rows()
    rows[2]["src_pvs"] = " ".join(["颜"] * 600)  # fills all 512 tokens
    bad = _write_jsonl(tmp_path / "bad.jsonl", rows)
    with pytest.raises(ValueError, match="row 2 of pvs_input_ids holds 512"):
        tcli.main(argv[:2] + [bad] + argv[3:])
    assert not (tmp_path / "o").exists()


def test_pred_bert_reads_the_jax_msgpack(legacy, tmp_path):
    """``pred-bert --params bert_align.msgpack`` (predict.sh's file) gives
    the probabilities of its converted ``.pt``, bit for bit."""
    d = legacy
    tok = j_tokenizer(str(d / "vocab"))
    cfg = JConfig.from_json(str(d / "tiny.json"), model_name="bert_legacy",
                            vocab_size=len(tok))
    rows = [dict(r, item_label=0) for r in _short_rows()]
    first = jbd.pairs_to_field_dataset(rows[:2], tok).arrays
    first.pop("labels")
    fields = {k: {kk: jnp.asarray(v) for kk, v in f.items()}
              for k, f in jbd.unflatten_fields(first).items()}
    params = jax.jit(BertAlignModel(cfg).init)(
        {"params": jax.random.PRNGKey(5)}, fields)
    jsave(str(tmp_path / "bert_align.msgpack"), params)
    save_params(str(tmp_path / "bert_align.pt"), state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    argv = ["pred-bert", "--test_file", str(d / "test.jsonl"),
            "--batch_size", "2", "--device", "cpu", *_common(d)]
    for ext in ("msgpack", "pt"):
        _run(tcli.main, argv + ["--params", str(tmp_path / f"bert_align.{ext}"),
                                "--output", str(tmp_path / f"{ext}.jsonl")])
    assert (tmp_path / "msgpack.jsonl").read_text() == \
        (tmp_path / "pt.jsonl").read_text()


def test_cli_raises_for_distributed_legacy_runs(legacy, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 #4"):
        tcli.main(["finetune-bert", "--train_file",
                   str(legacy / "train.jsonl"), "--output_dir",
                   str(tmp_path), "--device", "cpu", "--distributed",
                   *_common(legacy)])


TEXTCNN = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
           "intermediate_size": 64, "max_position_embeddings": 64,
           "num_filters": 8, "model_name": "textcnn",
           "hidden_dropout_prob": 0.0}


@pytest.fixture(scope="module")
def textcnn(tmp_path_factory):
    pytest.importorskip("jieba")
    from test_torch_cli import VOCAB as CLI_VOCAB
    from test_torch_prepare import write_corpus

    d = tmp_path_factory.mktemp("textcnn_cli")
    write_corpus(d / "raw")
    (d / "vocab").mkdir()
    (d / "vocab" / "vocab.txt").write_text("\n".join(CLI_VOCAB),
                                           encoding="utf-8")
    (d / "textcnn.json").write_text(json.dumps(TEXTCNN))
    assert tcli.main(["prepare", "--data_dir", str(d / "raw"),
                      "--output_dir", str(d / "processed"),
                      "--valid_proportion", "0.3"]) == 0
    return d


def _textcnn_flags(d, out, *extra):
    return ["finetune-text", "--data_dir", str(d / "processed"),
            "--output_dir", str(d / out), "--vocab_path", str(d / "vocab"),
            "--model_name", "textcnn", "--config_file",
            str(d / "textcnn.json"), "--interaction_type", "two_tower",
            "--max_seq_len", "8", "--max_seq_len_pv", "8",
            "--train_batch_size", "8", "--eval_batch_size", "8", *extra]


def test_finetune_text_textcnn_matches_ia_tpu(textcnn):
    """The JAX CLI trains one epoch and evaluates and predicts; the port,
    given the converted ``best_f1.msgpack``, gives the same best F1 and
    threshold and the same prediction file (the probability columns as
    the embeds) within 1e-4; then the port trains a TextCNN itself."""
    from flax import serialization

    d = textcnn
    ref = _run(jcli.main, _textcnn_flags(d, "jax_out", "--epochs", "1",
                                         "--learning_rate", "1e-3",
                                         "--do_train", "--do_eval",
                                         "--do_pred"))
    run = d / "jax_out" / "textcnn-v1-two_tower-cls-NA-ce"
    with open(run / "best_f1.msgpack", "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    save_params(str(d / "textcnn.pt"), state_dict_from_flax({"params": tree}))
    got = _run(tcli.main, _textcnn_flags(d, "torch_out", "--do_eval",
                                         "--do_pred", "--device", "cpu",
                                         "--file_state_dict",
                                         str(d / "textcnn.pt")))
    ev, ref_ev = ([o for o in x if "sweep" in o][-1] for x in (got, ref))
    assert abs(ev["best_f1"] - ref_ev["best_f1"]) <= TOL
    pred, ref_pred = ([o for o in x if "prediction_file" in o][-1]
                      for x in (got, ref))

    def probs(path):
        rows = [json.loads(line) for line in open(path)]
        return rows, np.array([[float(r["src_item_emb"].strip("[]")),
                                float(r["tgt_item_emb"].strip("[]"))]
                               for r in rows])

    rows, p = probs(pred["prediction_file"])
    ref_rows, ref_p = probs(ref_pred["prediction_file"])
    assert [(r["src_item_id"], r["tgt_item_id"]) for r in rows] == \
        [(r["src_item_id"], r["tgt_item_id"]) for r in ref_rows]
    np.testing.assert_allclose(p, ref_p, rtol=0, atol=TOL)
    np.testing.assert_allclose(p.sum(1), 1.0, rtol=0, atol=1e-6)
    trained = _run(tcli.main, _textcnn_flags(d, "torch_train", "--epochs",
                                             "1", "--do_train", "--device",
                                             "cpu"))
    assert "best" in trained[-1]
