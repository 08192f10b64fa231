"""``ia-torch`` vs ``ia-tpu`` on the tests/test_cli.py corpus, on the CPU.

The JAX CLI trains a tiny one-tower and a tiny two-tower with
``finetune-text --do_train``; this test (and only it) reads their
``best_f1.msgpack`` with flax, converts them with
``convert.state_dict_from_flax`` and saves them with the port's
``save_params``.  The port's CLI, given those ``.pt`` files with
``--device cpu``, must then reproduce the JAX CLI's outputs on the msgpack
files within 1e-4: ``finetune-text``'s evaluation and prediction file,
``mine`` plain, with ``--cache_quant int8`` and with ``--quant int8``, and
``pred-text`` with and without ``--quant int8``, and at any
``--scan_chunks``.
"""

import csv
import json
import os
import random
import re

import numpy as np
import pytest
import torch

from item_alignment_torch import cli as tcli
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.engine.checkpoint import save_params

pytest.importorskip("jieba")
pytest.importorskip("transformers")
from flax import serialization  # noqa: E402

from item_alignment_tpu import cli as jcli  # noqa: E402
from test_torch_hf_import import hf_state_dict  # noqa: E402
from test_torch_prepare import write_corpus  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
VOCAB = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
         + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", ":", ";", "a", "b", "商", "品",
            "牌", "容", "量", "表", "带"] + [str(d) for d in range(10)] + ["<S>"])
TINY = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
        "intermediate_size": 64, "max_position_embeddings": 64,
        "hidden_dropout_prob": 0.0}
RUN = "roberta_tiny-v1-{}-cls-NA-ce"


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    """Leave torch's global generator as this module found it: building a
    model draws from it (``nn.Embedding``'s own init), and a later test
    file in the same worker may draw weights from it."""
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _json_lines(out):
    return [json.loads(line) for line in out.strip().splitlines()
            if line.startswith("{")]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return _json_lines(capsys.readouterr().out)


def _msgpack_to_pt(src, dst):
    with open(src, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    save_params(str(dst), state_dict_from_flax({"params": tree}))
    return str(dst)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    write_corpus(tmp / "raw")
    (tmp / "vocab").mkdir()
    (tmp / "vocab" / "vocab.txt").write_text("\n".join(VOCAB),
                                             encoding="utf-8")
    (tmp / "tiny.json").write_text(json.dumps(TINY))
    assert tcli.main(["prepare", "--data_dir", str(tmp / "raw"),
                      "--output_dir", str(tmp / "processed"),
                      "--valid_proportion", "0.3"]) == 0
    return tmp


def _flags(corpus, out, *extra):
    return ["finetune-text", "--data_dir", str(corpus / "processed"),
            "--output_dir", str(corpus / out),
            "--vocab_path", str(corpus / "vocab"),
            "--model_name", "roberta_tiny",
            "--config_file", str(corpus / "tiny.json"),
            "--max_seq_len", "8", "--max_seq_len_pv", "8",
            "--train_batch_size", "8", "--eval_batch_size", "8",
            "--threshold", "0.4", *extra]


@pytest.fixture(scope="module")
def jax_one_tower(corpus):
    """The JAX CLI's train + eval + predict run; with one epoch the
    evaluated parameters are the ones saved in best_f1.msgpack."""
    out = {}
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(_flags(corpus, "jax_out", "--epochs", "1",
                                "--learning_rate", "1e-3", "--do_train",
                                "--do_eval", "--do_pred", "--log_dir",
                                str(corpus / "jax_logs"))) == 0
    lines = _json_lines(buf.getvalue())
    out["eval"] = [o for o in lines if "sweep" in o][-1]
    out["pred"] = [o for o in lines if "prediction_file" in o][-1]
    run = corpus / "jax_out" / RUN.format("one_tower")
    out["dir"] = run
    out["pt"] = _msgpack_to_pt(run / "best_f1.msgpack", corpus / "one.pt")
    return out


@pytest.fixture(scope="module")
def jax_two_tower(corpus):
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        assert jcli.main(_flags(corpus, "jax_tt", "--epochs", "1",
                                "--interaction_type", "two_tower",
                                "--do_train")) == 0
    msgpack = corpus / "jax_tt" / RUN.format("two_tower") / "best_f1.msgpack"
    return msgpack, _msgpack_to_pt(msgpack, corpus / "two.pt")


def _pred_probs(path):
    rows = [json.loads(line) for line in open(path)]
    return rows, np.array([[float(r["src_item_emb"].strip("[]")),
                            float(r["tgt_item_emb"].strip("[]"))]
                           for r in rows])


def test_finetune_eval_and_pred_match_jax(corpus, jax_one_tower, capsys):
    lines = _run(tcli.main, _flags(corpus, "torch_out", "--do_eval",
                                   "--do_pred", "--device", "cpu",
                                   "--file_state_dict", jax_one_tower["pt"]),
                 capsys)
    ev = [o for o in lines if "sweep" in o][-1]
    ref = jax_one_tower["eval"]
    assert abs(ev["best_f1"] - ref["best_f1"]) <= TOL
    assert abs(ev["best_threshold"] - ref["best_threshold"]) <= TOL
    assert len(ev["sweep"]) == len(ref["sweep"])
    pred = [o for o in lines if "prediction_file" in o][-1]
    assert pred["prediction_split"] == jax_one_tower["pred"]["prediction_split"] \
        == "test"
    rows, probs = _pred_probs(pred["prediction_file"])
    ref_rows, ref_probs = _pred_probs(jax_one_tower["pred"]["prediction_file"])
    assert [(r["src_item_id"], r["tgt_item_id"], r["threshold"])
            for r in rows] == [(r["src_item_id"], r["tgt_item_id"],
                                r["threshold"]) for r in ref_rows]
    assert len(rows) == 4
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=TOL)


def _mine(corpus, state, out, *extra):
    raw = corpus / "raw"
    return ["mine", "--item_info", str(raw / "item_info.jsonl"),
            "--pairs", str(raw / "item_test_pair.jsonl"),
            "--output", str(corpus / out),
            "--vocab_path", str(corpus / "vocab"),
            "--model_name", "roberta_tiny",
            "--config_file", str(corpus / "tiny.json"),
            "--max_seq_len", "8", "--max_seq_len_pv", "8",
            "--batch_size", "4", "--num_workers", "0",
            "--file_state_dict", str(state), *extra]


@pytest.mark.parametrize("extra", [(), ("--cache_quant", "int8"),
                                   ("--quant", "int8"),
                                   ("--quant", "int8", "--cache_quant", "int8")])
def test_mine_matches_jax(corpus, jax_two_tower, capsys, extra):
    msgpack, pt = jax_two_tower
    tag = "_".join(extra) or "plain"
    ref = _run(jcli.main, _mine(corpus, msgpack, f"jmine{tag}.jsonl",
                                *extra), capsys)[-1]
    got = _run(tcli.main, _mine(corpus, pt, f"tmine{tag}.jsonl",
                                "--device", "cpu", *extra), capsys)[-1]
    assert (got["items"], got["pairs"]) == (ref["items"], ref["pairs"]) \
        == (5, 4)
    rows, probs = _pred_probs(got["output"])
    ref_rows, ref_probs = _pred_probs(ref["output"])
    assert [(r["src_item_id"], r["tgt_item_id"]) for r in rows] == \
        [(r["src_item_id"], r["tgt_item_id"]) for r in ref_rows]
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def hf_dir(corpus):
    """An HF checkpoint dir of the tiny encoder, pooler included."""
    d = corpus / "hf"
    d.mkdir()
    sd = hf_state_dict(seed=3, vocab_size=len(VOCAB), num_hidden_layers=1,
                       prefix="roberta.")
    rs = np.random.RandomState(4)
    sd["roberta.pooler.dense.weight"] = \
        (rs.randn(32, 32) * 0.05).astype(np.float32)
    sd["roberta.pooler.dense.bias"] = (rs.randn(32) * 0.05).astype(np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               d / "pytorch_model.bin")
    return d


@pytest.mark.parametrize("overlay,quant", [(False, False), (True, False),
                                           (True, True)])
def test_pred_text_matches_jax(corpus, jax_one_tower, hf_dir, capsys,
                               overlay, quant):
    def argv(out, state, *extra):
        a = ["pred-text", "--entity2id",
             str(corpus / "processed" / "entity2id.txt"),
             "--item_info", str(corpus / "raw" / "item_info.jsonl"),
             "--vocab_path", str(corpus / "vocab"),
             "--output", str(corpus / out),
             "--model_name", "roberta_tiny",
             "--config_file", str(corpus / "tiny.json"),
             "--max_seq_len", "12", "--batch_size", "16",
             "--scan_chunks", "2", "--num_workers", "0",
             "--pretrained_model_path", str(hf_dir), *extra]
        if overlay:
            a += ["--file_state_dict", str(state)]
        if quant:
            a += ["--quant", "int8"]
        return a

    tag = f"{overlay:d}{quant:d}"
    ref = _run(jcli.main, argv(f"j{tag}.npy",
                               jax_one_tower["dir"] / "best_f1.msgpack"),
               capsys)[-1]
    got = _run(tcli.main, argv(f"t{tag}.npy", jax_one_tower["pt"],
                               "--device", "cpu"), capsys)[-1]
    a, b = np.load(got["output"]), np.load(ref["output"])
    assert a.shape == b.shape == (len(open(
        corpus / "processed" / "entity2id.txt").readlines()), 32)
    assert a.dtype == np.float32 and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_pred_text_scan_chunks_and_xfer_guard(corpus, hf_dir, capsys):
    """``--scan_chunks 3`` pads the rows to full groups of 3·B and gives
    exactly the features of ``--scan_chunks 1``; both lie within 1e-5 of
    the JAX CLI's.  ``--xfer_guard`` is accepted on ``--device cpu``, where
    there is no host-to-device transfer to guard."""
    n = len(open(corpus / "processed" / "entity2id.txt").readlines())
    B = 4
    assert n > 3 * B and n % (3 * B)  # a padded tail group

    def argv(out, *extra):
        return ["pred-text", "--entity2id",
                str(corpus / "processed" / "entity2id.txt"),
                "--item_info", str(corpus / "raw" / "item_info.jsonl"),
                "--vocab_path", str(corpus / "vocab"),
                "--output", str(corpus / out),
                "--model_name", "roberta_tiny",
                "--config_file", str(corpus / "tiny.json"),
                "--max_seq_len", "12", "--batch_size", str(B),
                "--num_workers", "0", "--pretrained_model_path", str(hf_dir),
                "--xfer_guard", *extra]

    ref = np.load(_run(jcli.main, argv("jk3.npy", "--scan_chunks", "3"),
                       capsys)[-1]["output"])
    feats = {k: np.load(_run(tcli.main, argv(
        f"tk{k}.npy", "--scan_chunks", str(k), "--device", "cpu"),
        capsys)[-1]["output"]) for k in (3, 1)}
    assert feats[3].shape == (n, 32) and np.isfinite(feats[3]).all()
    np.testing.assert_array_equal(feats[3], feats[1])
    np.testing.assert_allclose(feats[1], ref, rtol=0, atol=1e-5)


def _learnable_corpus(d):
    """Pairs labelled by the first token of the source title ("a" -> 1,
    "b" -> 0): a signal a one-layer model picks up in a few dozen steps."""
    raw = d / "raw"
    raw.mkdir(parents=True)
    rng = random.Random(0)
    with open(raw / "item_info.jsonl", "w", encoding="utf-8") as w:
        for i in range(40):
            w.write(json.dumps({
                "item_id": f"i{i}", "cate_name": "coffee",
                "cate_id": "coffee", "industry_name": "ind",
                "title": f"{'ab'[i % 2]} {i % 10}",
                "item_pvs": f"品牌#:#{rng.choice('ab')}", "sku_pvs": ""},
                ensure_ascii=False) + "\n")
    with open(raw / "item_train_pair.jsonl", "w") as w:
        for _ in range(40):
            a, b = rng.sample(range(40), 2)
            w.write(json.dumps({"src_item_id": f"i{a}",
                                "tgt_item_id": f"i{b}",
                                "item_label": str(int(a % 2 == 0))}) + "\n")
    assert tcli.main(["prepare", "--data_dir", str(raw), "--output_dir",
                      str(d / "processed"), "--valid_proportion", "0.3"]) == 0
    return d


def test_port_finetune_learns_and_writes_jax_files(corpus, jax_one_tower,
                                                   capsys):
    """The port's own training run: the loss falls, and the run dir holds
    the JAX run's files with .pt for .msgpack; the log dir has the same
    CSV columns and scalar tags."""
    learn = _learnable_corpus(corpus / "learn")
    for name in ("vocab", "tiny.json"):
        os.symlink(corpus / name, learn / name)
    capsys.readouterr()
    epochs = 30
    lines = _run(tcli.main, _flags(
        learn, "torch_train", "--epochs", str(epochs), "--learning_rate",
        "3e-3", "--warmup_proportion", "0", "--log_steps", "1",
        "--do_train", "--do_eval", "--do_pred", "--device", "cpu",
        "--log_dir", str(corpus / "torch_logs")), capsys)
    assert "best" in lines[0] and lines[0]["best"]["best_f1"] > 0.9
    scalars = [json.loads(line) for line in
               open(corpus / "torch_logs" / "scalars.jsonl")]
    losses = [s["value"] for s in scalars if s["tag"] == "train/loss"]
    assert len(losses) == 3 * epochs and all(np.isfinite(losses))
    assert np.mean(losses[-9:]) < 0.5 * np.mean(losses[:9]), losses
    ref_tags = {json.loads(line)["tag"] for line in
                open(corpus / "jax_logs" / "scalars.jsonl")}
    assert {s["tag"] for s in scalars} == ref_tags | {"train/loss"}

    def header(d):
        with open(d / "eval_results.csv") as f:
            return next(csv.reader(f))

    assert header(corpus / "torch_logs") == header(corpus / "jax_logs")
    ours = os.listdir(learn / "torch_train" / RUN.format("one_tower"))
    ref = os.listdir(jax_one_tower["dir"])
    norm = {re.sub(r"epoch-\d+", "epoch-N", n.replace(".msgpack", ".pt"))
            for n in ref}
    assert {re.sub(r"epoch-\d+", "epoch-N", n) for n in ours} == norm
    assert f"text_finetune_epoch-{epochs}.pt" in ours


def test_quant_train_rejected(corpus):
    with pytest.raises(SystemExit):
        tcli.main(_flags(corpus, "torch_q", "--quant", "int8", "--do_train",
                         "--device", "cpu"))


def test_help_and_unknown_command(capsys):
    assert tcli.main([]) == 0
    assert "finetune-text" in capsys.readouterr().out
    assert tcli.main(["nope"]) == 2
    assert sorted(tcli.COMMANDS) == sorted(jcli.COMMANDS)


@pytest.mark.parametrize("cmd", ["finetune-text", "mine", "pred-text"])
def test_default_device_without_a_gpu_raises(corpus, monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"finetune-text": _flags(corpus, "torch_nogpu", "--do_eval"),
            "mine": _mine(corpus, corpus / "none.pt", "x.jsonl"),
            "pred-text": ["pred-text", "--entity2id", "e", "--item_info", "i",
                          "--vocab_path", "v", "--output", "o",
                          "--allow_random_weights"]}[cmd]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv)


def test_observability_and_retry_match_jax(tmp_path):
    """The CLI's helpers: format_time and the retry markers equal JAX's, a
    transient error is retried and any other raises at once, and
    profile_trace writes a torch.profiler trace."""
    from item_alignment_torch.engine import observability as tobs
    from item_alignment_torch.utils import retry as tretry
    from item_alignment_tpu.engine import observability as jobs
    from item_alignment_tpu.utils import retry as jretry

    for sec in (0, 59.4, 59.6, 3600, 86399.5):
        assert tobs.format_time(sec) == jobs.format_time(sec)
    assert tretry.TRANSIENT_MARKERS == jretry.TRANSIENT_MARKERS
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: relay restarting")
        return "done"

    assert tretry.retry_transient(flaky, attempts=4, wait=0.0) == "done"
    assert len(calls) == 3
    with pytest.raises(ValueError):
        tretry.retry_transient(lambda: (calls.append(1), int("x")),
                               attempts=4, wait=0.0)
    assert len(calls) == 4
    with tobs.profile_trace(None):
        pass
    with tobs.profile_trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_finetune_options_run(corpus, hf_dir, capsys):
    """--pretrained_model_path loads the HF encoder; vec_sim with the
    auxiliary task trains with --checkpoint_dir, and --resume continues
    from the latest checkpoint; --pred_with_best and --profile_dir run."""
    from item_alignment_torch.engine.checkpoint import load_params

    ckpt = corpus / "opts_ckpt"
    base = _flags(corpus, "torch_opts", "--classification_method", "vec_sim",
                  "--similarity_measure", "cosine", "--loss_type", "cosine",
                  "--auxiliary_task",
                  "--pretrained_model_path", str(hf_dir), "--device", "cpu",
                  "--learning_rate", "1e-3", "--log_steps", "1")
    run = corpus / "torch_opts" / \
        "roberta_tiny-v1-one_tower-vec_sim-cosine-cosine"
    _run(tcli.main, base + ["--epochs", "0", "--do_train"], capsys)
    sd = hf_state_dict(seed=3, vocab_size=len(VOCAB), num_hidden_layers=1,
                       prefix="roberta.")
    best = load_params(str(run / "best_f1.pt"))
    for ours, theirs in (("encoder.layer_0.attention.query.weight",
                          "encoder.layer.0.attention.self.query.weight"),
                         ("encoder.layer_0.mlp_output.bias",
                          "encoder.layer.0.output.dense.bias")):
        np.testing.assert_array_equal(best["roberta." + ours].numpy(),
                                      sd["roberta." + theirs])
    _run(tcli.main, base + ["--epochs", "2", "--do_train",
                            "--checkpoint_dir", str(ckpt)], capsys)
    assert sorted(p.name for p in ckpt.iterdir()
                  if p.name.startswith("step_")) == ["step_1.pt", "step_2.pt"]
    lines = _run(tcli.main, base + [
        "--epochs", "3", "--do_train", "--do_pred", "--pred_with_best",
        "--checkpoint_dir", str(ckpt), "--resume",
        "--profile_dir", str(corpus / "opts_trace")], capsys)
    assert "step_3.pt" in os.listdir(ckpt)
    assert np.isfinite(lines[0]["best"]["best_f1"])
    pred = [o for o in lines if "prediction_file" in o][-1]
    embs = [np.array(json.loads(line)["tgt_item_emb"].strip("[]").split(","),
                     float) for line in open(pred["prediction_file"])]
    # vec_sim writes the projected tgt vectors
    assert len(embs) == 4 and all(e.shape == (32,) and np.isfinite(e).all()
                                  for e in embs)
    assert (corpus / "opts_trace" / "trace.json").exists()
