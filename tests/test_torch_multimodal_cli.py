"""``ia-torch prepare --with_image``, ``finetune-multimodal``, ``ensemble``
and ``model-soup`` on the tests/test_cli.py corpus, on the CPU, against
``ia-tpu``.

An ``image_embedding.json`` of 24 floats an item (``json.dump`` of Python
floats, so its text is not the TSVs' ``%.9g`` form) is read by both CLIs'
``prepare --with_image``.  The JAX CLI trains tiny RobertaImage models
(``begin`` and ``end`` one-tower, ``begin`` two-tower); their
``best_f1.msgpack`` files are read with flax, converted and saved as
``.pt``, and the port's CLI must reproduce the JAX CLI's evaluation and
prediction file on them within 1e-4.  ``ensemble`` and ``model-soup`` must
write what ``ia-tpu`` writes from the same inputs.
"""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch

from item_alignment_torch import cli as tcli
from item_alignment_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from item_alignment_torch.data import native_loader as tnative
from item_alignment_torch.data.prepare import read_tsv
from item_alignment_torch.engine.checkpoint import load_params, save_params

pytest.importorskip("jieba")
pytest.importorskip("transformers")
from flax import serialization  # noqa: E402

from item_alignment_tpu import cli as jcli  # noqa: E402
from item_alignment_tpu.data import native_loader  # noqa: E402
from test_torch_cli import VOCAB  # noqa: E402
from test_torch_prepare import write_corpus  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
I = 24  # image_hidden_size
TINY = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
        "intermediate_size": 64, "max_position_embeddings": 64,
        "hidden_dropout_prob": 0.0}
RUN = "roberta_image_tiny-v1-{}-cls-{}-ce"


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    """Leave torch's global generator as this module found it."""
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _quiet(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0, argv
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def _embedding_json(path, n_items=30, seed=0):
    rs = np.random.RandomState(seed)
    with open(path, "w", encoding="utf-8") as w:
        json.dump({f"i{i}": [float(x) for x in rs.randn(I).astype(np.float32)]
                   for i in range(n_items)}, w)


def _prepare(main, raw, out, image_json):
    out.mkdir(parents=True)
    shutil.copy(image_json, out / "image_embedding.json")
    return _quiet(main, ["prepare", "--data_dir", str(raw), "--output_dir",
                         str(out), "--valid_proportion", "0.3",
                         "--with_image", "--cv_model_name", "eca_nfnet_l0"])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mm_cli")
    write_corpus(tmp / "raw")
    (tmp / "vocab").mkdir()
    (tmp / "vocab" / "vocab.txt").write_text("\n".join(VOCAB),
                                             encoding="utf-8")
    (tmp / "tiny.json").write_text(json.dumps(TINY))
    _embedding_json(tmp / "image_embedding.json")
    _prepare(tcli.main, tmp / "raw", tmp / "processed",
             tmp / "image_embedding.json")
    return tmp


def _tsvs(d):
    return {name: (d / name).read_bytes() for name in
            ("finetune_train_train.tsv", "finetune_train_valid.tsv",
             "finetune_test.tsv")}


@pytest.mark.parametrize("native", [False, True])
def test_prepare_with_image_matches_jax(corpus, tmp_path, native,
                                        monkeypatch):
    """The TSVs of both CLIs are equal byte for byte.  With the native span
    scan both keep the file's own array text (``json.dump``'s ``", "`` made
    ``","``); where both scans are refused, both read the file with
    ``json.load`` and write ``%.9g`` text."""
    ours_dir = corpus / "processed"
    if native:
        if native_loader.get_lib() is None:
            pytest.skip("native/ia_data.cpp does not build here")
    else:
        monkeypatch.setattr(native_loader, "read_embedding_spans",
                            lambda path: None)
        monkeypatch.setattr(tnative, "read_embedding_spans",
                            lambda path: None)
        ours_dir = tmp_path / "torch"
        _prepare(tcli.main, corpus / "raw", ours_dir,
                 corpus / "image_embedding.json")
    _prepare(jcli.main, corpus / "raw", tmp_path / "jax",
             corpus / "image_embedding.json")
    ours, theirs = _tsvs(ours_dir), _tsvs(tmp_path / "jax")
    rows = read_tsv(str(ours_dir / "finetune_train_train.tsv"))
    assert len(rows) == 10 and {len(r) for r in rows} == {9}
    assert ours == theirs
    raw = json.loads((corpus / "image_embedding.json").read_text())
    for r in rows:
        for iid, col in ((r[1], r[4]), (r[5], r[8])):
            vec = np.asarray(raw[iid], np.float32)
            np.testing.assert_array_equal(
                np.asarray(col.split(","), np.float32), vec)
            own = ",".join(map(repr, raw[iid]))
            assert (col == own) == native, (col, own)


def _flags(corpus, out, *extra):
    return ["finetune-multimodal", "--data_dir", str(corpus / "processed"),
            "--output_dir", str(corpus / out),
            "--vocab_path", str(corpus / "vocab"),
            "--model_name", "roberta_image_tiny",
            "--config_file", str(corpus / "tiny.json"),
            "--image_hidden_size", str(I),
            "--max_seq_len", "6", "--max_seq_len_pv", "6",
            "--train_batch_size", "8", "--eval_batch_size", "8",
            "--threshold", "0.4", *extra]


def _pred_probs(path):
    rows = [json.loads(line) for line in open(path)]
    return rows, np.array([[[float(x) for x in r[k].strip("[]").split(",")]
                            for k in ("src_item_emb", "tgt_item_emb")]
                           for r in rows])


RUNS = [("begin", "one_tower"), ("end", "one_tower"), ("begin", "two_tower")]


@pytest.fixture(scope="module", params=RUNS, ids=lambda r: "-".join(r))
def jax_run(request, corpus):
    """The JAX CLI's train + eval + predict run; with one epoch the
    evaluated parameters are the ones saved in best_f1.msgpack."""
    ensemble, kind = request.param
    flags = ["--ensemble", ensemble, "--interaction_type", kind]
    lines = _quiet(jcli.main, _flags(
        corpus, f"jax_{ensemble}_{kind}", *flags, "--epochs", "1",
        "--learning_rate", "1e-3", "--do_train", "--do_eval", "--do_pred"))
    run = corpus / f"jax_{ensemble}_{kind}" / RUN.format(kind, ensemble)
    with open(run / "best_f1.msgpack", "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    pt = corpus / f"{ensemble}_{kind}.pt"
    save_params(str(pt), state_dict_from_flax({"params": tree}))
    return {"flags": flags, "pt": str(pt), "run": run,
            "eval": [o for o in lines if "sweep" in o][-1],
            "pred": [o for o in lines if "prediction_file" in o][-1]}


def test_finetune_multimodal_eval_and_pred_match_jax(corpus, jax_run):
    lines = _quiet(tcli.main, _flags(
        corpus, "torch_eval", *jax_run["flags"], "--do_eval", "--do_pred",
        "--device", "cpu", "--file_state_dict", jax_run["pt"]))
    ev = [o for o in lines if "sweep" in o][-1]
    ref = jax_run["eval"]
    assert abs(ev["best_f1"] - ref["best_f1"]) <= TOL
    assert abs(ev["best_threshold"] - ref["best_threshold"]) <= TOL
    pred = [o for o in lines if "prediction_file" in o][-1]
    assert pred["prediction_split"] == jax_run["pred"]["prediction_split"] \
        == "test"
    rows, probs = _pred_probs(pred["prediction_file"])
    ref_rows, ref_probs = _pred_probs(jax_run["pred"]["prediction_file"])
    assert [(r["src_item_id"], r["tgt_item_id"]) for r in rows] == \
        [(r["src_item_id"], r["tgt_item_id"]) for r in ref_rows]
    assert len(rows) == 4
    np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=TOL)


@pytest.mark.parametrize("ensemble,kind", RUNS)
def test_finetune_multimodal_trains_and_writes_jax_files(corpus, ensemble,
                                                         kind):
    """The port's own ``--do_train --do_eval --do_pred`` run writes the
    JAX run's files with .pt for .msgpack, and a prediction for every test
    pair."""
    lines = _quiet(tcli.main, _flags(
        corpus, "own", "--ensemble", ensemble, "--interaction_type", kind,
        "--epochs", "2", "--learning_rate", "1e-3", "--do_train",
        "--do_eval", "--do_pred", "--device", "cpu"))
    run = corpus / "own" / RUN.format(kind, ensemble)
    state = load_params(str(run / "best_f1.pt"))
    key = ("head.classifier.dense_img.weight" if ensemble == "end"
           else "roberta.embeddings.img2txt.weight")
    assert state[key].shape[1] == (2 * I if ensemble == "end" else I)
    assert (run / "multimodal_finetune_epoch-2.pt").exists()
    assert "best" in lines[0] and 0.0 <= lines[1]["best_f1"] <= 1.0
    rows, _ = _pred_probs(lines[2]["prediction_file"])
    assert len(rows) == 4
    jax_files = {f"multimodal_finetune_epoch-1.msgpack", "best_f1.msgpack",
                 "hyperparamter.txt", "deepAI_result_threshold=0.4.jsonl"}
    assert {p.name.replace(".pt", ".msgpack").replace("-2.", "-1.")
            for p in run.iterdir()} == jax_files


@pytest.mark.parametrize("strategy", ["threshold", "f1"])
def test_ensemble_matches_jax(corpus, strategy):
    """Two members under ``<data_dir>/output``, one found by
    ``--input_file``, one only by its own threshold's file name:
    ``deepAI_result.jsonl`` equal byte for byte."""
    data = corpus / f"ens_{strategy}"
    rs = np.random.RandomState(3)
    for member, thr in (("text", 0.4), ("image", 0.45)):
        d = data / "output" / member
        d.mkdir(parents=True)
        with open(d / f"deepAI_result_threshold={thr}.jsonl", "w") as w:
            for i in range(12):
                p = float(rs.rand())
                w.write(json.dumps({
                    "src_item_id": f"i{i}", "src_item_emb": f"[{1 - p}]",
                    "tgt_item_id": f"i{i + 2}", "tgt_item_emb": f"[{p}]",
                    "threshold": thr}) + "\n")
    spec = json.dumps([["text", 0.4, 0.86], ["image", 0.45, 0.85]])
    outs = {}
    for name, main in (("torch", tcli.main), ("jax", jcli.main)):
        out = _quiet(main, ["ensemble", "--data_dir", str(data),
                            "--ensemble_strategy", strategy, "--models", spec,
                            "--output_dir", str(data / name)])
        assert out[-1]["pairs"] == 12
        outs[name] = open(out[-1]["output"], "rb").read()
    assert outs["torch"] == outs["jax"]
    with pytest.raises(FileNotFoundError):
        tcli.main(["ensemble", "--data_dir", str(data), "--ensemble_strategy",
                   strategy, "--models", json.dumps([["image", 0.5, 1.0]])])


def test_model_soup_matches_jax(corpus, jax_run, tmp_path):
    """The port's soup of two ``.pt`` files equals the JAX CLI's soup of the
    same two parameter sets as msgpack, converted, bit for bit."""
    a = load_params(jax_run["pt"])
    b = {k: v * 0.5 + 0.25 for k, v in a.items()}
    paths = [str(tmp_path / "a.pt"), str(tmp_path / "b.pt")]
    save_params(paths[1], b)
    shutil.copy(jax_run["pt"], paths[0])
    for path, state in zip(("a.msgpack", "b.msgpack"), (a, b)):
        with open(tmp_path / path, "wb") as f:
            f.write(serialization.msgpack_serialize(
                flax_from_state_dict(state)["params"]))
    _quiet(tcli.main, ["model-soup", "--checkpoints", *paths, "--output",
                       str(tmp_path / "soup.pt"), "--device", "cpu"])
    _quiet(jcli.main, ["model-soup", "--checkpoints",
                       str(tmp_path / "a.msgpack"), str(tmp_path / "b.msgpack"),
                       "--output", str(tmp_path / "soup.msgpack")])
    ours = load_params(str(tmp_path / "soup.pt"))
    with open(tmp_path / "soup.msgpack", "rb") as f:
        theirs = state_dict_from_flax(
            {"params": serialization.msgpack_restore(f.read())})
    assert ours.keys() == theirs.keys() == a.keys()
    for name, value in ours.items():
        assert torch.equal(value, theirs[name]), name
        assert torch.equal(value, (a[name] + b[name]) / 2.0), name
    # a JAX msgpack beside a .pt: the same soup
    _quiet(tcli.main, ["model-soup", "--checkpoints",
                       str(tmp_path / "a.msgpack"), paths[1], "--output",
                       str(tmp_path / "x.pt"), "--device", "cpu"])
    mixed = load_params(str(tmp_path / "x.pt"))
    assert all(torch.equal(mixed[k], ours[k]) for k in ours)
