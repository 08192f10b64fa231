"""``ia-torch pkgm-pretrain`` and ``finetune-text --model_name pkgm_tiny``
on the tests/test_cli.py corpus, on the CPU, against ``ia-tpu``.

``prepare`` writes the KG files and the finetune TSVs.  ``pkgm-pretrain``
trains TransE, and PKGM with ``--do_eval`` (filtered link prediction on a
few train facts carved out as validation).  The JAX CLI trains a tiny PKGM
one-tower and two-tower; their ``best_f1.msgpack`` files are read with
flax, converted and saved as ``.pt``, and the port's CLI must reproduce the
JAX CLI's evaluation and prediction file on them within 1e-4.  With a
``pytorch_model.bin`` and a ``pkgm_model.bin`` under
``--pretrained_model_path`` both CLIs load the same merged encoder.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from item_alignment_torch import cli as tcli
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.engine.checkpoint import load_params, save_params

pytest.importorskip("jieba")
pytest.importorskip("transformers")
from flax import serialization  # noqa: E402

from item_alignment_tpu import cli as jcli  # noqa: E402
from test_torch_cli import VOCAB  # noqa: E402
from test_torch_hf_import import hf_state_dict  # noqa: E402
from test_torch_prepare import write_corpus  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
TINY = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 4,
        "intermediate_size": 64, "max_position_embeddings": 64,
        "kg_embedding_dim": 16, "hidden_dropout_prob": 0.0}
RUN = "pkgm_tiny-v1-{}-cls-NA-ce"


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    """Leave torch's global generator as this module found it."""
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _json_lines(text):
    return [json.loads(line) for line in text.strip().splitlines()
            if line.startswith("{")]


def _quiet(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0, argv
    return _json_lines(buf.getvalue())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pkgm_cli")
    write_corpus(tmp / "raw")
    (tmp / "vocab").mkdir()
    (tmp / "vocab" / "vocab.txt").write_text("\n".join(VOCAB),
                                             encoding="utf-8")
    (tmp / "tiny.json").write_text(json.dumps(TINY))
    _quiet(tcli.main, ["prepare", "--data_dir", str(tmp / "raw"),
                       "--output_dir", str(tmp / "processed"),
                       "--valid_proportion", "0.3"])
    return tmp


def _flags(corpus, out, *extra):
    p = corpus / "processed"
    return ["finetune-text", "--data_dir", str(p),
            "--output_dir", str(corpus / out),
            "--vocab_path", str(corpus / "vocab"),
            "--model_name", "pkgm_tiny",
            "--config_file", str(corpus / "tiny.json"),
            "--entity2id", str(p / "entity2id.txt"),
            "--relation2id", str(p / "relation2id.txt"),
            "--max_seq_len", "8", "--max_pvs", "3",
            "--train_batch_size", "8", "--eval_batch_size", "8",
            "--threshold", "0.4", *extra]


def _pred_probs(path):
    """The rows and their [src, tgt] embeddings: the two probabilities of a
    one-tower, the two CLS vectors of a two-tower."""
    rows = [json.loads(line) for line in open(path)]
    return rows, np.array([[[float(x) for x in r[k].strip("[]").split(",")]
                            for k in ("src_item_emb", "tgt_item_emb")]
                           for r in rows])


@pytest.fixture(scope="module", params=["one_tower", "two_tower"])
def jax_run(request, corpus):
    """The JAX CLI's train + eval + predict run; with one epoch the
    evaluated parameters are the ones saved in best_f1.msgpack."""
    kind = request.param
    lines = _quiet(jcli.main, _flags(
        corpus, f"jax_{kind}", "--interaction_type", kind, "--epochs", "1",
        "--learning_rate", "1e-3", "--do_train", "--do_eval", "--do_pred"))
    run = corpus / f"jax_{kind}" / RUN.format(kind)
    with open(run / "best_f1.msgpack", "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    pt = corpus / f"{kind}.pt"
    save_params(str(pt), state_dict_from_flax({"params": tree}))
    return {"kind": kind, "pt": str(pt),
            "eval": [o for o in lines if "sweep" in o][-1],
            "pred": [o for o in lines if "prediction_file" in o][-1]}


def test_finetune_pkgm_eval_and_pred_match_jax(corpus, jax_run):
    kind = jax_run["kind"]
    lines = _quiet(tcli.main, _flags(
        corpus, f"torch_{kind}", "--interaction_type", kind, "--do_eval",
        "--do_pred", "--device", "cpu", "--file_state_dict", jax_run["pt"]))
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


@pytest.mark.parametrize("kind", ["one_tower", "two_tower"])
def test_finetune_pkgm_trains_evaluates_and_predicts(corpus, kind):
    """The port's own ``--do_train --do_eval --do_pred`` run writes its
    parameter files and a prediction for every test pair."""
    lines = _quiet(tcli.main, _flags(
        corpus, f"own_{kind}", "--interaction_type", kind, "--epochs", "2",
        "--learning_rate", "1e-3", "--do_train", "--do_eval", "--do_pred",
        "--device", "cpu"))
    run = corpus / f"own_{kind}" / RUN.format(kind)
    state = load_params(str(run / "best_f1.pt"))
    assert state["roberta.embeddings.ent_emb.weight"].shape[1] == 16
    assert (run / "text_finetune_epoch-2.pt").exists()
    assert "best" in lines[0] and 0.0 <= lines[1]["best_f1"] <= 1.0
    rows, probs = _pred_probs(lines[-1]["prediction_file"])
    assert len(rows) == 4 and np.isfinite(probs).all()


def test_pkgm_needs_the_kg_maps(corpus):
    argv = _flags(corpus, "no_maps", "--do_train", "--device", "cpu")
    i = argv.index("--entity2id")
    del argv[i: i + 2]
    with pytest.raises(ValueError, match="--entity2id and --relation2id"):
        tcli.main(argv)


@pytest.fixture(scope="module")
def pretrained(corpus):
    """``pytorch_model.bin`` of the tiny encoder and a ``pkgm_model.bin``
    whose tables fit prepare's KG maps."""
    d = corpus / "pretrained"
    d.mkdir()
    p = corpus / "processed"
    n_ent = 1 + max(int(line.rsplit("\t", 1)[1]) for line in
                    open(p / "entity2id.txt") if line.strip())
    n_rel = 1 + max(int(line.rsplit("\t", 1)[1]) for line in
                    open(p / "relation2id.txt") if line.strip())
    sd = hf_state_dict(seed=5, vocab_size=len(VOCAB), num_hidden_layers=1,
                       prefix="roberta.")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               d / "pytorch_model.bin")
    rs = np.random.RandomState(6)
    kg = {"ent_emb.weight": rs.randn(n_ent, 16), "rel_emb.weight":
          rs.randn(n_rel, 16), "proj_mat.weight": rs.randn(16, 16)}
    torch.save({k: torch.from_numpy(v.astype(np.float32))
                for k, v in kg.items()}, d / "pkgm_model.bin")
    return d, kg


def test_pretrained_pkgm_merge_matches_jax(corpus, pretrained):
    """At learning rate 0 the saved parameters are the loaded ones: the
    port's encoder and KG tables equal the JAX CLI's, and the KG tables
    equal pkgm_model.bin's."""
    d, kg = pretrained
    flags = ("--do_train", "--epochs", "1", "--learning_rate", "0",
             "--pretrained_model_path", str(d))
    _quiet(jcli.main, _flags(corpus, "jax_pre", *flags))
    _quiet(tcli.main, _flags(corpus, "torch_pre", *flags, "--device", "cpu"))
    with open(corpus / "jax_pre" / RUN.format("one_tower") /
              "best_f1.msgpack", "rb") as f:
        theirs = state_dict_from_flax({"params": serialization.
                                       msgpack_restore(f.read())})
    ours = load_params(str(corpus / "torch_pre" / RUN.format("one_tower") /
                           "best_f1.pt"))
    from item_alignment_torch.utils.hf_import import (
        convert_pkgm_state_dicts,
        load_torch_state_dict,
    )

    loaded = ["roberta." + k for k in convert_pkgm_state_dicts(
        load_torch_state_dict(str(d / "pytorch_model.bin")),
        load_torch_state_dict(str(d / "pkgm_model.bin")))]
    assert len(loaded) == 5 + 16 + 3  # embeddings, one layer, KG tables
    for k in loaded:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k].numpy(), k)
    for table in ("ent_emb", "rel_emb", "proj_mat"):
        np.testing.assert_array_equal(
            ours[f"roberta.embeddings.{table}.weight"].numpy(),
            kg[f"{table}.weight"].astype(np.float32), table)


def _pretrain(corpus, out, *extra):
    return ["pkgm-pretrain", "--data_dir", str(corpus / "processed"),
            "--output_dir", str(corpus / out), "--embedding_dim", "16",
            "--batch_size", "16", "--device", "cpu", *extra]


def test_pkgm_pretrain_transe(corpus):
    out = _quiet(tcli.main, _pretrain(corpus, "kge", "--model_name",
                                      "transe", "--epochs", "3"))[-1]
    assert set(out) == {"final_loss"} and np.isfinite(out["final_loss"])
    with np.load(corpus / "kge" / "kge_final.npz") as f:
        assert sorted(f.files) == ["ent_emb", "rel_emb"]
        assert f["ent_emb"].shape[1] == 16


def test_pkgm_pretrain_do_eval(corpus, tmp_path):
    """--do_eval ranks valid2id.txt's facts among all entities; prepare
    writes an empty valid split, so a few train facts are carved out."""
    import shutil

    data = tmp_path / "kg"
    shutil.copytree(corpus / "processed", data)
    train = (data / "train2id.txt").read_text().strip("\n").splitlines()
    (data / "valid2id.txt").write_text("\n".join(train[:5]) + "\n")
    out = _quiet(tcli.main, [
        "pkgm-pretrain", "--data_dir", str(data), "--output_dir",
        str(tmp_path / "out"), "--model_name", "pkgm", "--embedding_dim",
        "16", "--batch_size", "16", "--epochs", "2", "--do_eval",
        "--device", "cpu"])[-1]
    assert 0.0 < out["mrr"] <= 1.0 and 0.0 <= out["hit10"] <= 1.0
    with np.load(tmp_path / "out" / "kge_final.npz") as f:
        assert sorted(f.files) == ["ent_emb", "proj_mat", "rel_emb"]


def test_pkgm_pretrain_mesh_raises_with_the_roadmap_item(corpus):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 #4: Parallelism"):
        tcli.main(_pretrain(corpus, "kge_mesh", "--epochs", "1", "--mesh",
                            "2,1,1"))
