"""``ia-torch build-graph`` and ``finetune-graph`` vs ``ia-tpu``, on the CPU.

On the tests/test_cli.py corpus (30 items, two categories, ``prepare``'s
``entity2id.txt``): ``build-graph``'s ``edges.npz`` arrays and pair files
equal the JAX CLI's, with and without ``--pad_to``; ``finetune-graph
--device cpu`` trains, evaluates and writes ``gcn_params.pt`` (one
layout, with ``--scan_layers`` or without), twice from one seed bit for bit; one Adam step of the port's
``gcn_train_step`` with dropout 0 agrees with ``optax.adam`` on the same
batch within 1e-5; and train.sh step 9's three command lines (``build-graph``,
``pred-text`` on the JAX CLI's ``best_f1.msgpack``, whose matrix equals
``ia-tpu pred-text``'s within 1e-4, and ``finetune-graph --edge_chunk
262144 --scan_layers``) run through ``cli.main``.
"""

import json

import numpy as np
import pytest
import torch

from item_alignment_torch import cli as tcli
from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.models.graph import GCNTwoTower

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from item_alignment_tpu import cli as jcli  # noqa: E402
from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.models.graph import GCNTwoTower as JGCN  # noqa: E402
from test_torch_cli import (  # noqa: E402,F401
    _keep_torch_rng,
    _run,
    corpus,
    hf_dir,
    jax_one_tower,
)
from test_torch_graph import N, graph_inputs  # noqa: E402

torch.set_num_threads(1)


def _build_argv(corpus, out, *extra):
    return ["build-graph", "--item_info",
            str(corpus / "raw" / "item_info.jsonl"), "--entity2id",
            str(corpus / "processed" / "entity2id.txt"), "--train_pairs",
            str(corpus / "raw" / "item_train_pair.jsonl"), "--output_dir",
            str(corpus / out), "--valid_proportion", "0.3", *extra]


@pytest.mark.parametrize("extra", [(), ("--pad_to", "512", "--seed", "5")])
def test_build_graph_files_equal_jax(corpus, capsys, extra):
    tag = "pad" if extra else "plain"
    ref = _run(jcli.main, _build_argv(corpus, f"jgraph_{tag}", *extra),
               capsys)[-1]
    got = _run(tcli.main, _build_argv(corpus, f"tgraph_{tag}", *extra),
               capsys)[-1]
    assert {k: v for k, v in got.items() if k != "edges"} == \
        {k: v for k, v in ref.items() if k != "edges"}
    assert got["n_items"] == 30 and got["n_edges"] > 0
    with np.load(got["edges"]) as a, np.load(ref["edges"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        if extra:
            assert a["edge_index"].shape[1] == 512
    for name in ("item_train_valid_pair.jsonl", "item_train_train_pair.jsonl"):
        assert (corpus / f"tgraph_{tag}" / name).read_bytes() == \
            (corpus / f"jgraph_{tag}" / name).read_bytes()


@pytest.fixture(scope="module")
def graph_dir(corpus):
    """build-graph's files and a random feature matrix of its nodes."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(_build_argv(corpus, "graph")) == 0
    d = corpus / "graph"
    n = int(np.load(d / "edges.npz")["n_nodes"])
    np.save(d / "feats.npy",
            np.random.RandomState(0).randn(n, 16).astype(np.float32))
    return d


def _finetune_argv(d, out, *extra):
    return ["finetune-graph", "--feature_matrix", str(d / "feats.npy"),
            "--edges", str(d / "edges.npz"), "--train_pairs",
            str(d / "item_train_train_pair.jsonl"), "--valid_pairs",
            str(d / "item_train_valid_pair.jsonl"), "--output_dir",
            str(d / out), "--gcn_hidden", "8", "--gcn_layers", "2",
            "--epochs", "3", "--batch_size", "4", "--device", "cpu", *extra]


@pytest.mark.parametrize("extra", [(), ("--scan_layers", "--edge_chunk",
                                        "64")], ids=["conv_l", "stacked"])
def test_finetune_graph_runs_and_repeats(graph_dir, capsys, extra):
    runs = []
    for k in range(2):
        out = _run(tcli.main, _finetune_argv(graph_dir, f"gcn{k}", *extra),
                   capsys)[-1]
        assert sorted(out) == ["best_f1", "best_threshold", "final_loss"]
        assert np.isfinite(out["final_loss"]) and 0 <= out["best_f1"] <= 1
        runs.append(torch.load(graph_dir / f"gcn{k}" / "gcn_params.pt",
                               weights_only=True))
    assert sorted(runs[0]) == sorted(runs[1])
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    # one layout whatever --scan_layers says: the stacked conv kernel
    assert runs[0]["encoder.conv.weight.weight"].shape == (2, 8, 8)
    cfg = TConfig(model_name="gcn", gcn_hidden=8, gcn_layers=2,
                  gcn_feature_dim=16)
    GCNTwoTower(cfg, device="cpu", seed=None).load_state_dict(runs[0])


def test_finetune_graph_without_a_gpu_raises(graph_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _finetune_argv(graph_dir, "nogpu") if a not in
            ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda|CUDA|GPU"):
        tcli.main(argv)


@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "conv_l"])
def test_one_adam_step_matches_optax(scan):
    from item_alignment_torch.ops.sparse import Adjacency

    g = graph_inputs(seed=4)
    kw = dict(model_name="gcn", gcn_hidden=8, gcn_layers=3,
              gcn_feature_dim=12, gcn_scan_layers=scan,
              gcn_sorted_edges=True, hidden_dropout_prob=0.0)
    jmodel = JGCN(JConfig(**kw))
    trans = tuple(map(jnp.asarray, g["trans"]))
    args = (jnp.asarray(g["feats"]), jnp.asarray(g["ei"]),
            jnp.asarray(g["ew"]), jnp.asarray(g["src"]),
            jnp.asarray(g["tgt"]))
    labels = jnp.asarray(g["labels"])
    params = jax.jit(lambda k: jmodel.init(
        {"params": k}, *args, labels=labels, edge_transpose=trans))(
        jax.random.PRNGKey(0))
    tx = optax.adam(1e-2)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(lambda p: jmodel.apply(
            p, *args, labels=labels, edge_transpose=trans).loss)(p)
        upd, _ = tx.update(grads, tx.init(p), p)
        return optax.apply_updates(p, upd), loss

    ref_params, ref_loss = step(params)

    model = GCNTwoTower(TConfig(**kw), device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    adj = Adjacency(g["ei"], g["ew"], N, None, g["trans"], device="cpu")
    t = {k: torch.from_numpy(g[k]).long() for k in ("src", "tgt", "labels")}
    loss = tcli.gcn_train_step(model, tcli.graph_adam(model, 1e-2),
                               torch.from_numpy(g["feats"]), adj, t["src"],
                               t["tgt"], t["labels"], dropout_seed=1)
    assert abs(float(loss) - float(ref_loss)) < 1e-5
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                      ref_params))
    for name, p in model.state_dict().items():
        assert float((p - ref[name]).abs().max()) < 1e-5, name


def test_train_sh_step_9_command_lines(corpus, jax_one_tower, hf_dir,
                                       capsys):
    """build-graph, pred-text with the JAX CLI's best_f1.msgpack (the
    matrix equals ia-tpu's), finetune-graph as train.sh step 9 runs them,
    at the tiny corpus's size."""
    g = corpus / "step9"
    _run(tcli.main, ["build-graph", "--item_info",
                     str(corpus / "raw" / "item_info.jsonl"), "--entity2id",
                     str(corpus / "processed" / "entity2id.txt"),
                     "--train_pairs",
                     str(corpus / "raw" / "item_train_pair.jsonl"),
                     "--output_dir", str(g), "--valid_proportion", "0.1"],
         capsys)

    def pred_text(main, out, *extra):
        return _run(main, [
            "pred-text", "--entity2id",
            str(corpus / "processed" / "entity2id.txt"),
            "--item_info", str(corpus / "raw" / "item_info.jsonl"),
            "--vocab_path", str(corpus / "vocab"),
            "--config_file", str(corpus / "tiny.json"),
            "--model_name", "roberta_tiny", "--max_seq_len", "12",
            "--num_workers", "0",
            "--pretrained_model_path", str(hf_dir),
            "--file_state_dict", str(jax_one_tower["dir"] / "best_f1.msgpack"),
            "--output", str(out), *extra], capsys)[-1]

    got = pred_text(tcli.main, g / "feature_matrix.npy", "--device", "cpu")
    ref = pred_text(jcli.main, corpus / "jax_feature_matrix.npy")
    np.testing.assert_allclose(np.load(got["output"]),
                               np.load(ref["output"]), rtol=0, atol=1e-4)
    out = _run(tcli.main, [
        "finetune-graph", "--feature_matrix", str(g / "feature_matrix.npy"),
        "--edges", str(g / "edges.npz"),
        "--train_pairs", str(g / "item_train_train_pair.jsonl"),
        "--valid_pairs", str(g / "item_train_valid_pair.jsonl"),
        "--edge_chunk", "262144", "--scan_layers",
        "--output_dir", str(g / "gcn"), "--epochs", "2", "--device", "cpu"],
        capsys)[-1]
    assert np.isfinite(out["final_loss"])
    assert (g / "gcn" / "gcn_params.pt").exists()
    assert json.loads(json.dumps(out))["best_threshold"] is not None
