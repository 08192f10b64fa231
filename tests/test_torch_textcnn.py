"""The port's TextCNN two-tower vs the JAX package's, on the CPU.

A tiny random JAX ``TextCNNTwoTower`` (hidden 32, filters (1, 2, 3, 5) of
8 channels) is converted with ``state_dict_from_flax``: the Flax Conv
kernel ``[K, 2H, F]`` becomes ``nn.Conv1d``'s ``[F, 2H, K]``.  Both take
the same ids with a pad tail, which the max pool reads as JAX's does.
fp32 results agree within 1e-4.  The second embedding table gets no
gradient (JAX: a zero gradient) and is still decayed by AdamW, as in JAX.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.config import OptimizerConfig as TOpt
from item_alignment_torch.config import TrainConfig as TTrain
from item_alignment_torch.convert import (
    flax_from_state_dict,
    flax_path,
    state_dict_from_flax,
)
from item_alignment_torch.data.datasets import ArrayDataset as TDataset
from item_alignment_torch.engine.optim import decay_mask
from item_alignment_torch.engine.train import Trainer as TTrainer
from item_alignment_torch.models import build_model
from item_alignment_torch.models import text as ttext

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.config import TrainConfig as JTrain  # noqa: E402
from item_alignment_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from item_alignment_tpu.engine.optim import decay_mask as jdecay  # noqa: E402
from item_alignment_tpu.engine.train import Trainer as JTrainer  # noqa: E402
from item_alignment_tpu.models import text as jtext  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
TINY = dict(model_name="textcnn", interaction_type="two_tower",
            vocab_size=200, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, num_filters=8,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            classifier_dropout=0.0, max_seq_len=6, max_seq_len_pv=10)
S = 16


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _configs(**kw):
    kw = {**TINY, **kw}
    return JConfig(**kw), TConfig(**kw)


def _ids(B, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 200, (B, S)).astype(np.int32)
    lens = rs.randint(6, S + 1, B)
    return ids * (np.arange(S)[None] < lens[:, None])


def _port(jmodel, tcfg, ids1, ids2):
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                  jnp.asarray(ids1), jnp.asarray(ids2))
    model = ttext.TextCNNTwoTower(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model.eval()


def _close(ours, theirs, what, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32), rtol=0,
                               atol=tol, err_msg=what)


METHODS = [dict(classification_method="cls", loss_type="ce"),
           dict(classification_method="vec_sim",
                similarity_measure="cosine", loss_type="cosine"),
           dict(classification_method="vec_sim",
                similarity_measure="inner_product", loss_type="bce")]


@pytest.mark.parametrize("kw", METHODS,
                         ids=["cls", "vec_sim-cosine", "vec_sim-inner"])
def test_textcnn_two_tower_matches_jax(kw):
    """Logits, probs, embeds, the loss and every gradient within 1e-4; the
    frozen channel's table has a zero gradient in JAX and none here."""
    jcfg, tcfg = _configs(**kw)
    ids1, ids2 = _ids(4, 0), _ids(4, 1)
    labels = np.array([0, 1, 1, 0], np.int32)
    jmodel = jtext.TextCNNTwoTower(jcfg)
    params, model = _port(jmodel, tcfg, ids1, ids2)

    def loss_fn(p):
        out = jmodel.apply(p, jnp.asarray(ids1), jnp.asarray(ids2),
                           labels=jnp.asarray(labels))
        return out.loss, out

    (loss, ref), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    out = model(torch.from_numpy(ids1).long(), torch.from_numpy(ids2).long(),
                labels=torch.from_numpy(labels).long())
    out.loss.backward()
    _close(out.loss, loss, "loss")
    for what in ("logits", "probs", "src_embeds", "tgt_embeds"):
        _close(getattr(out, what), getattr(ref, what), what)
    theirs = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    ours = dict(model.named_parameters())
    assert ours.keys() == theirs.keys()
    for name, p in ours.items():
        if ".embedding2." in name:
            assert p.grad is None and not theirs[name].abs().max(), name
            continue
        _close(p.grad, theirs[name].numpy(), f"d{name}")


def test_max_pool_reads_the_padding():
    """The pool runs over all S - K + 1 windows, pad positions included,
    as JAX's: padding more changes the features."""
    _, tcfg = _configs()
    model = ttext.TextCNNTwoTower(tcfg, device="cpu", seed=0).eval()
    ids = torch.from_numpy(_ids(2, 3)).long()
    longer = torch.cat([ids, torch.zeros(2, 8, dtype=torch.long)], 1)
    with torch.no_grad():
        a = model.textcnn(ids)
        b = model.textcnn(longer)
    assert a.shape == (2, 4 * 8) and not torch.equal(a, b)


def test_build_model_builds_textcnn_and_the_tree_round_trips():
    """``build_model`` dispatches ``textcnn`` as JAX's does; the port's
    parameter paths are JAX's (``textcnn/conv_K/kernel``,
    ``textcnn/embedding1/...``), the round trip is exact and the decay
    mask is JAX's."""
    jcfg, tcfg = _configs()
    model = build_model(tcfg.replace(interaction_type="one_tower"),
                        device="cpu", seed=0)
    assert type(model) is ttext.TextCNNTwoTower
    params, model = _port(jtext.TextCNNTwoTower(jcfg), tcfg, _ids(2, 0),
                          _ids(2, 1))
    tree = jax.tree_util.tree_map(np.asarray, params)["params"]

    def flat(t):
        return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}

    state = model.state_dict()
    assert state["textcnn.conv_3.weight"].shape == (8, 64, 3)
    assert tree["textcnn"]["conv_3"]["kernel"].shape == (3, 64, 8)
    assert {"/".join(flax_path(n)) for n in state} == set(flat(tree))
    back = flat(flax_from_state_dict(state)["params"])
    for name, leaf in flat(tree).items():
        assert np.array_equal(back[name], leaf), name
    assert {"/".join(flax_path(n)): v for n, v in
            decay_mask(state).items()} == flat(jdecay(tree))


def test_trainer_matches_jax_and_decays_the_frozen_table():
    """Three steps at batch 8 through both trainers: losses within 1e-4,
    parameters within 5e-6; ``embedding2`` got no gradient, moved only by
    weight decay, and equals JAX's."""
    jcfg, tcfg = _configs()
    B = 8
    parts = [(_ids(B, 10 + i), _ids(B, 20 + i)) for i in range(3)]
    jmodel = jtext.TextCNNTwoTower(jcfg)
    params, model = _port(jmodel, tcfg, *parts[0])
    emb2 = model.textcnn.embedding2.word_embeddings.weight.detach().clone()
    opt = dict(learning_rate=1e-3, total_steps=10, warmup_proportion=0.1,
               weight_decay=0.1)
    common = dict(seed=3, train_batch_size=B, eval_batch_size=B,
                  log_steps=1000, scan_steps=1)
    jt = JTrainer(jmodel, JTrain(optimizer=JOpt(**opt), **common),
                  params=params["params"])
    tt = TTrainer(model.train(), TTrain(optimizer=TOpt(**opt), **common),
                  device="cpu")
    rs = np.random.RandomState(6)
    for epoch, (ids1, ids2) in enumerate(parts):
        rows = {"input_ids_1": ids1, "input_ids_2": ids2,
                "attention_mask_1": (ids1 != 0).astype(np.int32),
                "attention_mask_2": (ids2 != 0).astype(np.int32),
                "labels": rs.randint(0, 2, B).astype(np.int32)}
        jl = jt.train_epoch(JDataset(rows), epoch)["loss"]
        tl = tt.train_epoch(TDataset(rows), epoch)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4,
                                   err_msg=f"step {epoch}")
    ours = model.state_dict()
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params}))
    for name, p in ours.items():
        np.testing.assert_allclose(p.numpy(), theirs[name].numpy(), rtol=0,
                                   atol=5e-6, err_msg=name)
    now = ours["textcnn.embedding2.word_embeddings.weight"]
    # decay alone: p <- p (1 - lr_t wd) each step, so the table shrank
    # along itself
    scale = (now * emb2).sum() / (emb2 * emb2).sum()
    assert 0.0 < 1.0 - scale.item() < 3 * opt["learning_rate"] * 0.1
    assert torch.allclose(now, emb2 * scale, rtol=0, atol=1e-7)
