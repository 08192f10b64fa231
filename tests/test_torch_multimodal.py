"""The port's multimodal RobertaImage family vs the JAX package's, on the
CPU.

Tiny random JAX models (2 layers, hidden 32, 4 heads, image_hidden_size 24,
pairs of 2 x 8 tokens) are initialised with ``jax.jit(model.init)``, their
Flax trees converted with ``state_dict_from_flax`` and loaded into the
port's models.  Both take the same numpy inputs: ragged masks, ``[unused99]``
ids at the image positions, image vectors from a seed, and one row whose tgt
image position is 1, where the tgt image overwrites the src image.  fp32
results and gradients agree within 1e-4.
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
from item_alignment_torch.engine.train import Trainer as TTrainer
from item_alignment_torch.models import build_model
from item_alignment_torch.models import embeddings as temb
from item_alignment_torch.models import heads as theads
from item_alignment_torch.models import multimodal as tmm
from item_alignment_torch.utils import hf_import as thf

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.config import TrainConfig as JTrain  # noqa: E402
from item_alignment_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from item_alignment_tpu.engine.train import Trainer as JTrainer  # noqa: E402
from item_alignment_tpu.models import embeddings as jemb  # noqa: E402
from item_alignment_tpu.models import heads as jheads  # noqa: E402
from item_alignment_tpu.models import multimodal as jmm  # noqa: E402
from item_alignment_tpu.utils import hf_import as jhf  # noqa: E402
from test_torch_hf_import import hf_state_dict  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
I = 24      # image_hidden_size
ITEM = 8    # tokens an item; max_seq_len 4 + max_seq_len_pv 4
TINY = dict(model_name="roberta_image_tiny", vocab_size=200, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=2,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_seq_len=4, max_seq_len_pv=4, image_hidden_size=I,
            ensemble="begin")


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    """Leave torch's global generator as this module found it (building a
    module draws from it)."""
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _configs(**kw):
    kw = {**TINY, **kw}
    return JConfig(**kw), TConfig(**kw)


def _one_tower_inputs(B=4, seed=0):
    """``[CLS] [IMG] [SEP] src [SEP] [IMG] [SEP] tgt [SEP]`` shaped rows:
    ids with 99 at position 1 and at the tgt image position, a ragged mask,
    token types 1 from the tgt image on; row 1's tgt image position is 1."""
    rs = np.random.RandomState(seed)
    S = 2 * ITEM
    ids = rs.randint(5, 200, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    tt = np.zeros((B, S), np.int32)
    index = rs.randint(ITEM - 3, ITEM + 2, B).astype(np.int32)
    index[1] = 1
    for b in range(B):
        n = rs.randint(ITEM + 3, S + 1)
        ids[b, 0], ids[b, 1], ids[b, index[b]] = 101, 99, 99
        mask[b, n:] = 0
        ids[b, n:] = 0
        tt[b, index[b]:n] = 1
    src_img = rs.randn(B, I).astype(np.float32)
    tgt_img = rs.randn(B, I).astype(np.float32)
    return ids, src_img, tgt_img, mask, tt, index


def _two_tower_inputs(B=4, seed=1):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(2):
        ids = rs.randint(5, 200, (B, ITEM)).astype(np.int32)
        ids[:, 0], ids[:, 1] = 101, 99
        mask = np.ones_like(ids)
        for b in range(B):
            n = rs.randint(3, ITEM + 1)
            mask[b, n:] = 0
            ids[b, n:] = 0
        out.append((ids, rs.randn(B, I).astype(np.float32), mask))
    (ids_1, img_1, mask_1), (ids_2, img_2, mask_2) = out
    return ids_1, img_1, ids_2, img_2, mask_1, mask_2


def _t(x):
    x = np.asarray(x)
    t = torch.from_numpy(x)
    return t if x.dtype == np.float32 else t.long()


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def _init(jmodel, *args, **kw):
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                  *_j(args), **kw)
    return params, jax.tree_util.tree_map(np.asarray, params)


def _port(cls, jmodel, tcfg, *args):
    params, tree = _init(jmodel, *args)
    model = cls(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(tree))
    return params, model.eval()


def _close(ours, theirs, what, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32), rtol=0,
                               atol=tol, err_msg=what)


CASES = [("begin", "one_tower"), ("begin", "two_tower"), ("end", "one_tower"),
         ("sum", "one_tower")]


@pytest.mark.parametrize("ensemble,interaction", CASES)
def test_image_splice_embeddings_match_jax(ensemble, interaction):
    """``begin``: the src image at position 1, in the one-tower the tgt
    image at ``image_indices`` after it (row 1: both at position 1, the tgt
    wins); the two-tower passes (image, image) and splices position 1
    only.  ``end``/``sum``: nothing spliced and no ``img2txt``.  Positions
    come from the attention mask."""
    jcfg, tcfg = _configs(ensemble=ensemble, interaction_type=interaction)
    ids, src_img, tgt_img, mask, tt, index = _one_tower_inputs()
    if interaction == "two_tower":
        ids, tt, index, tgt_img = ids[:, :ITEM], tt[:, :ITEM], None, src_img
        mask = mask[:, :ITEM]
    jmodule = jemb.ImageSpliceEmbeddings(jcfg)
    jargs = (jnp.asarray(ids), (jnp.asarray(src_img), jnp.asarray(tgt_img)),
             jnp.asarray(tt), None, jnp.asarray(mask),
             None if index is None else jnp.asarray(index))
    params = jax.jit(jmodule.init)({"params": jax.random.PRNGKey(0)}, *jargs)
    tree = jax.tree_util.tree_map(np.asarray, params)
    with torch.device("cpu"):
        ours = temb.ImageSpliceEmbeddings(tcfg)
    ours.load_state_dict(state_dict_from_flax(tree))
    assert hasattr(ours, "img2txt") == (ensemble == "begin")
    expect = jax.jit(jmodule.apply)(params, *jargs)
    with torch.no_grad():
        got = ours(_t(ids), (_t(src_img), _t(tgt_img)), _t(tt), None,
                   _t(mask), None if index is None else _t(index))
    assert got.shape == expect.shape == (4, ids.shape[1], 32)
    _close(got, expect, f"{ensemble}/{interaction}")
    if ensemble == "begin" and interaction == "one_tower":
        # without the splice the embeddings differ only at the spliced rows
        plain = temb.EmbedPostprocess(tcfg)
        plain.load_state_dict(ours.post.state_dict())
        with torch.no_grad():
            base = plain(ours.word_embeddings.weight[_t(ids)], _t(tt),
                         temb.create_position_ids(_t(mask), 0))
        moved = (got - base).abs().amax(-1) > 1e-6
        want = np.zeros(ids.shape, bool)
        want[:, 1] = True
        want[np.arange(4), index] = True
        np.testing.assert_array_equal(moved.numpy(), want)


@pytest.mark.parametrize("ensemble", ["begin", "end"])
def test_cls_head_matches_jax(ensemble):
    """The classification head; with ``end`` the two image vectors are
    concatenated and projected by ``dense_img`` before ``out_proj``, whose
    input is 2 * hidden wide."""
    jcfg, tcfg = _configs(ensemble=ensemble)
    rs = np.random.RandomState(5)
    feats = rs.randn(4, 6, 32).astype(np.float32)
    imgs = (rs.randn(4, I).astype(np.float32),
            rs.randn(4, I).astype(np.float32))
    jhead = jheads.ClsClassificationHead(jcfg)
    jimgs = tuple(map(jnp.asarray, imgs)) if ensemble == "end" else None
    params = jax.jit(jhead.init)({"params": jax.random.PRNGKey(0)},
                                 jnp.asarray(feats), jimgs)
    tree = jax.tree_util.tree_map(np.asarray, params)
    head = theads.ClsClassificationHead(tcfg)
    head.load_state_dict(state_dict_from_flax(tree))
    assert head.out_proj.weight.shape == (2, 64 if ensemble == "end" else 32)
    assert hasattr(head, "dense_img") == (ensemble == "end")
    expect = jax.jit(jhead.apply)(params, jnp.asarray(feats), jimgs)
    with torch.no_grad():
        got = head(_t(feats), image_embeds=tuple(map(_t, imgs)))
    _close(got, expect, ensemble)


@pytest.mark.parametrize("ensemble", ["begin", "end", "sum"])
def test_one_tower_matches_jax(ensemble):
    jcfg, tcfg = _configs(ensemble=ensemble)
    ids, src_img, tgt_img, mask, tt, index = _one_tower_inputs()
    labels = np.array([0, 1, 1, 0], np.int32)
    jmodel = jmm.RobertaImageOneTower(jcfg)
    args = (ids, src_img, tgt_img, mask, tt)
    params, tree = _init(jmodel, *args, image_indices=jnp.asarray(index))
    model = tmm.RobertaImageOneTower(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(tree))
    model.eval()
    expect = jax.jit(jmodel.apply)(
        params, *_j(args), image_indices=jnp.asarray(index),
        labels=jnp.asarray(labels))
    with torch.no_grad():
        got = model(_t(ids), _t(src_img), _t(tgt_img), _t(mask), _t(tt),
                    image_indices=_t(index), labels=_t(labels))
    for field in ("probs", "logits", "src_embeds", "tgt_embeds", "loss"):
        _close(getattr(got, field), getattr(expect, field), field)
    assert model.head.tgt_cls_position == tcfg.item_seq_len == ITEM


@pytest.mark.parametrize("ensemble", ["begin", "end"])
def test_two_tower_matches_jax(ensemble):
    jcfg, tcfg = _configs(ensemble=ensemble, interaction_type="two_tower")
    args = _two_tower_inputs()
    labels = np.array([1, 0, 1, 1], np.int32)
    jmodel = jmm.RobertaImageTwoTower(jcfg)
    params, model = _port(tmm.RobertaImageTwoTower, jmodel, tcfg, *args)
    expect = jax.jit(jmodel.apply)(params, *_j(args),
                                   labels=jnp.asarray(labels))
    with torch.no_grad():
        got = model(*map(_t, args), labels=_t(labels))
    for field in ("probs", "logits", "src_embeds", "tgt_embeds", "loss"):
        _close(getattr(got, field), getattr(expect, field), field)


def _grads_match(jmodel, params, model, jargs, targs, labels, kw=None):
    kw = kw or {}

    def loss_fn(p):
        return jmodel.apply(p, *jargs, labels=jnp.asarray(labels),
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)},
                            **kw).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model.train()
    out = model(*targs, labels=_t(labels), deterministic=False,
                dropout_seed=0, **{k: _t(v) for k, v in kw.items()})
    out.loss.backward()
    _close(out.loss, loss, "loss")
    theirs = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    ours = {n: p.grad for n, p in model.named_parameters()}
    assert ours.keys() == theirs.keys()
    for name, g in ours.items():
        _close(g, theirs[name].numpy(), f"d{name}")
    return ours


@pytest.mark.parametrize("ensemble", ["begin", "end"])
def test_one_tower_grads_match_jax(ensemble):
    """One backward at dropout 0 with ``deterministic=False``: the loss and
    every parameter's gradient (``img2txt``, ``dense_img``, the word table)
    within 1e-4 of ``jax.grad``."""
    jcfg, tcfg = _configs(ensemble=ensemble)
    ids, src_img, tgt_img, mask, tt, index = _one_tower_inputs(seed=2)
    labels = np.array([0, 1, 1, 0], np.int32)
    jmodel = jmm.RobertaImageOneTower(jcfg)
    params, tree = _init(jmodel, ids, src_img, tgt_img, mask, tt,
                         image_indices=jnp.asarray(index))
    model = tmm.RobertaImageOneTower(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(tree))
    args = (ids, src_img, tgt_img, mask, tt)
    ours = _grads_match(jmodel, params, model, _j(args), tuple(map(_t, args)),
                        labels, {"image_indices": index})
    key = ("roberta.embeddings.img2txt.weight" if ensemble == "begin"
           else "head.classifier.dense_img.weight")
    assert ours[key].abs().max() > 1e-6
    word = ours["roberta.embeddings.word_embeddings.weight"]
    if ensemble == "begin":
        # the image token's row is overwritten everywhere: no gradient
        assert torch.all(word[99] == 0)
    else:
        assert word[99].abs().max() > 0


def test_two_tower_grads_match_jax():
    jcfg, tcfg = _configs(interaction_type="two_tower")
    args = _two_tower_inputs(seed=3)
    labels = np.array([1, 0, 1, 0], np.int32)
    jmodel = jmm.RobertaImageTwoTower(jcfg)
    params, model = _port(tmm.RobertaImageTwoTower, jmodel, tcfg, *args)
    ours = _grads_match(jmodel, params, model, _j(args), tuple(map(_t, args)),
                        labels)
    assert ours["roberta.embeddings.img2txt.weight"].abs().max() > 1e-6


def test_build_model_builds_roberta_image():
    for interaction, cls in (("one_tower", tmm.RobertaImageOneTower),
                             ("two_tower", tmm.RobertaImageTwoTower)):
        model = build_model(TConfig(**dict(
            TINY, model_name="roberta_image_large",
            interaction_type=interaction)), device="cpu", seed=0)
        assert type(model) is cls
        assert model.roberta.embeddings.img2txt.weight.shape == (32, I)
    # CoCa is ported: a coca name gets the pair model
    coca = build_model(TConfig(**dict(
        TINY, model_name="coca_base", image_size=16, patch_size=8,
        multimodal_depth=1, coca_heads=4)), device="cpu", seed=0)
    assert type(coca) is tmm.CoCaForItemAlignment


@pytest.mark.parametrize("ensemble", ["begin", "end"])
def test_flax_path_round_trip_of_a_roberta_image_tree(ensemble):
    """``flax_from_state_dict`` gives back the JAX tree leaf for leaf:
    ``img2txt`` and ``dense_img`` are Dense kernels, the word table an
    Embed."""
    jcfg, _ = _configs(ensemble=ensemble)
    ids, src_img, tgt_img, mask, tt, index = _one_tower_inputs()
    _, tree = _init(jmm.RobertaImageOneTower(jcfg), ids, src_img, tgt_img,
                    mask, tt, image_indices=jnp.asarray(index))
    back = flax_from_state_dict(state_dict_from_flax(tree))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, str(path))
    if ensemble == "begin":
        assert flax_path("roberta.embeddings.img2txt.weight") == (
            "roberta", "embeddings", "img2txt", "kernel")
    else:
        assert flax_path("head.classifier.dense_img.weight") == (
            "head", "classifier", "dense_img", "kernel")
    assert flax_path("roberta.embeddings.word_embeddings.weight")[-1] == \
        "embedding"


@pytest.mark.parametrize("ensemble", ["begin", "end"])
def test_import_hf_roberta_leaves_image_layers_untouched(ensemble):
    """HF encoder weights overlay the encoder and the embedding tables of a
    RobertaImage state, and the result equals JAX's ``import_hf_roberta``
    on the same tree; ``img2txt`` and ``dense_img`` keep their init
    values."""
    jcfg, tcfg = _configs(ensemble=ensemble, type_vocab_size=4)
    ids, src_img, tgt_img, mask, tt, index = _one_tower_inputs()
    _, tree = _init(jmm.RobertaImageOneTower(jcfg), ids, src_img, tgt_img,
                    mask, tt, image_indices=jnp.asarray(index))
    sd = hf_state_dict(seed=4, positions=64, types=2)
    start = state_dict_from_flax(tree)
    ours = thf.import_hf_roberta(start, sd, tcfg)
    theirs = state_dict_from_flax(jhf.import_hf_roberta(tree, sd, jcfg))
    assert ours.keys() == theirs.keys()
    for name, value in ours.items():
        np.testing.assert_array_equal(value.numpy(), theirs[name].numpy(),
                                      name)
    image = [k for k in ours if "img2txt" in k or "dense_img" in k]
    assert len(image) == 2
    for name in image:
        assert torch.equal(ours[name], start[name])
    np.testing.assert_array_equal(
        ours["roberta.embeddings.word_embeddings.weight"].numpy(),
        sd["bert.embeddings.word_embeddings.weight"])
    model = tmm.RobertaImageOneTower(tcfg, device="cpu", seed=None)
    model.load_state_dict(ours)


@pytest.mark.parametrize("interaction", ["one_tower", "two_tower"])
def test_trainer_matches_jax_trainer(interaction):
    """Two steps at dropout 0, batch 8, through the port's Trainer and the
    JAX Trainer: the image arrays of each batch (``src_image_embeds``,
    ``tgt_image_embeds``, ``image_indices``; ``image_embeds_1/2``) reach the
    model as the dataset holds them.  Losses within 1e-4, parameters within
    5e-6 (as tests/test_torch_train.py holds RoBERTa), and the evaluated
    probabilities within 1e-4."""
    jcfg, tcfg = _configs(interaction_type=interaction)
    B = 8
    if interaction == "one_tower":
        parts = [_one_tower_inputs(B, seed=s) for s in (6, 7)]
        names = ("input_ids", "src_image_embeds", "tgt_image_embeds",
                 "attention_mask", "token_type_ids", "image_indices")
        jmodel, cls = jmm.RobertaImageOneTower(jcfg), tmm.RobertaImageOneTower
        params, tree = _init(jmodel, *parts[0][:5],
                             image_indices=jnp.asarray(parts[0][5]))
    else:
        parts = [_two_tower_inputs(B, seed=s) for s in (6, 7)]
        names = ("input_ids_1", "image_embeds_1", "input_ids_2",
                 "image_embeds_2", "attention_mask_1", "attention_mask_2")
        jmodel, cls = jmm.RobertaImageTwoTower(jcfg), tmm.RobertaImageTwoTower
        params, tree = _init(jmodel, *parts[0])
    model = cls(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(tree))
    opt = dict(learning_rate=1e-3, total_steps=10, warmup_proportion=0.1)
    common = dict(seed=3, train_batch_size=B, eval_batch_size=B,
                  log_steps=1000, scan_steps=1)
    jt = JTrainer(jmodel, JTrain(optimizer=JOpt(**opt), **common),
                  params=params["params"])
    tt = TTrainer(model, TTrain(optimizer=TOpt(**opt), **common),
                  device="cpu")
    rs = np.random.RandomState(8)
    for epoch, part in enumerate(parts):
        rows = dict(zip(names, part),
                    labels=rs.randint(0, 2, B).astype(np.int32))
        jl = jt.train_epoch(JDataset(rows), epoch)["loss"]
        tl = tt.train_epoch(TDataset(rows), epoch)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4,
                                   err_msg=f"step {epoch}")
    ours = model.state_dict()
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params}))
    assert ours.keys() == theirs.keys()
    for name, p in ours.items():
        np.testing.assert_allclose(p.numpy(), theirs[name].numpy(), rtol=0,
                                   atol=5e-6, err_msg=name)
    np.testing.assert_allclose(tt.evaluate(TDataset(rows))["probs"],
                               jt.evaluate(JDataset(rows))["probs"],
                               rtol=0, atol=1e-4)
