"""The port's PKGM family vs the JAX package's, on the CPU.

Tiny random JAX models (2 layers, hidden 32, max_seq_len 8, max_pvs 3, 50
entities, 10 relations) are initialised with ``jax.jit(model.init)``, their
Flax trees converted with ``state_dict_from_flax`` and loaded into the
port's models.  Both take the same numpy inputs: ids in the id space
(``L + 1 + P`` an item), masks, token types and positions in the embedded
space (``L + 2P`` an item), one item with no relations (entity 0, its KG
block masked).  fp32 results agree within 1e-4, the layouts exactly.
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
from item_alignment_torch.data import tokenization as ttok
from item_alignment_torch.engine.optim import decay_mask
from item_alignment_torch.engine.train import Trainer as TTrainer
from item_alignment_torch.models import build_model
from item_alignment_torch.models import embeddings as temb
from item_alignment_torch.models import text as ttext
from item_alignment_torch.utils import hf_import as thf

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.config import OptimizerConfig as JOpt  # noqa: E402
from item_alignment_tpu.config import TrainConfig as JTrain  # noqa: E402
from item_alignment_tpu.data.datasets import ArrayDataset as JDataset  # noqa: E402
from item_alignment_tpu.engine.train import Trainer as JTrainer  # noqa: E402
from item_alignment_tpu.models import embeddings as jemb  # noqa: E402
from item_alignment_tpu.models import text as jtext  # noqa: E402
from item_alignment_tpu.utils import hf_import as jhf  # noqa: E402
from test_torch_hf_import import hf_state_dict  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
L, P = 8, 3
TINY = dict(model_name="pkgm_tiny", vocab_size=200, hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=4,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            classifier_dropout=0.0, max_seq_len=L, max_seq_len_pv=None,
            max_pvs=P, num_entities=50, num_relations=10,
            kg_embedding_dim=32, similarity_measure="cosine")


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


def _item(rs, B, relations=True):
    """[B, L+1+P] id-space rows and their [B, L+2P] embedded-space mask:
    a ragged text part, an entity and 1..P relations (none for row 1 when
    ``relations`` is False)."""
    ids = np.zeros((B, L + 1 + P), np.int32)
    mask = np.zeros((B, L + 2 * P), np.int32)
    for b in range(B):
        n_txt = rs.randint(3, L + 1)
        ids[b, :n_txt] = rs.randint(5, 200, n_txt)
        mask[b, :n_txt] = 1
        n_rel = 0 if (b == 1 and not relations) else rs.randint(1, P + 1)
        if n_rel:
            ids[b, L] = rs.randint(1, 50)
            ids[b, L + 1: L + 1 + n_rel] = rs.randint(1, 10, n_rel)
            mask[b, L: L + 2 * n_rel] = 1
    return ids, mask


def _one_tower_inputs(B=3, seed=0):
    rs = np.random.RandomState(seed)
    src, src_mask = _item(rs, B)
    tgt, tgt_mask = _item(rs, B, relations=False)
    E = L + 2 * P
    tt = np.concatenate([np.zeros((B, E)), np.ones((B, E))], 1).astype(
        np.int32)
    pos = np.tile(np.arange(2 * E, dtype=np.int32), (B, 1))
    return (np.concatenate([src, tgt], 1),
            np.concatenate([src_mask, tgt_mask], 1), tt, pos)


def _two_tower_inputs(B=3, seed=1):
    rs = np.random.RandomState(seed)
    ids_1, mask_1 = _item(rs, B)
    ids_2, mask_2 = _item(rs, B, relations=False)
    tt = np.zeros_like(mask_1)
    tt[:, L:] = 1
    pos = np.tile(np.arange(L + 2 * P, dtype=np.int32), (B, 1))
    return ids_1, ids_2, mask_1, mask_2, tt, tt, pos


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def _init(jmodel, *args, **kw):
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                  *(jnp.asarray(a) for a in args), **kw)
    return params, jax.tree_util.tree_map(np.asarray, params)


def _port(cls, jmodel, tcfg, *args, **kw):
    params, tree = _init(jmodel, *args, **kw)
    model = cls(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(tree))
    return params, model.eval()


def _close(ours, theirs, what, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32), rtol=0,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("interaction", ["one_tower", "two_tower"])
@pytest.mark.parametrize("normalize", ["reference", "l2"])
@pytest.mark.parametrize("kg_dim", [32, 16])
def test_pkgm_embeddings_match_jax(kg_dim, normalize, interaction):
    """The embedding output (text, triple queries h+r, relation queries
    M.h - r, LayerNorm) with kg_embedding_dim equal to hidden or below it
    (the projector branch), each entity normalisation, one- and two-tower
    id layouts, an item with no relations."""
    jcfg, tcfg = _configs(kg_embedding_dim=kg_dim,
                          kg_entity_normalize=normalize,
                          interaction_type=interaction)
    if interaction == "one_tower":
        ids, _, tt, pos = _one_tower_inputs()
    else:
        ids, _, _, _, tt, _, pos = _two_tower_inputs()
    jmodule = jemb.PKGMEmbeddings(jcfg)
    params, tree = _init(jmodule, ids, tt, pos)
    with torch.device("cpu"):
        ours = temb.PKGMEmbeddings(tcfg)
    ours.load_state_dict(state_dict_from_flax(tree))
    assert hasattr(ours, "ent_projector") == (kg_dim != 32)
    expect = jax.jit(jmodule.apply)(params, *(jnp.asarray(a)
                                              for a in (ids, tt, pos)))
    with torch.no_grad():
        got = ours(_t(ids), _t(tt), _t(pos))
    assert got.shape == expect.shape == (
        3, (2 if interaction == "one_tower" else 1) * (L + 2 * P), 32)
    _close(got, expect, f"{interaction}/{normalize}/{kg_dim}")
    # and without explicit positions and token types (0..S-1 and zeros)
    expect = jax.jit(jmodule.apply)(params, jnp.asarray(ids))
    with torch.no_grad():
        _close(ours(_t(ids)), expect, "default positions")


@pytest.mark.parametrize("method", ["cls", "vec_sim"])
def test_pkgm_one_tower_matches_jax(method):
    """Probabilities and loss on converted weights; the tgt [CLS] the
    vec_sim head reads sits at max_seq_len + 2*max_pvs."""
    loss_type = "bce" if method == "vec_sim" else "ce"
    jcfg, tcfg = _configs(classification_method=method, loss_type=loss_type,
                          kg_embedding_dim=16)
    ids, mask, tt, pos = _one_tower_inputs()
    labels = np.array([0, 1, 1], np.int32)
    jmodel = jtext.PKGMOneTower(jcfg)
    params, model = _port(ttext.PKGMOneTower, jmodel, tcfg, ids, mask, tt,
                          pos)
    assert model.head.tgt_cls_position == L + 2 * P
    expect = jax.jit(jmodel.apply)(params, *(jnp.asarray(a) for a in
                                             (ids, mask, tt, pos)),
                                   labels=jnp.asarray(labels))
    with torch.no_grad():
        got = model(_t(ids), _t(mask), _t(tt), _t(pos), labels=_t(labels))
    for field in ("probs", "logits", "src_embeds", "tgt_embeds", "loss"):
        _close(getattr(got, field), getattr(expect, field), field)


def test_pkgm_two_tower_matches_jax():
    jcfg, tcfg = _configs(interaction_type="two_tower")
    ids_1, ids_2, mask_1, mask_2, tt_1, tt_2, pos = _two_tower_inputs()
    labels = np.array([1, 0, 1], np.int32)
    jmodel = jtext.PKGMTwoTower(jcfg)
    args = (ids_1, ids_2, mask_1, mask_2, tt_1, tt_2, pos)
    params, model = _port(ttext.PKGMTwoTower, jmodel, tcfg, *args)
    expect = jax.jit(jmodel.apply)(params, *(jnp.asarray(a) for a in args),
                                   labels=jnp.asarray(labels))
    with torch.no_grad():
        got = model(*(_t(a) for a in args), labels=_t(labels))
    for field in ("probs", "logits", "src_embeds", "tgt_embeds", "loss"):
        _close(getattr(got, field), getattr(expect, field), field)


def test_build_model_builds_pkgm():
    for interaction, cls in (("one_tower", ttext.PKGMOneTower),
                             ("two_tower", ttext.PKGMTwoTower)):
        model = build_model(TConfig(**dict(TINY, model_name="pkgm_large",
                                           interaction_type=interaction)),
                            device="cpu", seed=0)
        assert type(model) is cls
        assert model.roberta.embeddings.ent_emb.weight.shape == (50, 32)


@pytest.mark.parametrize("normalize", ["reference", "l2"])
def test_pkgm_loss_and_grads_match_jax(normalize):
    """One backward of PKGMOneTower at dropout 0 with
    ``deterministic=False``: the loss and every parameter's gradient within
    1e-4 of ``jax.grad``.  Under the reference normalisation the entity
    table's gradient is zero in exact arithmetic (x / |x| is flat), so both
    sides hold only fp32 noise there."""
    jcfg, tcfg = _configs(kg_embedding_dim=16, kg_entity_normalize=normalize)
    ids, mask, tt, pos = _one_tower_inputs(4, seed=2)
    labels = np.array([0, 1, 1, 0], np.int32)
    jmodel = jtext.PKGMOneTower(jcfg)
    params, model = _port(ttext.PKGMOneTower, jmodel, tcfg, ids, mask, tt,
                          pos)

    def loss_fn(p):
        return jmodel.apply(p, *(jnp.asarray(a) for a in (ids, mask, tt,
                                                          pos)),
                            labels=jnp.asarray(labels), deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)}).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    out = model(_t(ids), _t(mask), _t(tt), _t(pos), labels=_t(labels),
                deterministic=False, dropout_seed=0)
    out.loss.backward()
    _close(out.loss, loss, "loss")
    theirs = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    ours = {n: p.grad for n, p in model.named_parameters()}
    assert ours.keys() == theirs.keys()
    for name, g in ours.items():
        _close(g, theirs[name].numpy(), f"d{name}")
    ent = ours["roberta.embeddings.ent_emb.weight"].abs().max().item()
    assert (ent < 1e-6) == (normalize == "reference"), ent


def test_pkgm_trainer_matches_jax_trainer():
    """Three steps of PKGMOneTower at dropout 0, batch 8, through the port's
    Trainer and the JAX Trainer (8 CPU devices): losses within 1e-4, every
    parameter within 5e-6 (as tests/test_torch_train.py holds RoBERTa),
    the entity and relation tables included.  The entities are L2-normalised
    here: under the reference normalisation the entity table's gradient is
    fp32 noise (see above), which Adam scales up to the learning rate on
    both sides."""
    jcfg, tcfg = _configs(kg_embedding_dim=16, kg_entity_normalize="l2")
    B = 8
    parts = [_one_tower_inputs(B, seed=s) for s in (3, 4, 5)]
    rs = np.random.RandomState(6)
    jmodel = jtext.PKGMOneTower(jcfg)
    params, model = _port(ttext.PKGMOneTower, jmodel, tcfg, *parts[0])
    ent_0 = model.roberta.embeddings.ent_emb.weight.detach().clone()
    opt = dict(learning_rate=1e-3, total_steps=10, warmup_proportion=0.1)
    common = dict(seed=3, train_batch_size=B, eval_batch_size=B,
                  log_steps=1000, scan_steps=1)
    jt = JTrainer(jmodel, JTrain(optimizer=JOpt(**opt), **common),
                  params=params["params"])
    tt = TTrainer(model, TTrain(optimizer=TOpt(**opt), **common),
                  device="cpu")
    for epoch, (ids, mask, tt_ids, pos) in enumerate(parts):
        rows = {"input_ids": ids, "attention_mask": mask,
                "token_type_ids": tt_ids, "position_ids": pos,
                "labels": rs.randint(0, 2, B).astype(np.int32)}
        jl = jt.train_epoch(JDataset(rows), epoch)["loss"]
        tl = tt.train_epoch(TDataset(rows), epoch)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4,
                                   err_msg=f"step {epoch}")
    ours = model.state_dict()
    theirs = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params}))
    assert ours.keys() == theirs.keys()
    assert not torch.equal(ours["roberta.embeddings.ent_emb.weight"], ent_0)
    for name, p in ours.items():
        np.testing.assert_allclose(p.numpy(), theirs[name].numpy(), rtol=0,
                                   atol=5e-6, err_msg=name)


@pytest.mark.parametrize("bias", [False, True])
def test_convert_pkgm_state_dicts_matches_jax(bias):
    """The merged RoBERTa + pkgm_model.bin state dict equals the JAX
    package's merged tree, converted."""
    sd = hf_state_dict(seed=2, positions=64, types=2)
    rs = np.random.RandomState(3)
    kg = {"ent_emb.weight": rs.randn(50, 32).astype(np.float32),
          "rel_emb.weight": rs.randn(10, 32).astype(np.float32),
          "proj_mat.weight": rs.randn(32, 32).astype(np.float32)}
    if bias:
        kg["proj_mat.bias"] = rs.randn(32).astype(np.float32)
    ours = thf.convert_pkgm_state_dicts(sd, kg, 4, 64)
    theirs = state_dict_from_flax(jhf.convert_pkgm_state_dicts(sd, kg, 4, 64))
    assert ours.keys() == theirs.keys()
    for name, value in ours.items():
        np.testing.assert_array_equal(value, theirs[name].numpy(), name)
    np.testing.assert_array_equal(ours["embeddings.proj_mat.weight"],
                                  kg["proj_mat.weight"])
    # it loads into the port's backbone as it is
    model = ttext.PKGMBackbone(TConfig(**dict(
        TINY, entity_projection_bias=bias)), device="cpu", seed=None)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in ours.items()})


@pytest.mark.parametrize("kw", [dict(), dict(kg_embedding_dim=16,
                                             entity_projection_bias=True)])
def test_flax_path_round_trip_of_a_pkgm_tree(kw):
    """``flax_from_state_dict`` gives back the JAX tree of a PKGMOneTower,
    leaf for leaf: the entity and relation tables are Embed ``embedding``
    leaves, not Dense kernels to transpose, and the optimizer's decay mask
    reads them as tables."""
    jcfg, _ = _configs(**kw)
    _, tree = _init(jtext.PKGMOneTower(jcfg), *_one_tower_inputs())
    state = state_dict_from_flax(tree)
    back = flax_from_state_dict(state)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, str(path))
    for table, rows in (("ent_emb", 50), ("rel_emb", 10)):
        name = f"roberta.embeddings.{table}.weight"
        assert flax_path(name) == ("roberta", "embeddings", table,
                                   "embedding")
        assert tree["params"]["roberta"]["embeddings"][table][
            "embedding"].shape[0] == rows
    assert flax_path("roberta.embeddings.proj_mat.weight")[-1] == "kernel"
    mask = decay_mask(state)
    assert mask["roberta.embeddings.ent_emb.weight"]
    assert mask["roberta.embeddings.proj_mat.weight"]
    assert not mask["roberta.embeddings.post.layer_norm.weight"]


# ------------------------------------------------------------- layouts
VOCAB = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
         + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", ":", ";", "a", "b", "商",
            "品", "牌", "##品", "商品"] + [str(d) for d in range(10)]
         + ["<S>"])
KG_ENT = {f"/item/s{i}": 2 * i + 1 for i in range(6)}
KG_ENT.update({f"/item/t{i}": 2 * i + 2 for i in range(5)})
KG_REL = {"[PAD]": 0, "a": 1, "b": 2, "商品": 3}
ROWS = [
    ("1", "s0", "c", "商品 a", "a:b;b:a", "t0", "c", "商品 b", "a:b"),
    # an unknown relation, more relations than max_pvs, a long title
    ("0", "s1", "c", "商品 a b 商 品 牌 1 2 3 4 5 6", "zz:q;a:1;b:2;商品:3;a:4",
     "t1", "c", "品", "b:a"),
    # items with no known relation: their KG block stays empty and masked
    ("1", "s2", "c", "a", "zz:q", "t2", "c", "", ""),
    # an entity missing from entity2id (id 0), a pv without a colon
    ("0", "s9", "c", "牌 a", "a;b:b", "t9", "c", "商", "a:x"),
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    pytest.importorskip("transformers")
    from item_alignment_tpu.data import tokenization as jtok

    d = tmp_path_factory.mktemp("pkgm_vocab")
    (d / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    return ttok.load_text_tokenizer(str(d)), jtok.load_text_tokenizer(str(d))


@pytest.mark.parametrize("layout", ["one_tower_cls", "one_tower_vec_sim",
                                    "two_tower"])
def test_pkgm_layouts_match_jax(tokenizers, layout):
    from item_alignment_tpu.data import tokenization as jtok

    ours_tok, jax_tok = tokenizers
    if layout == "two_tower":
        ours = ttok.rows_to_pkgm_two_tower_dataset(ROWS, ours_tok, KG_ENT,
                                                   KG_REL, L, P)
        theirs = jtok.rows_to_pkgm_two_tower_dataset(ROWS, jax_tok, KG_ENT,
                                                     KG_REL, L, P)
    else:
        method = "vec_sim" if "vec_sim" in layout else "cls"
        ours = ttok.rows_to_pkgm_dataset(ROWS, ours_tok, KG_ENT, KG_REL, L,
                                         P, method)
        theirs = jtok.rows_to_pkgm_dataset(ROWS, jax_tok, KG_ENT, KG_REL, L,
                                           P, method)
    assert ours.arrays.keys() == theirs.arrays.keys()
    for k, v in ours.arrays.items():
        assert v.dtype == theirs.arrays[k].dtype == np.int32, k
        np.testing.assert_array_equal(v, theirs.arrays[k], k)
    assert ours.meta == theirs.meta
    # the two lengths: ids in the id space, the rest in the embedded space
    n = 2 if layout != "two_tower" else 1
    key = "input_ids" if n == 2 else "input_ids_1"
    assert ours.arrays[key].shape == (len(ROWS), n * (L + 1 + P))
    mask = "attention_mask" if n == 2 else "attention_mask_1"
    assert ours.arrays[mask].shape == (len(ROWS), n * (L + 2 * P))
    assert ours.arrays["position_ids"].shape[1] == n * (L + 2 * P)
