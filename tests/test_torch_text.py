"""Port text models vs the JAX package's, on the same weights.

Tiny random JAX models (2 layers, hidden 32, 4 heads, vocab 200) are
initialised with ``jax.jit(model.init)``, their Flax trees converted with
``state_dict_from_flax`` and loaded into the port's models on the CPU.  Both
sides take the same numpy inputs with ragged masks and pad-aware positions.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.models import text as ttext

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.models import text as jtext  # noqa: E402

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=4,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            classifier_dropout=0.0, similarity_measure="cosine",
            loss_type="ce", max_seq_len=4, max_seq_len_pv=4)
FP32_TOL = 1e-4
BF16_TOL = 2e-2


def _configs(**kw):
    kw = {**TINY, **kw}
    return JConfig(**kw), TConfig(**kw)


def _ids(B, S, seed):
    """Token ids with a ragged pad tail (pad id 0) and the matching mask."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 200, (B, S)).astype(np.int32)
    lens = rs.randint(S // 2, S + 1, size=B)
    lens[0] = S
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _port(cls, jmodel, tcfg, *args, **kw):
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                  *(jnp.asarray(a) for a in args), **kw)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = cls(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(tree))
    return params, model.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def _close(ours, theirs, tol, what):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32),
                               rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("method,cls_layers,cls_pool", [
    ("cls", (1,), "cat"),
    ("cls", (1, 2), "cat"),
    ("cls", (1, 2), "avg"),
    ("vec_sim", (1,), "cat"),
])
def test_one_tower_matches_jax(method, cls_layers, cls_pool):
    jcfg, tcfg = _configs(classification_method=method,
                          cls_layers=cls_layers, cls_pool=cls_pool)
    ids, mask = _ids(3, jcfg.pair_seq_len, seed=0)
    params, model = _port(ttext.RobertaOneTower, jtext.RobertaOneTower(jcfg),
                          tcfg, ids, mask)
    expect = jax.jit(jtext.RobertaOneTower(jcfg).apply)(
        params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = model(_t(ids), _t(mask))
    for name in ("logits", "probs", "src_embeds", "tgt_embeds"):
        _close(getattr(out, name), getattr(expect, name), FP32_TOL,
               f"{method}/{cls_layers}/{cls_pool} {name}")


@pytest.mark.parametrize("method,measure,loss,aux", [
    ("cls", "cosine", "ce", False),
    ("cls", "cosine", "ce", True),
    ("vec_sim", "inner_product", "bce", False),
    ("vec_sim", "l1", "euclidean", False),
    ("vec_sim", "l2", "hinge", False),
    ("vec_sim", "cosine", "cosine", False),
])
def test_one_tower_loss_matches_jax(method, measure, loss, aux):
    jcfg, tcfg = _configs(classification_method=method,
                          similarity_measure=measure, loss_type=loss,
                          auxiliary_task=aux)
    ids, mask = _ids(4, jcfg.pair_seq_len, seed=1)
    labels = np.array([0, 1, 1, 0], np.int32)
    spans = np.full((4, 3, 5), -1, np.int32)  # (src, src_end, tgt, tgt_end, y)
    spans[:, 0] = (1, 3, 9, 12, 1)
    spans[1:3, 1] = (2, 4, 10, 11, 0)
    params, model = _port(ttext.RobertaOneTower, jtext.RobertaOneTower(jcfg),
                          tcfg, ids, mask, labels=jnp.asarray(labels),
                          pair_spans=jnp.asarray(spans))
    expect = jax.jit(jtext.RobertaOneTower(jcfg).apply)(
        params, jnp.asarray(ids), jnp.asarray(mask),
        labels=jnp.asarray(labels), pair_spans=jnp.asarray(spans))
    with torch.no_grad():
        out = model(_t(ids), _t(mask), labels=_t(labels), pair_spans=_t(spans))
    _close(out.probs, expect.probs, FP32_TOL, f"{measure} probs")
    _close(out.loss, expect.loss, 1e-5, f"{loss} loss (aux={aux})")


@pytest.mark.parametrize("variant", ["bf16", "fuse_qkv"])
def test_one_tower_variants_match_jax(variant):
    kw = {"dtype": "bfloat16"} if variant == "bf16" else {"fuse_qkv": True}
    tol = BF16_TOL if variant == "bf16" else FP32_TOL
    jcfg, tcfg = _configs(**kw)
    ids, mask = _ids(3, jcfg.pair_seq_len, seed=2)
    params, model = _port(ttext.RobertaOneTower, jtext.RobertaOneTower(jcfg),
                          tcfg, ids, mask)
    expect = jax.jit(jtext.RobertaOneTower(jcfg).apply)(
        params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = model(_t(ids), _t(mask))
    _close(out.probs, expect.probs, tol, f"{variant} probs")
    if variant == "fuse_qkv":
        plain = ttext.RobertaOneTower(tcfg.replace(fuse_qkv=False),
                                      device="cpu", seed=None)
        plain.load_state_dict(model.state_dict())
        with torch.no_grad():
            _close(plain(_t(ids), _t(mask)).logits, out.logits.numpy(),
                   1e-6, "fused vs unfused logits")


def test_backbone_states_match_jax():
    jcfg, tcfg = _configs()
    ids, mask = _ids(3, jcfg.item_seq_len, seed=3)
    params, model = _port(ttext.RobertaBackbone, jtext.RobertaBackbone(jcfg),
                          tcfg, ids, mask)
    expect = jax.jit(jtext.RobertaBackbone(jcfg).apply)(
        params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        states = model(_t(ids), _t(mask))
    assert len(states) == len(expect) == jcfg.num_hidden_layers + 1
    for i, (a, b) in enumerate(zip(states, expect)):
        assert a.dtype == torch.float32
        _close(a, b, FP32_TOL, f"hidden state {i}")


def test_two_tower_matches_jax():
    jcfg, tcfg = _configs(interaction_type="two_tower")
    S = jcfg.item_seq_len
    ids1, mask1 = _ids(3, S, seed=4)
    ids2, mask2 = _ids(3, S, seed=5)
    labels = np.array([1, 0, 1], np.int32)
    params, model = _port(ttext.RobertaTwoTower, jtext.RobertaTwoTower(jcfg),
                          tcfg, ids1, ids2, mask1, mask2)
    expect = jax.jit(jtext.RobertaTwoTower(jcfg).apply)(
        params, jnp.asarray(ids1), jnp.asarray(ids2), jnp.asarray(mask1),
        jnp.asarray(mask2), labels=jnp.asarray(labels))
    with torch.no_grad():
        out = model(_t(ids1), _t(ids2), _t(mask1), _t(mask2),
                    labels=_t(labels))
    for name in ("logits", "probs", "src_embeds", "tgt_embeds"):
        _close(getattr(out, name), getattr(expect, name), FP32_TOL, name)
    _close(out.loss, expect.loss, 1e-5, "loss")



def _lookup_against_torch(rows, id_dtype):
    from item_alignment_torch.models.layers import ONE_HOT_ROWS, embedding_lookup

    assert 7 <= ONE_HOT_ROWS < 3000
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, rows, (3, 50))).to(id_dtype)
    ids[0] = 0  # one row hit by many tokens, as the pad token is
    w = torch.from_numpy(rs.randn(3, 50, 8).astype(np.float32))
    ours, theirs = torch.nn.Embedding(rows, 8), torch.nn.Embedding(rows, 8)
    theirs.load_state_dict(ours.state_dict())
    a, b = embedding_lookup(ours, ids), theirs(ids)
    assert torch.equal(a, b)
    (a * w).sum().backward()
    (b * w).sum().backward()
    np.testing.assert_allclose(ours.weight.grad.numpy(),
                               theirs.weight.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("rows", [7, 3000])
def test_embedding_lookup_matches_torch_embedding(rows):
    """The port's lookup reads the rows ``F.embedding`` reads and gives the
    gradient it gives (summed in a fixed order), duplicates included, for a
    small table (one-hot product) and a large one (sorted segment sums)."""
    _lookup_against_torch(rows, torch.int64)


@pytest.mark.parametrize("rows", [7, 3000])
def test_embedding_lookup_takes_int32_ids(rows):
    """int32 ids, which ``table[ids]`` accepts, get the same rows and the
    same gradient."""
    _lookup_against_torch(rows, torch.int32)
