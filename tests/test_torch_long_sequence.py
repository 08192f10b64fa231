"""The long-sequence (S > 512) cross-encoder of the port vs the JAX package,
on the CPU.

A 2-layer, hidden-64 ``RobertaOneTower`` reads pairs of 520 tokens.  Its
position table is grown from a 512-row synthetic HF checkpoint to 528 rows by
each package's ``hf_import`` (the same weights on both sides).  At this
length the port's ``flash_attention`` takes the blockwise functions (kernels
#4-#6; their plain versions on the CPU) and the JAX one its plain path, as
it does on any CPU.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.ops import cuda_attention_blockwise as cab

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_hf_import import both_models, hf_state_dict  # noqa: E402

torch.set_num_threads(1)

KW = dict(vocab_size=200, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=128, type_vocab_size=4,
          hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
          classifier_dropout=0.0, max_seq_len=60, max_seq_len_pv=200,
          max_position_embeddings=528)
S = 520


def _batch(B, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 200, (B, S)).astype(np.int32)
    lens = rs.randint(S // 2, S + 1, size=B)
    lens[0] = S  # one row uses the last position id, S + pad = 520
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.fixture(scope="module")
def models():
    sd = hf_state_dict(seed=3, positions=512, **KW)
    jmodel, merged, model = both_models(sd, **KW)
    assert jmodel.config.pair_seq_len == S
    table = model.state_dict()["roberta.embeddings.post.position_embeddings.weight"]
    assert tuple(table.shape) == (528, 64)
    np.testing.assert_array_equal(
        table[:512].numpy(), sd["bert.embeddings.position_embeddings.weight"])
    return jmodel, merged, model


def test_long_one_tower_logits_match_jax(models, monkeypatch):
    jmodel, merged, model = models
    ids, mask = _batch(3, seed=0)
    expect = jax.jit(jmodel.apply)(merged, jnp.asarray(ids), jnp.asarray(mask))
    calls = []
    fwd = cab.flash_fwd
    monkeypatch.setattr(cab, "flash_fwd", lambda *a: calls.append(a[2].shape)
                        or fwd(*a))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    # both layers went through the blockwise forward at the full length
    assert calls == [torch.Size([3, S, 2, 32])] * 2
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(expect.logits),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.probs.numpy(), np.asarray(expect.probs),
                               rtol=0, atol=1e-4)


def test_long_one_tower_grads_match_jax(models):
    jmodel, merged, model = models
    ids, mask = _batch(2, seed=1)
    labels = np.array([1, 0], np.int32)

    def loss_fn(p):
        return jmodel.apply(p, jnp.asarray(ids), jnp.asarray(mask),
                            labels=jnp.asarray(labels), deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)}).loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(merged)
    model.zero_grad()
    before = (cab.FWD_LAUNCHES, cab.DQ_LAUNCHES, cab.DKV_LAUNCHES)
    out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                labels=torch.from_numpy(labels).long(), deterministic=False,
                dropout_seed=0)
    out.loss.backward()
    # CPU tensors ran the plain versions: nothing was launched
    assert (cab.FWD_LAUNCHES, cab.DQ_LAUNCHES, cab.DKV_LAUNCHES) == before
    np.testing.assert_allclose(out.loss.item(), float(loss), rtol=0, atol=1e-4)
    theirs = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    ours = {n: p.grad for n, p in model.named_parameters()}
    assert ours.keys() == theirs.keys()
    for name, g in ours.items():
        np.testing.assert_allclose(g.numpy(), theirs[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # the grown rows that the batch reaches get a gradient
    pos = ours["roberta.embeddings.post.position_embeddings.weight"]
    assert pos[512:S + 1].abs().sum() > 0 and pos[S + 1:].abs().sum() == 0


@pytest.mark.parametrize("rows,ok", [(521, True), (520, False), (512, False)])
def test_sequence_past_the_position_table_raises(rows, ok):
    """Position ids run to S + pad_token_id = 520: a 521-row table takes
    them, a smaller one raises instead of indexing past the table (silent in
    JAX, a device assert in torch)."""
    from item_alignment_torch.config import ModelConfig
    from item_alignment_torch.models.text import RobertaOneTower

    cfg = ModelConfig(**dict(KW, num_hidden_layers=1,
                             max_position_embeddings=rows))
    model = RobertaOneTower(cfg, device="cpu", seed=0).eval()
    ids, mask = _batch(1, seed=2)
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    with torch.no_grad():
        if ok:
            assert torch.isfinite(model(*args).probs).all()
        else:
            with pytest.raises(ValueError, match="max_position_embeddings"):
                model(*args)
