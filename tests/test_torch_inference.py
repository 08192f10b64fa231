"""Port TwoTowerInference vs the JAX package's, on the same weights.

A tiny JAX ``RobertaTwoTower`` is converted into the port; both sides encode
the same items once (the last encode batch padded with all-zero masks, as
``ia-tpu mine`` pads it) and score the same pairs against their caches.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.engine.inference import (
    TwoTowerInference,
    two_tower_encode_fn,
    two_tower_head_fn,
)
from item_alignment_torch.models.text import RobertaTwoTower

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.engine import inference as jinf  # noqa: E402
from item_alignment_tpu.models import text as jtext  # noqa: E402

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, interaction_type="two_tower",
            max_seq_len=4, max_seq_len_pv=4)
N_ITEMS, ENC_BATCH, SCORE_BATCH = 11, 4, 4


def _items(seed=0):
    rs = np.random.RandomState(seed)
    S = JConfig(**TINY).item_seq_len
    ids = rs.randint(5, 200, (N_ITEMS, S)).astype(np.int32)
    lens = rs.randint(2, S + 1, size=N_ITEMS)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def _batches(ids, mask, wrap):
    """Fixed-shape encode batches; the tail is padded with zero rows."""
    for s in range(0, len(ids), ENC_BATCH):
        i, m = ids[s:s + ENC_BATCH], mask[s:s + ENC_BATCH]
        pad = ENC_BATCH - len(i)
        i, m = np.pad(i, ((0, pad), (0, 0))), np.pad(m, ((0, pad), (0, 0)))
        yield {"input_ids": wrap(i), "attention_mask": wrap(m)}


@pytest.fixture(scope="module")
def both():
    jcfg = JConfig(**TINY)
    jmodel = jtext.RobertaTwoTower(jcfg)
    ids, mask = _items()
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)},
                                  jnp.asarray(ids), jnp.asarray(ids),
                                  jnp.asarray(mask), jnp.asarray(mask))
    model = RobertaTwoTower(TConfig(**TINY), device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.eval()

    backbone = jtext.RobertaBackbone(jcfg)

    def encode_fn(p, batch):
        states = backbone.apply({"params": p["params"]["roberta"]},
                                batch["input_ids"], batch["attention_mask"])
        return states[-1][:, 0]

    jax_inf = jinf.TwoTowerInference(params, encode_fn,
                                     jinf.two_tower_head_fn(jmodel, jcfg),
                                     batch_size=SCORE_BATCH)
    ours = TwoTowerInference(two_tower_encode_fn(model),
                             two_tower_head_fn(model),
                             batch_size=SCORE_BATCH, device="cpu")
    return jax_inf, ours, model, ids, mask


def test_cache_matches_jax(both):
    jax_inf, ours, _, ids, mask = both
    item_ids = [f"i{k}" for k in range(N_ITEMS)]
    expect = jax_inf.build_cache(item_ids, _batches(ids, mask, jnp.asarray))
    cache = ours.build_cache(
        item_ids, _batches(ids, mask, lambda a: torch.from_numpy(a).long()))
    assert cache.shape == (N_ITEMS, TINY["hidden_size"])
    np.testing.assert_allclose(cache.numpy(), np.asarray(expect), rtol=0,
                               atol=1e-5)


def test_score_pairs_match_jax_and_direct_forward(both):
    jax_inf, ours, model, ids, mask = both
    rs = np.random.RandomState(2)
    src = rs.randint(0, N_ITEMS, 10)  # 10 pairs: a padded tail of 2
    tgt = rs.randint(0, N_ITEMS, 10)
    got = ours.score_pairs(src, tgt)
    assert got.shape == (10,)
    np.testing.assert_allclose(got, jax_inf.score_pairs(src, tgt), rtol=0,
                               atol=1e-5)
    pairs = [(f"i{a}", f"i{b}") for a, b in zip(src, tgt)]
    np.testing.assert_allclose(ours.score_pairs_by_id(pairs), got, rtol=0,
                               atol=0)
    with torch.no_grad():
        direct = model(*(torch.from_numpy(a).long() for a in
                         (ids[src], ids[tgt], mask[src], mask[tgt]))).probs
    np.testing.assert_allclose(got, direct.numpy(), rtol=0, atol=1e-5)
    assert ours.score_pairs(src[:0], tgt[:0]).shape == (0,)


def test_int8_cache_raises_until_ported():
    """The int8 cache is ported (``tests/test_torch_quant.py`` holds it
    against JAX's); a cache_quant other than None or "int8" raises."""
    inf = TwoTowerInference(lambda b: b, lambda s, t: s, cache_quant="int8",
                            device="cpu")
    assert inf.cache_quant == "int8"
    with pytest.raises(ValueError, match="int4"):
        TwoTowerInference(lambda b: b, lambda s, t: s, cache_quant="int4",
                          device="cpu")
