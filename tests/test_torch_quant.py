"""The port's int8 path vs the JAX package's (``ops/quant.py``,
``QuantDense``, the int8 embedding cache).

Scales and int8 values are computed the same way in fp32 on both sides, so
they must be equal bit for bit, and so must the int32 accumulators; the
dequantized products and the quantized models agree within fp32 rounding.
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
from item_alignment_torch.models import encoder as tenc
from item_alignment_torch.models import text as ttext
from item_alignment_torch.ops import quant as tq

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.engine import inference as jinf  # noqa: E402
from item_alignment_tpu.models import text as jtext  # noqa: E402
from item_alignment_tpu.ops import quant as jq  # noqa: E402

torch.set_num_threads(1)

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, max_seq_len=4,
            max_seq_len_pv=4, quant="int8")
MODEL_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    """Leave torch's global generator as this module found it: building a
    model draws from it (``nn.Embedding``'s own init), and a later test
    file in the same worker may draw weights from it."""
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _x(shape, seed):
    """Rows of very different magnitudes, one all-zero row and exact
    half-step values, so rounding ties and the 1e-8 guard are exercised."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    x *= rs.choice([1e-6, 1e-3, 1.0, 30.0], shape[:-1] + (1,))
    x[(0,) * (len(shape) - 1)] = 0.0
    x[(-1,) * (len(shape) - 1)][:4] = [127.0, 63.5, -0.5, 1.5]
    return x


@pytest.mark.parametrize("shape", [(5, 64), (3, 7, 48), (1, 8)])
def test_quantize_rowwise_bit_equal(shape):
    x = _x(shape, 0)
    jx, js = jq.quantize_rowwise(jnp.asarray(x))
    tx, ts = tq.quantize_rowwise(torch.from_numpy(x))
    assert tx.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("shape", [(64, 48), (32, 8)])
def test_quantize_colwise_bit_equal(shape):
    w = _x(shape[::-1], 1).T.copy()  # whole output channels scaled / zero
    jw, js = jq.quantize_colwise(jnp.asarray(w))
    tw, ts = tq.quantize_colwise(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the port's Dense keeps weight = kernel.T, quantized row by row
    rw, rs = tq.quantize_rowwise(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(rw.numpy().T, np.asarray(jw))
    np.testing.assert_array_equal(rs.numpy().T, np.asarray(js))


@pytest.mark.parametrize("M,K,N", [(40, 64, 48), (3, 20, 13), (17, 8, 8)])
def test_int8_accumulators_equal(M, K, N):
    """Equal int32 sums, padded (rows < 17, K or N not a multiple of 8)
    or not, and counted once per product."""
    rs = np.random.RandomState(M + K + N)
    a = rs.randint(-127, 128, (M, K)).astype(np.int8)
    b = rs.randint(-127, 128, (K, N)).astype(np.int8)
    ref = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b),
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    before = tq.INT_MM_LAUNCHES
    got = tq.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert tq.INT_MM_LAUNCHES == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_matches_jax(out_dtype):
    x = _x((4, 6, 64), 2)
    w = (np.random.RandomState(3).randn(64, 48) * 0.05).astype(np.float32)
    b = np.random.RandomState(4).randn(48).astype(np.float32)
    ref = jq.int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         out_dtype=getattr(jnp, out_dtype))
    got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                         torch.from_numpy(b), getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (4, 6, 48)
    ref, got = np.asarray(ref, np.float32), got.float().numpy()
    if out_dtype == "float32":
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        assert rel <= 1e-5, rel
    else:  # the same fp32 values rounded to bf16
        np.testing.assert_array_equal(got, ref)


def _ids(B, S, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 200, (B, S)).astype(np.int32)
    lens = rs.randint(S // 2, S + 1, size=B)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_quantized_one_tower_matches_jax(fuse_qkv):
    """Every dense projection of the encoder runs on the int8 path (six a
    layer: --fuse_qkv does not fuse under int8, as in JAX); the heads stay
    fp32."""
    kw = dict(TINY, fuse_qkv=fuse_qkv)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    ids, mask = _ids(3, jcfg.pair_seq_len, 5)
    jmodel = jtext.RobertaOneTower(jcfg)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)},
                                  jnp.asarray(ids), jnp.asarray(mask))
    model = ttext.RobertaOneTower(tcfg, device="cpu", seed=None).eval()
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    assert sum(isinstance(m, tenc.QuantDense) for m in model.modules()) \
        == 6 * tcfg.num_hidden_layers
    ref = jax.jit(jmodel.apply)(params, jnp.asarray(ids), jnp.asarray(mask))
    before = tq.INT_MM_LAUNCHES
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert tq.INT_MM_LAUNCHES - before == 6 * tcfg.num_hidden_layers
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits),
                               rtol=0, atol=MODEL_TOL)
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(ref.probs),
                               rtol=0, atol=MODEL_TOL)
    # and the int8 path moves the outputs away from the float model's
    plain = ttext.RobertaOneTower(tcfg.replace(quant=None), device="cpu",
                                  seed=None).eval()
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        fp = plain(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert np.abs(fp.logits.numpy() - got.logits.numpy()).max() > 1e-6


@pytest.fixture(scope="module")
def two_tower():
    kw = dict(TINY, interaction_type="two_tower")
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    ids, mask = _ids(11, jcfg.item_seq_len, 6)
    jmodel = jtext.RobertaTwoTower(jcfg)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1)},
                                  *(jnp.asarray(a) for a in
                                    (ids, ids, mask, mask)))
    model = ttext.RobertaTwoTower(tcfg, device="cpu", seed=None).eval()
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, jmodel, params, model, ids, mask


def test_quantized_two_tower_matches_jax(two_tower):
    jcfg, jmodel, params, model, ids, mask = two_tower
    ref = jax.jit(jmodel.apply)(params, *(jnp.asarray(a) for a in
                                          (ids, ids[::-1], mask, mask[::-1])))
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.ascontiguousarray(a)).long()
                      for a in (ids, ids[::-1], mask, mask[::-1])))
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(ref.probs),
                               rtol=0, atol=MODEL_TOL)


def test_int8_cache_matches_jax(two_tower):
    """``cache_quant="int8"``: equal int8 rows and scales (the encoders
    agree to fp32 rounding, so a row may differ by one step only where its
    value sits on a rounding tie; none does here), and scores within 1e-4,
    on a quantized encoder and on a float one."""
    jcfg, jmodel, params, model, ids, mask = two_tower
    for quant in ("int8", None):
        cfg = jcfg.replace(quant=quant)
        backbone = jtext.RobertaBackbone(cfg)
        tmodel = ttext.RobertaTwoTower(model.config.replace(quant=quant),
                                       device="cpu", seed=None).eval()
        tmodel.load_state_dict(model.state_dict())

        def encode_fn(p, batch):
            return backbone.apply({"params": p["params"]["roberta"]},
                                  batch["input_ids"],
                                  batch["attention_mask"])[-1][:, 0]

        jax_inf = jinf.TwoTowerInference(
            params, encode_fn, jinf.two_tower_head_fn(jmodel, cfg),
            batch_size=4, cache_quant="int8")
        ours = TwoTowerInference(two_tower_encode_fn(tmodel),
                                 two_tower_head_fn(tmodel), batch_size=4,
                                 cache_quant="int8", device="cpu")
        items = [f"i{k}" for k in range(len(ids))]

        def batches(wrap):
            for s in range(0, len(ids), 4):
                i, m = ids[s:s + 4], mask[s:s + 4]
                pad = 4 - len(i)
                yield {"input_ids": wrap(np.pad(i, ((0, pad), (0, 0)))),
                       "attention_mask": wrap(np.pad(m, ((0, pad), (0, 0))))}

        jcache = jax_inf.build_cache(items, batches(jnp.asarray))
        cache = ours.build_cache(
            items, batches(lambda a: torch.from_numpy(a).long()))
        assert cache.dtype == torch.int8 and cache.shape == (11, 32)
        np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))
        np.testing.assert_allclose(ours.cache_scale.numpy(),
                                   np.asarray(jax_inf.cache_scale),
                                   rtol=1e-6, atol=0)
        rs = np.random.RandomState(7)
        src, tgt = rs.randint(0, 11, 10), rs.randint(0, 11, 10)
        np.testing.assert_allclose(ours.score_pairs(src, tgt),
                                   jax_inf.score_pairs(src, tgt),
                                   rtol=0, atol=MODEL_TOL)


def test_quant_is_validated():
    with pytest.raises(ValueError, match="int4"):
        ttext.RobertaBackbone(TConfig(**dict(TINY, quant="int4")),
                              device="cpu")
