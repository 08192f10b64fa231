"""HF checkpoint import of the port vs the JAX package's, on the CPU.

A synthetic state dict with HF BERT names is made from a numpy seed (nothing
is downloaded) and goes through ``item_alignment_tpu.utils.hf_import`` and
the port's ``utils/hf_import.py``: the converted tables must be equal, the
rows grown past the checkpoint's included (both draw them from
``np.random.RandomState(0)``), and the two models must give equal logits.
Counterparts of ``tests/test_hf_import.py:76`` (row-copy quirks) and :110.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.convert import flax_from_state_dict, state_dict_from_flax
from item_alignment_torch.models import text as ttext
from item_alignment_torch.utils import hf_import as thf

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.models import text as jtext  # noqa: E402
from item_alignment_tpu.utils import hf_import as jhf  # noqa: E402

torch.set_num_threads(1)

KW = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64,
          hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def hf_state_dict(seed=0, vocab_size=200, hidden_size=32, num_hidden_layers=2,
                  intermediate_size=64, positions=64, types=2, prefix="bert.",
                  **_):
    """A state dict with HF BERT encoder names and shapes, from numpy."""
    rs = np.random.RandomState(seed)
    h, f = hidden_size, intermediate_size

    def arr(*shape, scale=0.05):
        return (rs.randn(*shape) * scale).astype(np.float32)

    sd = {"embeddings.word_embeddings.weight": arr(vocab_size, h),
          "embeddings.position_embeddings.weight": arr(positions, h),
          "embeddings.token_type_embeddings.weight": arr(types, h),
          "embeddings.LayerNorm.weight": 1 + arr(h),
          "embeddings.LayerNorm.bias": arr(h)}
    for i in range(num_hidden_layers):
        p = f"encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (h, h),
                             "attention.self.key": (h, h),
                             "attention.self.value": (h, h),
                             "attention.output.dense": (h, h),
                             "intermediate.dense": (f, h),
                             "output.dense": (h, f)}.items():
            sd[p + name + ".weight"] = arr(o, n)
            sd[p + name + ".bias"] = arr(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"] = 1 + arr(h)
            sd[p + name + ".bias"] = arr(h)
    return {prefix + k: v for k, v in sd.items()}


def both_models(sd, **kw):
    """A JAX and a port one-tower with ``sd`` imported through each
    package's ``import_hf_roberta`` (the heads converted from JAX's)."""
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jmodel = jtext.RobertaOneTower(jcfg)
    ids = jnp.ones((1, jcfg.pair_seq_len), jnp.int32)
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)}, ids)
    params = jax.tree_util.tree_map(np.asarray, params)
    merged = jhf.import_hf_roberta(params, sd, jcfg)
    model = ttext.RobertaOneTower(tcfg, device="cpu", seed=5)
    state = model.state_dict()
    state.update({k: v for k, v in state_dict_from_flax(params).items()
                  if k.startswith("head.")})
    model.load_state_dict(thf.import_hf_roberta(state, sd, tcfg))
    return jmodel, merged, model.eval()


@pytest.mark.parametrize("types,positions", [(None, None), (4, 600),
                                             (4, 1032), (2, 64)])
def test_converted_tables_equal_jax(types, positions):
    sd = hf_state_dict()
    ours = thf.convert_encoder_state_dict(sd, types, positions)
    theirs = state_dict_from_flax(
        jhf.convert_encoder_state_dict(sd, types, positions))
    assert ours.keys() == theirs.keys()
    for name, t in theirs.items():
        np.testing.assert_array_equal(ours[name], t.numpy(), err_msg=name)
    pe = ours["embeddings.post.position_embeddings.weight"]
    tte = ours["embeddings.post.token_type_embeddings.weight"]
    assert pe.shape[0] == (positions or 64) and tte.shape[0] == (types or 2)
    np.testing.assert_array_equal(
        pe[:64], sd["bert.embeddings.position_embeddings.weight"])
    np.testing.assert_array_equal(
        tte[:2], sd["bert.embeddings.token_type_embeddings.weight"])
    if positions and positions > 64:  # grown rows initialised, not zero
        assert np.abs(pe[64:]).sum() > 0 and np.abs(tte[2:]).sum() > 0


@pytest.mark.parametrize("prefix", ["bert.", "roberta.", ""])
def test_prefixes_are_stripped(prefix):
    sd = hf_state_dict(prefix=prefix)
    ours = thf.convert_encoder_state_dict(sd)
    np.testing.assert_array_equal(
        ours["encoder.layer_1.mlp_output.weight"],
        sd[prefix + "encoder.layer.1.output.dense.weight"])
    assert len(ours) == 5 + 2 * 16


def test_import_hf_roberta_gives_equal_logits():
    kw = dict(KW, max_position_embeddings=96, type_vocab_size=4,
              max_seq_len=10, max_seq_len_pv=30)
    sd = hf_state_dict(**kw)
    jmodel, merged, model = both_models(sd, **kw)
    rs = np.random.RandomState(1)
    S = JConfig(**kw).pair_seq_len
    assert S > 64  # positions past the checkpoint's rows are used
    ids = rs.randint(5, 200, (3, S)).astype(np.int32)
    mask = np.ones_like(ids)
    expect = jax.jit(jmodel.apply)(merged, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(expect.logits),
                               rtol=0, atol=1e-4)
    word = model.state_dict()["roberta.embeddings.word_embeddings.weight"]
    np.testing.assert_array_equal(
        word.numpy(), sd["bert.embeddings.word_embeddings.weight"])


def test_overlay_checks_shapes():
    dst = {"a.weight": torch.zeros(3, 2)}
    with pytest.raises(ValueError, match="shape mismatch"):
        thf._overlay(dst, {"a.weight": np.ones((4, 2), np.float32)})
    thf._overlay(dst, {"a.weight": np.ones((3, 2), np.float64)})
    assert dst["a.weight"].dtype == torch.float32 and dst["a.weight"].sum() == 6


@pytest.mark.parametrize("dst_rows,src_rows", [(4, 5), (5, 4), (4, 4)])
def test_overlay_rows_both_directions(dst_rows, src_rows):
    """A larger table into a smaller model and the reverse, as the JAX
    ``_overlay_rows`` does on the same arrays."""
    rs = np.random.RandomState(2)
    d = rs.randn(dst_rows, 3).astype(np.float32)
    s = rs.randn(src_rows, 3).astype(np.float32)
    bias = rs.randn(3).astype(np.float32)
    jdst = {"emb": {"embedding": d.copy()}, "ln": {"bias": np.zeros(3)}}
    jhf._overlay_rows(jdst, {"emb": {"embedding": s}, "ln": {"bias": bias}})
    tdst = {"emb.weight": torch.from_numpy(d.copy()), "ln.bias": torch.zeros(3)}
    thf._overlay_rows(tdst, {"emb.weight": s, "ln.bias": bias})
    np.testing.assert_array_equal(tdst["emb.weight"].numpy(),
                                  jdst["emb"]["embedding"])
    np.testing.assert_array_equal(tdst["ln.bias"].numpy(), jdst["ln"]["bias"])
    rows = min(dst_rows, src_rows)
    np.testing.assert_array_equal(tdst["emb.weight"][:rows].numpy(), s[:rows])
    np.testing.assert_array_equal(tdst["emb.weight"][rows:].numpy(), d[rows:])
    with pytest.raises(ValueError, match="incompatible"):
        thf._overlay_rows(tdst, {"emb.weight": np.zeros((4, 2), np.float32)})


def test_load_torch_state_dict(tmp_path):
    sd = hf_state_dict()
    path = str(tmp_path / "pytorch_model.bin")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    ours, theirs = thf.load_torch_state_dict(path), jhf.load_torch_state_dict(path)
    assert ours.keys() == theirs.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(ours[k], v)
        np.testing.assert_array_equal(theirs[k], v)


def test_converters_carry_a_1032_row_table_both_ways():
    """convert.py needs nothing new for a grown position table: a 1032-row
    table goes Flax -> port -> Flax unchanged."""
    sd = hf_state_dict()
    tree = {"params": {"roberta": jhf.convert_encoder_state_dict(
        sd, 4, 1032)}}
    state = state_dict_from_flax(tree)
    name = "roberta.embeddings.post.position_embeddings.weight"
    assert tuple(state[name].shape) == (1032, 32)
    back = flax_from_state_dict(state)

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    same(back["params"], tree["params"])
    cfg = TConfig(**dict(KW, max_position_embeddings=1032, type_vocab_size=4))
    model = ttext.RobertaBackbone(cfg, device="cpu", seed=None)
    model.load_state_dict({k[len("roberta."):]: v for k, v in state.items()})
