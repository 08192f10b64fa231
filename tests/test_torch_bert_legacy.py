"""The port's legacy 5-field BERT models vs the JAX package's, on the CPU.

Tiny random JAX models with 12 heads (hidden 96, 2 layers, vocab 120) are
initialised with ``jax.jit(model.init)``, their Flax trees converted with
``state_dict_from_flax`` and loaded into the port's models.  Both take the
same numpy inputs: five field pairs of ragged lengths padded with id 0.
fp32 results agree within 1e-4.  The position rule: a row whose real tokens
reach the end of the position table gives NaN in JAX and a ``ValueError``
in the port; a batch padded to the table's width with shorter rows runs and
agrees.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.convert import (
    flax_from_state_dict,
    flax_path,
    state_dict_from_flax,
)
from item_alignment_torch.data import bert_data as tbd
from item_alignment_torch.engine.optim import decay_mask
from item_alignment_torch.models import bert_legacy as tbl

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.engine.optim import decay_mask as jdecay  # noqa: E402
from item_alignment_tpu.models import bert_legacy as jbl  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
# 12 heads, as the legacy member's roberta_base config has
TINY = dict(model_name="bert_legacy", vocab_size=120, hidden_size=96,
            num_hidden_layers=2, num_attention_heads=12, intermediate_size=128,
            max_position_embeddings=64, type_vocab_size=4,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LENS = {"pvs": 24, "title": 16, "cate": 8, "cate_path": 12,
        "industry_name": 8}


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _configs(**kw):
    kw = {**TINY, **kw}
    return JConfig(**kw), TConfig(**kw)


def pair_rows(rs, B, S, vocab=120, full_row=None):
    """[B, S] ids of sentence pairs with a ragged pad tail (id 0), the mask
    and the token types (0 then 1); row ``full_row`` has no padding."""
    ids = np.zeros((B, S), np.int32)
    tt = np.zeros((B, S), np.int32)
    for b in range(B):
        n = S if b == full_row else rs.randint(4, S)
        ids[b, :n] = rs.randint(5, vocab, n)
        tt[b, n // 2:n] = 1
    return ids, (ids != 0).astype(np.int32), tt


def make_fields(B=3, seed=0, lens=None, full_pvs_row=None):
    rs = np.random.RandomState(seed)
    fields = {}
    for name in tbl.FIELD_NAMES:
        ids, mask, tt = pair_rows(rs, B, (lens or LENS)[name],
                                  full_row=full_pvs_row if name == "pvs"
                                  else None)
        fields[name] = {"input_ids": ids, "attention_mask": mask,
                        "token_type_ids": tt}
    return fields


def _jf(fields):
    return {k: {kk: jnp.asarray(v) for kk, v in f.items()}
            for k, f in fields.items()}


def _tf(fields):
    return {k: {kk: torch.from_numpy(v).long() for kk, v in f.items()}
            for k, f in fields.items()}


def _port(cls, jmodel, tcfg, *args, **kw):
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)}, *args,
                                  **kw)
    model = cls(tcfg, device="cpu", seed=None)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model.eval()


def _close(ours, theirs, what, tol=TOL):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(theirs, np.float32), rtol=0,
                               atol=tol, err_msg=what)


def _noise(B, seed=5, H=96):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, LENS["pvs"], H).astype(np.float32) * 0.5,
            rs.randn(B, LENS["title"], H).astype(np.float32) * 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_align_model_matches_jax(dtype):
    """Logits and probs of the 5-field model (summed pooled outputs, NSP
    head) on converted weights: fp32 within 1e-4, bf16 within 2e-2; in
    fp32 the pooled sum too (in bf16 its five summands of up to 1 each
    carry bf16 rounding, about 1e-2 apiece)."""
    jcfg, tcfg = _configs(dtype=dtype)
    fields = make_fields(3)
    jmodel = jbl.BertAlignModel(jcfg)
    params, model = _port(tbl.BertAlignModel, jmodel, tcfg, _jf(fields))
    ref = jax.jit(jmodel.apply)(params, _jf(fields))
    with torch.no_grad():
        out = model(_tf(fields))
    tol = TOL if dtype == "float32" else 2e-2
    _close(out.logits, ref.logits, "logits", tol)
    _close(out.probs, ref.probs, "probs", tol)
    if dtype == "float32":
        _close(out.src_embeds, ref.src_embeds, "pooled sum", tol)


@pytest.mark.parametrize("noise", [False, True])
def test_bert_align_loss_and_grads_match_jax(noise):
    """One backward at dropout 0 with ``deterministic=False``: the loss,
    every parameter's gradient and the noise gradients within 1e-4."""
    jcfg, tcfg = _configs()
    fields = make_fields(4, seed=1)
    labels = np.array([0, 1, 1, 0], np.int32)
    pvs, title = _noise(4) if noise else (None, None)
    jmodel = jbl.BertAlignModel(jcfg)
    params, model = _port(tbl.BertAlignModel, jmodel, tcfg, _jf(fields))

    def loss_fn(p, pn, tn):
        return jmodel.apply(p, _jf(fields), labels=jnp.asarray(labels),
                            pvs_noise=pn, title_noise=tn,
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1)}).loss

    j_noise = (None, None) if not noise else (jnp.asarray(pvs),
                                              jnp.asarray(title))
    argnums = (0, 1, 2) if noise else 0
    loss, grads = jax.value_and_grad(loss_fn, argnums)(params, *j_noise)
    t_noise = [None if n is None else torch.from_numpy(n).requires_grad_()
               for n in (pvs, title)]
    out = model(_tf(fields), labels=torch.from_numpy(labels).long(),
                pvs_noise=t_noise[0], title_noise=t_noise[1],
                deterministic=False, dropout_seed=0)
    out.loss.backward()
    _close(out.loss, loss, "loss")
    pgrads = grads[0] if noise else grads
    theirs = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, pgrads))
    ours = {n: p.grad for n, p in model.named_parameters()}
    assert ours.keys() == theirs.keys()
    for name, g in ours.items():
        _close(g, theirs[name].numpy(), f"d{name}")
    if noise:
        for t, j, what in zip(t_noise, grads[1:], ("pvs", "title")):
            _close(t.grad, j, f"d{what}_noise")
            assert t.grad.abs().max() > 0


def test_sim_eval_weight_matches_jax():
    jcfg, tcfg = _configs()
    fields = make_fields(2)
    jmodel = jbl.BertAlignModel(jcfg)
    params, model = _port(tbl.BertAlignModel, jmodel, tcfg, _jf(fields))
    jw, jb = jbl.sim_eval_weight(params)
    w, b = tbl.sim_eval_weight(model.state_dict())
    assert np.array_equal(w.numpy(), np.asarray(jw))
    assert np.array_equal(b.numpy(), np.asarray(jb))
    with torch.no_grad():
        out = model(_tf(fields))
    margin = out.src_embeds @ w + b
    _close(margin, out.logits[:, 1] - out.logits[:, 0], "margin")


@pytest.mark.parametrize("ignore", [-1, -100])
def test_bert_for_pretraining_matches_jax(ignore):
    """MLM logits (decoder tied to the word embeddings), NSP logits, the
    masked NLL + NSP loss and every gradient within 1e-4, five token
    types; the tied decoder has no parameter of its own."""
    jcfg, tcfg = _configs(type_vocab_size=5)
    rs = np.random.RandomState(3)
    ids, mask, _ = pair_rows(rs, 3, 20)
    tt = rs.randint(0, 5, ids.shape).astype(np.int32) * mask
    labels = np.full(ids.shape, ignore, np.int32)
    labels[:, 2:5] = ids[:, 2:5]
    nsp = np.array([1, 0, 1], np.int32)
    jmodel = jbl.BertForPretraining(jcfg)
    j_in = [jnp.asarray(x) for x in (ids, mask, tt)]
    params, model = _port(tbl.BertForPretraining, jmodel, tcfg, *j_in,
                          mlm_labels=jnp.asarray(labels),
                          next_label=jnp.asarray(nsp))
    assert not any("decoder" in k for k in model.state_dict())

    def loss_fn(p):
        out = jmodel.apply(p, *j_in, mlm_labels=jnp.asarray(labels),
                           next_label=jnp.asarray(nsp))
        return out["loss"], out

    (loss, ref), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    out = model(*(torch.from_numpy(x).long() for x in (ids, mask, tt)),
                mlm_labels=torch.from_numpy(labels).long(),
                next_label=torch.from_numpy(nsp).long())
    out["loss"].backward()
    _close(out["loss"], loss, "loss")
    _close(out["mlm_logits"], ref["mlm_logits"], "mlm logits")
    _close(out["nsp_logits"], ref["nsp_logits"], "nsp logits")
    theirs = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    ours = {n: p.grad for n, p in model.named_parameters()}
    assert ours.keys() == theirs.keys()
    for name, g in ours.items():
        _close(g, theirs[name].numpy(), f"d{name}")


@pytest.mark.parametrize("cls", ["BertAlignModel", "BertForPretraining"])
def test_flax_path_round_trip_of_the_legacy_trees(cls):
    """Every parameter's Flax path is JAX's (``transform_ln`` a LayerNorm,
    ``mlm_bias`` the module's own), the round trip is exact, and the
    weight-decay mask selects what JAX's selects."""
    jcfg, tcfg = _configs(type_vocab_size=5)
    fields = make_fields(2)
    if cls == "BertAlignModel":
        args = (_jf(fields),)
    else:
        args = (jnp.asarray(fields["pvs"]["input_ids"]),)
    jmodel = getattr(jbl, cls)(jcfg)
    params, model = _port(getattr(tbl, cls), jmodel, tcfg, *args)
    tree = jax.tree_util.tree_map(np.asarray, params)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree["params"])[0]}
    state = model.state_dict()
    assert {"/".join(flax_path(n)) for n in state} == set(flat)
    back = flax_from_state_dict(state)["params"]
    back_flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
                 for path, leaf in jax.tree_util.tree_flatten_with_path(
                     back)[0]}
    for name, leaf in flat.items():
        assert np.array_equal(back_flat[name], leaf), name
    j_mask = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  jdecay(tree["params"]))[0]}
    ours = decay_mask(state)
    assert {"/".join(flax_path(n)): v for n, v in ours.items()} == j_mask


def test_full_row_is_nan_in_jax_and_a_value_error_in_the_port():
    """pvs padded to the 64-row position table: a row whose 64 tokens are
    all real reads position 64 (RoBERTa positions count from pad_id + 1),
    past the table.  JAX's ``nn.Embed`` gives NaN there, which reaches the
    probabilities; the port refuses the arrays on the host, where the data
    layer builds them, and names the row."""
    lens = dict(LENS, pvs=64)
    jcfg, tcfg = _configs()
    fields = make_fields(3, seed=4, lens=lens, full_pvs_row=1)
    jmodel = jbl.BertAlignModel(jcfg)
    short = make_fields(3, seed=4, lens=lens)
    params, model = _port(tbl.BertAlignModel, jmodel, tcfg, _jf(short))
    ref = jax.jit(jmodel.apply)(params, _jf(fields))
    probs = np.asarray(ref.probs)
    assert np.isnan(probs[1]) and np.isfinite(probs[[0, 2]]).all()
    flat = {f"{k}_{kk}": v for k, f in fields.items() for kk, v in f.items()}
    with pytest.raises(ValueError, match="row 1 of pvs_input_ids holds 64"):
        tbd.check_position_ids(flat, tcfg)
    tbd.check_position_ids(
        {f"{k}_{kk}": v for k, f in short.items() for kk, v in f.items()},
        tcfg)


def test_padded_width_of_the_table_with_shorter_rows_runs_and_matches():
    """The same padded width (64 = max_position_embeddings) with every row
    shorter than 64 real tokens: no error, and the port agrees with JAX
    (the padded-width check of the RoBERTa models would refuse it)."""
    lens = dict(LENS, pvs=64)
    jcfg, tcfg = _configs()
    fields = make_fields(3, seed=4, lens=lens)
    assert (fields["pvs"]["attention_mask"].sum(1) < 64).all()
    jmodel = jbl.BertAlignModel(jcfg)
    params, model = _port(tbl.BertAlignModel, jmodel, tcfg, _jf(fields))
    ref = jax.jit(jmodel.apply)(params, _jf(fields))
    with torch.no_grad():
        out = model(_tf(fields))
    assert np.isfinite(np.asarray(ref.probs)).all()
    _close(out.probs, ref.probs, "probs")
    _close(out.logits, ref.logits, "logits")
