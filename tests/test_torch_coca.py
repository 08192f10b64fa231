"""The port's CoCa vs the JAX package's, on the CPU.

Tiny random models (hidden 32, 2 text and ViT layers of 4 heads, 16 px
images in 8 px patches, a 2-deep multimodal decoder with 4 heads,
ff_mult 2, vocab 200, 10 tokens with ragged masks and pad ids) are
initialised with ``jax.jit(model.init)``, their trees converted with
``state_dict_from_flax`` and loaded into the port's modules, and both take
the same numpy inputs: rotary angles, SwiGLU, ``ParallelTransformerBlock``
(causal, with a padding mask, and not), ``CrossAttention`` (with and
without the context norm), ``MultimodalDecoder``, ``CoCaForPretraining``'s
loss and gradients, and ``CoCaForItemAlignment`` (``sum`` and
``cross_attn`` with the two-tower head, ``sum`` with ``vec_sim``).  fp32
within 1e-5 for the blocks and 1e-4 for the models; under the bf16 policy
within 2e-2, with the scores in fp32 as JAX promotes them.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from item_alignment_torch.models import build_model
from item_alignment_torch.models import multimodal as tmm

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.models import multimodal as jmm  # noqa: E402

torch.set_num_threads(1)
BLOCK_TOL, MODEL_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
B, S, D = 3, 10, 32
TINY = dict(model_name="coca_tiny", vocab_size=200, hidden_size=D,
            num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=2,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            image_size=16, patch_size=8, multimodal_depth=2, coca_heads=4,
            ff_mult=2, max_seq_len=6, max_seq_len_pv=4)


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _configs(**kw):
    kw = {**TINY, **kw}
    return JConfig(**kw), TConfig(**kw)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _load(module, params):
    module.load_state_dict(state_dict_from_flax(_tree(params)))
    return module


def _text(seed=0, B=B):
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 200, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    for b, n in enumerate((S, 7, 4)[:B]):
        mask[b, n:] = 0
        ids[b, n:] = 0  # pad ids, which the caption loss skips
    return ids, mask


def _images(seed=0, B=B):
    rs = np.random.RandomState(seed + 1)
    return rs.randint(0, 256, (B, 16, 16, 3)).astype(np.uint8)


def _close(got, ref, tol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err)


def test_rotary_and_swiglu_match_jax():
    for n, dim in ((10, 8), (5, 16)):
        np.testing.assert_array_equal(tmm.rotary_freqs(n, dim).numpy(),
                                      np.asarray(jmm.rotary_freqs(n, dim)))
    x = np.random.RandomState(0).randn(3, 4, 16).astype(np.float32)
    pos = np.array(jmm.rotary_freqs(4, 16))
    _close(tmm.apply_rotary_pos_emb(torch.from_numpy(pos),
                                    torch.from_numpy(x)),
           jmm.apply_rotary_pos_emb(jnp.asarray(pos), jnp.asarray(x)),
           BLOCK_TOL)
    _close(tmm.swiglu(torch.from_numpy(x)), jmm.swiglu(jnp.asarray(x)),
           BLOCK_TOL)


@pytest.mark.parametrize("decoding,masked", [(True, False), (False, False),
                                             (True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parallel_transformer_block_matches_jax(decoding, masked, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    x = np.random.RandomState(2).randn(B, S, D).astype(np.float32)
    mask = None
    if masked:
        mask = np.random.RandomState(3).rand(B, S, S) > 0.3
        mask[:, :, 0] = True
    jb = jmm.ParallelTransformerBlock(dim=D, dim_head=8, heads=4, ff_mult=2,
                                      is_decoding=decoding, dtype=jdt)
    jx = jnp.asarray(x).astype(jdt or jnp.float32)
    jm = None if mask is None else jnp.asarray(mask)
    params = jax.jit(jb.init)(jax.random.PRNGKey(0), jx, jm)
    ref = jax.jit(jb.apply)(params, jx, jm)
    tb = _load(tmm.ParallelTransformerBlock(D, 8, 4, 2, decoding, tdt),
               params)
    seen = {}
    tb.attn_out.register_forward_pre_hook(
        lambda m, a: seen.update(dtype=a[0].dtype))
    out = tb(torch.from_numpy(x).to(tdt or torch.float32),
             None if mask is None else torch.from_numpy(mask))
    assert out.dtype == (tdt or torch.float32)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    # the scores and the attention output are fp32 under both policies
    assert seen["dtype"] == torch.float32
    _close(out, ref, BF16_TOL if tdt else BLOCK_TOL)


@pytest.mark.parametrize("norm_context", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(norm_context, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else None
    rs = np.random.RandomState(4)
    x = rs.randn(B, S, D).astype(np.float32)
    ctx = rs.randn(B, 5, D).astype(np.float32)
    jc = jmm.CrossAttention(dim=D, dim_head=8, heads=4, parallel_ff=True,
                            ff_mult=2, norm_context=norm_context, dtype=jdt)
    args = [jnp.asarray(a).astype(jdt or jnp.float32) for a in (x, ctx)]
    params = jax.jit(jc.init)(jax.random.PRNGKey(1), *args)
    assert ("context_norm" in params["params"]) == norm_context
    ref = jax.jit(jc.apply)(params, *args)
    tc = _load(tmm.CrossAttention(D, 8, 4, True, 2, norm_context, tdt),
               params)
    out = tc(*(torch.from_numpy(a).to(tdt or torch.float32)
               for a in (x, ctx)))
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    _close(out, ref, BF16_TOL if tdt else BLOCK_TOL)


@pytest.mark.parametrize("decoding", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multimodal_decoder_matches_jax(decoding, dtype):
    jcfg, tcfg = _configs(dtype=dtype)
    rs = np.random.RandomState(5)
    text = rs.randn(B, S, D).astype(np.float32)
    image = rs.randn(B, 5, D).astype(np.float32)
    jd = jmm.MultimodalDecoder(jcfg, is_decoding=decoding)
    params = jax.jit(jd.init)(jax.random.PRNGKey(2), jnp.asarray(text),
                              jnp.asarray(image))
    ref = jax.jit(jd.apply)(params, jnp.asarray(text), jnp.asarray(image))
    td = _load(tmm.MultimodalDecoder(tcfg, decoding), params)
    out = td(torch.from_numpy(text), torch.from_numpy(image))
    assert out.dtype == torch.float32
    _close(out, ref, BF16_TOL if dtype == "bfloat16" else BLOCK_TOL)


def _pretrain_pair(dtype="float32"):
    jcfg, tcfg = _configs(dtype=dtype)
    ids, mask = _text()
    images = _images()
    jm = jmm.CoCaForPretraining(jcfg)
    params = jax.jit(lambda k: jm.init(
        {"params": k}, jnp.asarray(ids), jnp.asarray(mask),
        images=jnp.asarray(images)))(jax.random.PRNGKey(0))
    tm = _load(tmm.CoCaForPretraining(tcfg, device="cpu", seed=None), params)
    return jm, params, tm, (ids, mask, images)


def test_coca_pretraining_loss_and_grads_match_jax():
    jm, params, tm, (ids, mask, images) = _pretrain_pair()
    loss_fn = jax.jit(jax.value_and_grad(lambda p: jm.apply(
        p, jnp.asarray(ids), jnp.asarray(mask), images=jnp.asarray(images))))
    ref_loss, ref_grads = loss_fn(params)
    loss = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
              images=torch.from_numpy(images))
    assert abs(loss.item() - float(ref_loss)) <= MODEL_TOL * max(
        1.0, abs(float(ref_loss)))
    loss.backward()
    ref_g = state_dict_from_flax(_tree(ref_grads))
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(ref_g)
    assert "temperature" in named
    for name, p in named.items():
        _close(p.grad, ref_g[name].numpy(), MODEL_TOL, name)


def test_coca_pretraining_bf16_loss_and_flax_round_trip():
    jm, params, tm, (ids, mask, images) = _pretrain_pair("bfloat16")
    ref = jax.jit(jm.apply)(params, jnp.asarray(ids), jnp.asarray(mask),
                            images=jnp.asarray(images))
    with torch.no_grad():
        loss = tm(torch.from_numpy(ids).long(),
                  torch.from_numpy(mask).long(),
                  images=torch.from_numpy(images))
    assert abs(loss.item() - float(ref)) <= BF16_TOL * max(1.0, float(ref))
    back = flax_from_state_dict(tm.state_dict(), num_heads=4)
    flat = jax.tree_util.tree_flatten_with_path(_tree(params))[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        assert np.array_equal(flat_back[path], leaf), path


@pytest.mark.parametrize("ensemble,method,dtype", [
    ("sum", "cls", "float32"), ("cross_attn", "cls", "float32"),
    ("sum", "vec_sim", "float32"), ("cross_attn", "cls", "bfloat16")])
def test_coca_item_alignment_matches_jax(ensemble, method, dtype):
    kw = dict(ensemble=ensemble, classification_method=method, dtype=dtype)
    if method == "vec_sim":
        kw.update(similarity_measure="cosine", loss_type="cosine")
    jcfg, tcfg = _configs(**kw)
    ids1, mask1 = _text(0)
    ids2, mask2 = _text(7)
    im1, im2 = _images(0), _images(9)
    labels = np.array([1, 0, 1], np.int32)
    args = tuple(map(jnp.asarray, (ids1, im1, ids2, im2, mask1, mask2)))
    jm = jmm.CoCaForItemAlignment(jcfg)
    params = jax.jit(lambda k: jm.init({"params": k}, *args))(
        jax.random.PRNGKey(3))
    ref = jax.jit(lambda p: jm.apply(p, *args, labels=jnp.asarray(labels)))(
        params)
    tm = _load(build_model(tcfg, device="cpu", seed=None), params)
    assert isinstance(tm, tmm.CoCaForItemAlignment)
    t = [torch.from_numpy(a) for a in (ids1, im1, ids2, im2, mask1, mask2)]
    for i in (0, 2, 4, 5):
        t[i] = t[i].long()
    out = tm(*t, labels=torch.from_numpy(labels).long())
    tol = BF16_TOL if dtype == "bfloat16" else MODEL_TOL
    for name in ("logits", "probs", "src_embeds", "tgt_embeds", "loss"):
        _close(getattr(out, name), getattr(ref, name), tol, name)
