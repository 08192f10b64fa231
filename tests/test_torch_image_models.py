"""The port's image towers (``models/image.py``) vs the JAX package's, on
the CPU.

Tiny towers (ViT 2 layers of width 32 and 4 heads on 32x32 images, patch 8;
ResNetV2 depths (1, 1) at width 8; NFNet depths (1, 1), channels (32, 64)
on 32x32 images) are initialised with ``jax.jit(model.init)``; NFNet's
StdConv gains and ResNetV2's affines are drawn from a seed so that no
branch is zero (conv3's gain starts at 0), and the trees are loaded into
the port through ``convert.state_dict_from_flax``.  Both take the same
numpy images.  Tolerances: fp32 features within 1e-4 of max|ref|, the
two-tower's probabilities within 1e-5, gradients within 1e-4 of each
parameter's max|ref| (the attention's key bias, whose exact gradient is
zero, within 1e-4 of the model's largest); the uint8 normalisation and the tree round trip
exactly; bf16 within 2e-2.
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
from item_alignment_torch.engine import optim as topt
from item_alignment_torch.models import build_model
from item_alignment_torch.models import image as timg

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.data import images as jimages  # noqa: E402
from item_alignment_tpu.engine import optim as jopt  # noqa: E402
from item_alignment_tpu.models import image as jimg  # noqa: E402

torch.set_num_threads(1)

VIT = dict(image_size=32, patch_size=8, dim=32, depth=2, heads=4)
RESNET = dict(depths=(1, 1), width=8)
NFNET = dict(depths=(1, 1), channels=(32, 64))
SIDE = {"vit": 32, "resnet": 32, "nfnet": 32}
TOWERS = {
    "vit": (lambda: jimg.ViT(**VIT), lambda: timg.ViT(**VIT)),
    "vit_int8": (lambda: jimg.ViT(**VIT, quant="int8"),
                 lambda: timg.ViT(**VIT, quant="int8")),
    "resnet": (lambda: jimg.ResNetV2(**RESNET),
               lambda: timg.ResNetV2(**RESNET)),
    "nfnet": (lambda: jimg.NFNet(**NFNET), lambda: timg.NFNet(**NFNET)),
}


def _images(name, B=2, u8=False, seed=0):
    rs = np.random.RandomState(seed)
    side = SIDE[name.split("_")[0]]
    if u8:
        return rs.randint(0, 256, (B, side, side, 3)).astype(np.uint8)
    return rs.randn(B, side, side, 3).astype(np.float32)


def _perturb(tree, seed=1):
    """Random StdConv gains and norm scales (every branch live)."""
    rs = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "gain":
                out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "scale" and "kernel" not in node:
                out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(tree)


def _init(jmodel, *args, perturb=True, **kw):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  *[jnp.asarray(a) for a in args], **kw)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return _perturb(tree) if perturb else tree


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12)


_TOWER_TREES = {}


@pytest.mark.parametrize("name,u8", [("vit", False), ("vit", True),
                                     ("vit_int8", False), ("resnet", False),
                                     ("resnet", True), ("nfnet", False),
                                     ("nfnet", True)])
def test_tower_features_match_jax(name, u8):
    make_j, make_t = TOWERS[name]
    x = _images(name, u8=u8)
    if name not in _TOWER_TREES:  # one init a tower for both input dtypes
        jm = make_j()
        _TOWER_TREES[name] = (jax.jit(jm.apply),
                              _init(jm, x.astype(np.float32)))
    apply, tree = _TOWER_TREES[name]
    ref = apply(tree, jnp.asarray(x))
    tm = make_t().eval()
    tm.load_state_dict(state_dict_from_flax(tree))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x))
    if isinstance(ref, tuple):  # ViT: (cls, tokens)
        for a, b in zip(ours, ref):
            assert _rel(a.numpy(), b) < 1e-4
    else:
        assert ours.shape == ref.shape
        assert _rel(ours.numpy(), ref) < 1e-4


def test_std_conv_and_eca_match_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 16).astype(np.float32)
    for jm, tm in ((jimg.StdConv(24, (3, 3), 2, groups=4, gamma=1.7),
                    timg.StdConv(16, 24, (3, 3), 2, groups=4, gamma=1.7)),
                   (jimg.ECA(5), timg.ECA(5))):
        tree = _init(jm, x)
        ref = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
        tm.load_state_dict(state_dict_from_flax(tree))
        with torch.no_grad():
            ours = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        ours = ours.permute(0, 2, 3, 1).numpy()
        assert ours.shape == ref.shape
        assert _rel(ours, ref) < 1e-4
    assert timg.eca_kernel_size(2304) == jimg.eca_kernel_size(2304) == 7
    assert [timg.make_divisible(v) for v in (7, 64, 383.5, 1536 * 0.25)] == \
        [jimg.make_divisible(v) for v in (7, 64, 383.5, 1536 * 0.25)]


def test_uint8_normalisation_is_the_host_arithmetic():
    u8 = _images("nfnet", B=3, u8=True, seed=5)
    ours = timg.maybe_normalize_uint8(torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(ours, jimages.normalize(u8))
    np.testing.assert_array_equal(
        ours, np.asarray(jimg.maybe_normalize_uint8(jnp.asarray(u8))))
    f = torch.randn(1, 4, 4, 3)
    assert timg.maybe_normalize_uint8(f) is f


@pytest.fixture(scope="module")
def pairs():
    """Both packages' BACKBONES built small, as the JAX package's tests
    build them, and per backbone (computed once): a JAX ImageTwoTower, its
    tree and inputs, and a function that builds the port's model with that
    tree."""
    with pytest.MonkeyPatch.context() as mp:
        for key, (make_j, make_t) in TOWERS.items():
            if "_" not in key:
                mp.setitem(jimg.BACKBONES, key, lambda c, m=make_j: m())
                mp.setitem(timg.BACKBONES, key, lambda c, m=make_t: m())
        made = {}

        def pair(name):
            if name not in made:
                kw = dict(model_name=f"{name}_tiny",
                          image_model_name=f"{name}_tiny", image_size=32,
                          patch_size=8, hidden_dropout_prob=0.0,
                          interaction_type="two_tower")
                jm = jimg.ImageTwoTower(JConfig(**kw))
                x1, x2 = _images(name, seed=1), _images(name, seed=2)
                labels = np.array([0, 1], np.int32)
                tree = _init(jm, x1, x2, labels=jnp.asarray(labels))
                made[name] = (jm, tree, TConfig(**kw), (x1, x2, labels))
            jm, tree, cfg, inputs = made[name]
            tm = build_model(cfg, device="cpu", seed=None)
            tm.load_state_dict(state_dict_from_flax(tree))
            return jm, tree, tm, inputs

        yield pair


@pytest.mark.parametrize("name", ["vit", "resnet", "nfnet"])
def test_image_two_tower_matches_jax(name, pairs):
    jm, tree, tm, (x1, x2, labels) = pairs(name)
    assert isinstance(tm, timg.ImageTwoTower)
    ref = jax.jit(jm.apply)(tree, jnp.asarray(x1), jnp.asarray(x2),
                            labels=jnp.asarray(labels))
    with torch.no_grad():
        ours = tm.eval()(torch.from_numpy(x1), torch.from_numpy(x2),
                         labels=torch.from_numpy(labels).long())
    np.testing.assert_allclose(ours.probs.numpy(), np.asarray(ref.probs),
                               atol=1e-5)
    assert abs(float(ours.loss) - float(ref.loss)) < 1e-5

    # gradients of the loss, every parameter, in train mode at dropout 0
    def loss_fn(p):
        return jm.apply(p, jnp.asarray(x1), jnp.asarray(x2),
                        labels=jnp.asarray(labels), deterministic=False).loss

    jgrads = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(tree)))
    tm.train()
    tm.zero_grad()
    tm(torch.from_numpy(x1), torch.from_numpy(x2),
       labels=torch.from_numpy(labels).long(), deterministic=False,
       dropout_seed=0).loss.backward()
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert grads.keys() == jgrads.keys()
    largest = max(np.abs(g.numpy()).max() for g in jgrads.values())
    for n, g in grads.items():
        ref_g = jgrads[n].numpy()
        # attention's key bias has a zero gradient in exact arithmetic (the
        # softmax cancels a constant of each query's row): both read
        # rounding, held against the model's largest gradient
        scale = largest if n.endswith("attn.key.bias") else \
            max(np.abs(ref_g).max(), 1e-8)
        assert np.abs(g.numpy() - ref_g).max() <= 1e-4 * scale, n


@pytest.mark.parametrize("name", ["vit", "resnet", "nfnet"])
def test_flax_round_trip_and_masks_match_jax(name, pairs):
    _, tree, tm, _ = pairs(name)
    back = flax_from_state_dict(state_dict_from_flax(tree), num_heads=4)
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == back_flat.keys()
    for k, v in flat.items():
        assert back_flat[k].shape == v.shape and back_flat[k].dtype == v.dtype
        np.testing.assert_array_equal(back_flat[k], v)

    names = [n for n, _ in tm.named_parameters()]
    patterns = ("stage0", "attn", "classifier/out_proj")
    for ours, theirs in ((topt.decay_mask(names),
                          jopt.decay_mask(tree["params"])),
                         (topt.freeze_mask(names, patterns),
                          jopt.freeze_mask(tree["params"], patterns))):
        theirs = {tuple(str(getattr(k, "key", k)) for k in path): bool(v)
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      theirs)[0]}
        assert {flax_path(n): v for n, v in ours.items()} == theirs
        assert 0 < sum(ours.values()) < len(ours)


def test_vit_norms_are_layer_norm_scales_and_own_params_keep_names():
    assert flax_path("ViT_0.block_0.norm1.weight")[-1] == "scale"
    assert flax_path("ViT_0.norm.weight")[-1] == "scale"
    assert flax_path("ResNetV2_0.stage0_block0.norm1.scale")[-1] == "scale"
    assert flax_path("NFNet_0.stage0_block0.attn_last.conv")[-1] == "conv"
    assert flax_path("NFNet_0.stem0.gain")[-1] == "gain"
    assert flax_path("ViT_0.pos_embed")[-1] == "pos_embed"
    decay = topt.decay_mask(["ViT_0.block_0.norm1.weight",
                             "ViT_0.block_0.attn.query.weight",
                             "NFNet_0.stem0.gain", "ViT_0.cls_token"])
    assert list(decay.values()) == [False, True, False, False]
    with pytest.raises(ValueError, match="num_heads"):
        flax_from_state_dict({"ViT_0.block_0.attn.query.weight":
                              torch.zeros(4, 4)})


def test_bf16_on_uint8_normalises_first_where_jax_does_not(monkeypatch):
    """Fault 1 of the reference: the JAX ``ImageTwoTower`` casts uint8
    images to bf16 before its towers' ``maybe_normalize_uint8``, which then
    passes them through as raw 0..255 values.  The port normalises first."""
    monkeypatch.setitem(jimg.BACKBONES, "nfnet",
                        lambda c: jimg.NFNet(**NFNET))
    monkeypatch.setitem(timg.BACKBONES, "nfnet",
                        lambda c: timg.NFNet(**NFNET))
    kw = dict(model_name="eca_nfnet_l0", image_model_name="eca_nfnet_l0",
              hidden_dropout_prob=0.0, interaction_type="two_tower")
    rs = np.random.RandomState(0)
    u8 = rs.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    host = jimages.normalize(u8)
    jm32 = jimg.ImageTwoTower(JConfig(**kw))
    tree = _init(jm32, host, host, perturb=False)
    jm16 = jimg.ImageTwoTower(JConfig(**kw, dtype="bfloat16"))
    apply16 = jax.jit(jm16.apply)
    jax_u8 = np.asarray(apply16(tree, jnp.asarray(u8), jnp.asarray(u8[::-1]))
                        .probs)
    jax_host = np.asarray(apply16(tree, jnp.asarray(host),
                                  jnp.asarray(host[::-1])).probs)
    assert np.abs(jax_u8 - jax_host).max() > 0.1  # JAX's fault
    tm = build_model(TConfig(**kw, dtype="bfloat16"), device="cpu",
                     seed=None).eval()
    tm.load_state_dict(state_dict_from_flax(tree))
    with torch.no_grad():
        ours = tm(torch.from_numpy(u8), torch.from_numpy(u8[::-1].copy()))
    assert np.abs(ours.probs.numpy() - jax_host).max() < 2e-2


def test_vit_attention_dropout_is_one_mask_at_the_exact_rate():
    """flax's broadcast dropout: one [S, S] mask for every batch row and
    head, survivors scaled by 1 / (1 - rate); drawn again from the seed."""
    attn = timg.MultiHeadDotProductAttention(8, 2, dropout_rate=0.5)
    timg.init_image_weights(attn, torch.Generator().manual_seed(0))
    x = torch.randn(3, 6, 8)
    a = attn(x, deterministic=False, dropout_seed=7)
    b = attn(x, deterministic=False, dropout_seed=7)
    c = attn(x, deterministic=False, dropout_seed=8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert not torch.equal(a, attn(x))
    keep = timg.dropout(torch.ones(1, 1, 64, 64), 0.5, 7, False)
    assert set(keep.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < (keep > 0).float().mean().item() < 0.6


def test_build_model_names_the_tower_as_flax_does():
    for name, tower in (("eca_nfnet_l0", "NFNet_0"),
                        ("resnetv2_50", "ResNetV2_0"),
                        ("vit_base_patch16_384", "ViT_0")):
        cfg = TConfig(model_name=name, image_model_name=name, image_size=32,
                      hidden_size=32, num_hidden_layers=1,
                      num_attention_heads=4, intermediate_size=64)
        model = build_model(cfg, device="cpu", seed=None)
        assert model.tower_name == tower
        assert {n.split(".")[0] for n, _ in model.named_parameters()} == {
            tower, "classifier"}
        assert model.classifier.out_proj.weight.shape == (
            2, 2 * model.tower.num_features)
