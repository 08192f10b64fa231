"""The port's timm import (``utils/timm_import.py``) vs the JAX package's
and vs torch re-implementations of timm 0.6.5, on the CPU.

The timm-named state dicts are those of ``tests/test_timm_import.py``:
``fake_timm_sd`` for a ViT, and ``_torch_sd`` of its re-implementations
of timm's NFNet (``TNFNet``) and ResNetV2 (``TResNetV2``), their weights
and BatchNorm statistics drawn by ``_randomize``.  The port's towers loaded
through ``load_timm_backbone`` must give the torch modules' features and
the JAX towers' (loaded by JAX's ``load_timm_*``) within 1e-4 of max|ref|.
"""

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig as TConfig
from item_alignment_torch.models import image as timg
from item_alignment_torch.utils import timm_import as ttimm

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.models import image as jimg  # noqa: E402
from item_alignment_tpu.utils import timm_import as jtimm  # noqa: E402
from test_timm_import import (  # noqa: E402
    TNFNet,
    TResNetV2,
    _randomize,
    _torch_sd,
    fake_timm_sd,
)

torch.set_num_threads(1)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _port(tower, sd, name):
    tower.load_state_dict(ttimm.load_timm_backbone(tower.state_dict(), sd,
                                                   name))
    return tower.eval()


def _jax(jmodel, x_nhwc, load, sd):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x_nhwc))
    out = jax.jit(jmodel.apply)(load(params, sd), jnp.asarray(x_nhwc))
    return np.asarray(out[0] if isinstance(out, tuple) else out)


@pytest.mark.parametrize("family", ["nfnet", "resnetv2"])
def test_conv_towers_match_timm_math_and_jax(family):
    if family == "nfnet":
        tm = TNFNet((1, 2), (32, 64), 8, 16, 1.5)
        kw = dict(depths=(1, 2), channels=(32, 64), group_size=8,
                  stem_chs=16, feat_mult=1.5)
        ours_m, jm = timg.NFNet(**kw), jimg.NFNet(**kw)
        name, load, side = "eca_nfnet_l0", jtimm.load_timm_nfnet, 32
    else:
        tm = TResNetV2(layers=(2, 2), width=8)
        ours_m = timg.ResNetV2(depths=(2, 2), width=8)
        jm = jimg.ResNetV2(depths=(2, 2), width=8)
        name, load, side = "resnetv2_50", jtimm.load_timm_resnetv2, 64
    _randomize(tm, seed=5)
    tm.eval()
    x = torch.randn(2, 3, side, side, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        expected = tm(x).numpy()
    sd = _torch_sd(tm)
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        ours = _port(ours_m, sd, name)(x_nhwc).numpy()
    assert ours.shape == expected.shape
    assert _rel(ours, expected) < 1e-4
    assert _rel(ours, _jax(jm, x_nhwc.numpy(), load, sd)) < 1e-4


def test_vit_matches_jax_and_splits_the_fused_qkv():
    sd = fake_timm_sd(depth=2, dim=32, heads=4, patch=8, n_patches=16)
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    kw = dict(image_size=32, patch_size=8, dim=32, depth=2, heads=4)
    with torch.no_grad():
        cls, _ = _port(timg.ViT(**kw), sd, "vit_base")(torch.from_numpy(x))
    ref = _jax(jimg.ViT(**kw), x,
               lambda p, s: jtimm.load_timm_vit(p, s, num_heads=4), sd)
    assert _rel(cls.numpy(), ref) < 1e-4
    conv = ttimm.convert_timm_vit(sd)
    qkv = sd["blocks.1.attn.qkv.weight"]
    np.testing.assert_array_equal(conv["block_1.attn.key.weight"],
                                  qkv[32:64])
    np.testing.assert_array_equal(conv["block_1.attn.value.bias"],
                                  sd["blocks.1.attn.qkv.bias"][64:])
    np.testing.assert_array_equal(conv["block_1.attn.out.weight"],
                                  sd["blocks.1.attn.proj.weight"])


def test_load_timm_backbone_into_two_tower_matches_jax(monkeypatch):
    kw = dict(depths=(1, 1), channels=(32, 64), group_size=8, stem_chs=16,
              feat_mult=1.5)
    monkeypatch.setitem(jimg.BACKBONES, "nfnet", lambda c: jimg.NFNet(**kw))
    monkeypatch.setitem(timg.BACKBONES, "nfnet", lambda c: timg.NFNet(**kw))
    tm = TNFNet((1, 1), (32, 64), 8, 16, 1.5)
    _randomize(tm, seed=5)
    sd = _torch_sd(tm)
    cfg = dict(model_name="eca_nfnet_l0", image_model_name="eca_nfnet_l0",
               interaction_type="two_tower", hidden_dropout_prob=0.0)
    rs = np.random.RandomState(4)
    x1, x2 = (rs.randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
              for _ in range(2))
    jm = jimg.ImageTwoTower(JConfig(**cfg))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x1),
                              jnp.asarray(x2))
    tree = jtimm.load_timm_backbone(params, sd, "eca_nfnet_l0")
    ref = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x1),
                                       jnp.asarray(x2)).logits)

    from item_alignment_torch.convert import state_dict_from_flax

    model = timg.ImageTwoTower(TConfig(**cfg), device="cpu", seed=None)
    # the head as JAX drew it; the tower from the timm file alone
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, params)))
    before = model.state_dict()
    state = ttimm.load_timm_backbone(before, sd, "eca_nfnet_l0")
    assert {k for k in state if not torch.equal(state[k], before[k])} == {
        "NFNet_0." + k for k in ttimm.convert_timm_nfnet(sd)}
    model.load_state_dict(state)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x1),
                              torch.from_numpy(x2)).logits.numpy()
    assert _rel(logits, ref) < 1e-4


def test_shape_mismatch_and_leftover_keys_raise():
    tower = timg.ViT(image_size=32, patch_size=8, dim=32, depth=2, heads=4)
    sd = fake_timm_sd()
    sd["patch_embed.proj.weight"] = np.zeros((32, 3, 4, 4), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        ttimm.load_timm_backbone(tower.state_dict(), sd, "vit_base")
    with pytest.raises(KeyError, match="block_2"):
        ttimm.load_timm_backbone(tower.state_dict(), fake_timm_sd(depth=3),
                                 "vit_base")
    nf = _torch_sd(TNFNet((1,), (32,), 8, 16, 1.5))
    nf["stages.0.0.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        ttimm.convert_timm_nfnet(nf)
    with pytest.raises(ValueError, match="no timm converter"):
        ttimm.convert_for_model_name("roberta_large", nf)


@pytest.mark.parametrize("family", ["nfnet", "resnetv2"])
def test_full_size_checkpoints_cover_the_towers_exactly(family):
    """eca_nfnet_l0 and resnetv2_50 at their real widths: the conversion
    gives every parameter of the port's full-size tower, shape for shape."""
    if family == "nfnet":
        sd = _torch_sd(TNFNet((1, 2, 6, 3), (256, 512, 1536, 1536), 64, 128,
                              1.5))
        conv, tower = ttimm.convert_timm_nfnet(sd), timg.NFNet()
        assert tower.num_features == 2304
    else:
        sd = _torch_sd(TResNetV2(layers=(3, 4, 6, 3), width=64))
        conv, tower = ttimm.convert_timm_resnetv2(sd), timg.ResNetV2()
        assert tower.num_features == 2048
    assert {k: tuple(v.shape) for k, v in conv.items()} == {
        k: tuple(v.shape) for k, v in tower.state_dict().items()}
