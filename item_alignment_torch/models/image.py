"""The image towers: ViT, ResNetV2, NFNet and the image two-tower.

Port of ``item_alignment_tpu/models/image.py``:

- ``ViT``: patch-16 pre-LN vision transformer, CLS-pooled; its attention is
  flax ``MultiHeadDotProductAttention`` as plain PyTorch math, with flax's
  exact-rate dropout on the attention weights (one mask broadcast over the
  batch and the heads, as flax's ``broadcast_dropout`` draws it);
- ``ResNetV2``: timm 0.6.5 ``resnetv2_50``, pre-activation bottlenecks, its
  BatchNorms folded into trainable per-channel affines (``AffineAct``);
- ``NFNet``: timm 0.6.5 ``eca_nfnet_l0``: ScaledStdConv (``StdConv``),
  grouped 3x3 convs, ECA after conv3 with gain 2.0, conv3's gain starting
  at 0, deep-quad stem and the expected-variance (alpha, beta) bookkeeping;
- ``ImageTwoTower``: one shared tower over both images, the two-tower head
  and the pair loss.

Every constructor field of the JAX modules is kept; PyTorch needs the input
width of a layer when it is built, so the convolutions and blocks take
``in_features`` first.  Module and parameter names follow the Flax tree
(``NFNet_0.stage1_block0.conv2.weight`` is Flax's ``NFNet_0/stage1_block0/
conv2/kernel``); ``convert.py`` maps the layouts.  The parameters of a
module itself keep their Flax names: StdConv's ``gain``, ECA's ``conv``,
ViT's ``cls_token`` and ``pos_embed``, AffineAct's ``scale`` and ``bias``.

Images arrive as NHWC (uint8 shards, or floats already normalised).  uint8
images are normalised on the device in fp32 before any cast, in every
dtype, as ``maybe_normalize_uint8``'s docstring intends (the JAX
``ImageTwoTower`` casts to bf16 first under ``dtype="bfloat16"``, so its
towers then see raw 0..255 values: ``ROADMAP.md``, Queue 3).  The NHWC
tensor is then viewed as NCHW, which is PyTorch's channels-last layout, and
the convolutions are ``F.conv2d`` with torch's symmetric padding
``((s-1)+d*(k-1))//2``: the JAX package's convolutions are
``lax.conv_general_dilated`` outside any Pallas kernel.  NFNet's downsample
is a 2x2 average pool with VALID padding (floor), as in JAX; ResNetV2's
max pool pads with -inf.  Parameters are fp32; a conv's weight is cast to
its input's dtype (StdConv standardises it in fp32 first), so under
``dtype="bfloat16"`` the towers run in bf16 from the cast images on.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.device import resolve_device
from item_alignment_torch.models.encoder import QuantDense
from item_alignment_torch.models.heads import TwoTowerClassificationHead
from item_alignment_torch.models.layers import Dense, LayerNorm, init_weights
from item_alignment_torch.models.losses import pair_loss
from item_alignment_torch.models.outputs import PairClassifierOutput
from item_alignment_torch.models.text import Device
from item_alignment_torch.ops.dropout import dropout, fold_seed

# ImageNet's channel statistics (timm IMAGENET_DEFAULT_MEAN / _STD), as
# ``data/images.py`` holds them
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_SILU_GAMMA = 1.7881293296813965  # timm _nonlin_gamma['silu']


def maybe_normalize_uint8(images: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalised fp32 on the images' device:
    ``(x / 255 - mean) / std`` in fp32, the host ``data.images.normalize``'s
    arithmetic bit for bit (every divisor is a tensor on the images'
    device: CUDA divides by a Python scalar as a product with its
    reciprocal, a few ulps off).  Float inputs pass through unchanged."""
    if images.dtype != torch.uint8:
        return images
    dev = images.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    scale = torch.tensor(255.0, dtype=torch.float32, device=dev)
    return (images.float() / scale - mean) / std


def _torch_pad(k: int, s: int = 1, d: int = 1) -> Tuple[int, int]:
    """timm/torch symmetric static padding (timm layers/padding.py)."""
    p = ((s - 1) + d * (k - 1)) // 2
    return (p, p)


def _nchw(images: torch.Tensor) -> torch.Tensor:
    """NHWC -> an NCHW view (channels-last in memory)."""
    return images.permute(0, 3, 1, 2)


def _pool_hw(x: torch.Tensor) -> torch.Tensor:
    """Global average pool of NCHW -> [B, C]."""
    return x.mean(dim=(2, 3))


# ------------------------------------------------------------------- ViT
class MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask):
    ``query``/``key``/``value``/``out`` projections (flax's DenseGeneral
    kernels ``[D, N, Hd]`` and ``[N, Hd, D]`` as ``[D, D]`` weights), the
    query scaled by 1/sqrt(Hd) before the product, the softmax in the
    compute dtype, and dropout on the weights at the exact rate with one
    mask ``[1, 1, S, S]`` for every batch row and head."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_heads = num_heads
        self.rate = float(dropout_rate)
        self.query = Dense(dim, dim, dtype)
        self.key = Dense(dim, dim, dtype)
        self.value = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        B, S, D = x.shape
        N = self.num_heads
        q = self.query(x).reshape(B, S, N, D // N)
        k = self.key(x).reshape(B, S, N, D // N)
        v = self.value(x).reshape(B, S, N, D // N)
        q = q / math.sqrt(D // N)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if not deterministic and self.rate > 0.0:
            keep = dropout(torch.ones((1, 1, S, S), dtype=weights.dtype,
                                      device=x.device), self.rate,
                           dropout_seed, deterministic, batch_major=False)
            weights = weights * keep
        ctx = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(ctx.reshape(B, S, D))


class ViTBlock(nn.Module):
    """Pre-LN block: LayerNorm (eps 1e-6), attention, residual; LayerNorm,
    MLP with the exact erf GELU, dropout, residual.  ``quant="int8"`` puts
    the two MLP denses on the int8 path (``QuantDense``)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 quant: Optional[str] = None):
        super().__init__()
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant {quant!r}")
        dense = QuantDense if quant == "int8" else Dense
        self.rate = float(dropout)
        self.norm1 = LayerNorm(dim, 1e-6, dtype)
        self.attn = MultiHeadDotProductAttention(dim, heads, dropout, dtype)
        self.norm2 = LayerNorm(dim, 1e-6, dtype)
        self.mlp_fc1 = dense(dim, int(dim * mlp_ratio), dtype)
        self.mlp_fc2 = dense(int(dim * mlp_ratio), dim, dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), deterministic,
                          fold_seed(dropout_seed, 0))
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)),
                                approximate="none"))
        h = dropout(h, self.rate, fold_seed(dropout_seed, 1), deterministic)
        return x + h


class ViT(nn.Module):
    """Config-shaped ViT encoder; returns (cls, tokens)."""

    def __init__(self, image_size: int = 384, patch_size: int = 16,
                 dim: int = 768, depth: int = 12, heads: int = 12,
                 mlp_ratio: float = 4.0, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None,
                 quant: Optional[str] = None):
        super().__init__()
        self.image_size, self.patch_size = image_size, patch_size
        self.dim, self.depth, self.heads = dim, depth, heads
        self.mlp_ratio, self.rate, self.dtype = mlp_ratio, float(dropout), dtype
        self.patch_embed = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        n_patches = (image_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", ViTBlock(
                dim, heads, mlp_ratio, dropout, dtype, quant))
        self.norm = LayerNorm(dim, 1e-6, dtype)

    @property
    def num_features(self) -> int:
        return self.dim

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        images = maybe_normalize_uint8(images)
        dt = self.dtype or images.dtype
        x = F.conv2d(_nchw(images).to(dt), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=self.patch_size)
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, h*w, D], rows of patches
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, -1, -1), x], 1)
        x = x + self.pos_embed.to(x.dtype)
        x = dropout(x, self.rate, fold_seed(dropout_seed, 0), deterministic)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, deterministic,
                                            fold_seed(dropout_seed, i + 1))
        x = self.norm(x)
        return x[:, 0], x[:, 1:]


# ---------------------------------------------------------------- shared
class StdConv(nn.Module):
    """ScaledStdConv2d (timm 0.6.5 layers/std_conv.py):

    ``w_hat = (w - mean) / sqrt(var + eps) * gain * gamma / sqrt(fan_in)``

    with mean and biased var per output channel over the fan-in, computed
    in fp32 and cast to the input's dtype; ``gamma`` is the activation's
    variance-preserving gain folded into the weight."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: int = 1, groups: int = 1,
                 use_bias: bool = True, gamma: float = 1.0, eps: float = 1e-5,
                 gain_init: float = 1.0):
        super().__init__()
        kh, kw = kernel
        self.kernel, self.strides, self.groups = (kh, kw), strides, groups
        self.gamma, self.eps, self.gain_init = gamma, eps, gain_init
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kh, kw))
        self.gain = nn.Parameter(torch.full((features,), float(gain_init)))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def standardized(self) -> torch.Tensor:
        w = self.weight.float()
        fan_in = w[0].numel()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        scale = (self.gain.float() * (self.gamma * fan_in ** -0.5)
                 ).view(-1, 1, 1, 1) * torch.rsqrt(var + self.eps)
        return (w - mean) * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x, self.standardized().to(x.dtype), None,
                       self.strides, _torch_pad(self.kernel[0], self.strides),
                       groups=self.groups)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype).view(-1, 1, 1)
        return out


class PlainConv(nn.Module):
    """timm ``create_conv2d``: a bias-free conv, torch padding."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int], strides: int = 1, groups: int = 1):
        super().__init__()
        kh, kw = kernel
        self.kernel, self.strides, self.groups = (kh, kw), strides, groups
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kh, kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.strides,
                        _torch_pad(self.kernel[0], self.strides),
                        groups=self.groups)


# -------------------------------------------------------------- ResNetV2
class AffineAct(nn.Module):
    """Folded frozen BatchNormAct2d: per-channel ``x * scale + bias`` and
    ReLU; (1, 0) at init."""

    def __init__(self, features: int, apply_act: bool = True):
        super().__init__()
        self.apply_act = apply_act
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x * self.scale.to(x.dtype).view(-1, 1, 1)
             + self.bias.to(x.dtype).view(-1, 1, 1))
        return F.relu(x) if self.apply_act else x


class PreActBottleneck(nn.Module):
    """timm 0.6.5 PreActBottleneck: norm1 -> (downsample of the
    pre-activated input) / conv1 -> norm2 -> conv2 -> norm3 -> conv3."""

    def __init__(self, in_features: int, features: int, out_features: int,
                 strides: int = 1):
        super().__init__()
        self.norm1 = AffineAct(in_features)
        self.downsample = None
        if in_features != out_features or strides != 1:
            self.downsample = PlainConv(in_features, out_features, (1, 1),
                                        strides)
        self.conv1 = PlainConv(in_features, features, (1, 1))
        self.norm2 = AffineAct(features)
        self.conv2 = PlainConv(features, features, (3, 3), strides)
        self.norm3 = AffineAct(features)
        self.conv3 = PlainConv(features, out_features, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_preact = self.norm1(x)
        shortcut = x if self.downsample is None else self.downsample(x_preact)
        h = self.conv1(x_preact)
        h = self.conv2(self.norm2(h))
        h = self.conv3(self.norm3(h))
        return h + shortcut


class ResNetV2(nn.Module):
    """timm ``resnetv2_50`` structure; returns the pooled feature."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.depths, self.width = tuple(depths), width
        self.stem_conv = PlainConv(3, width, (7, 7), 2)
        prev = width
        for i, depth in enumerate(self.depths):
            features = width * (2 ** i)
            for j in range(depth):
                strides = 2 if (j == 0 and i > 0) else 1
                self.add_module(f"stage{i}_block{j}", PreActBottleneck(
                    prev, features, features * 4, strides))
                prev = features * 4
        self.norm = AffineAct(prev)

    @property
    def num_features(self) -> int:
        return self.width * 2 ** (len(self.depths) - 1) * 4

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        x = self.stem_conv(_nchw(maybe_normalize_uint8(images)))
        # torch MaxPool2d(3, 2, padding=1): -inf padding, floor division
        x = F.max_pool2d(x, 3, 2, 1)
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
        return _pool_hw(self.norm(x))


# ----------------------------------------------------------------- NFNet
class ECA(nn.Module):
    """Efficient Channel Attention (timm EcaModule): a bias-free 1-d conv
    over the per-channel mean, sigmoid gate.  ``conv`` is the kernel as a
    Conv1d weight ``[1, 1, k]``."""

    def __init__(self, kernel_size: int = 5):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv = nn.Parameter(torch.empty(1, 1, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _pool_hw(x)[:, None, :]  # [B, 1, C]
        y = F.conv1d(y, self.conv.to(y.dtype),
                     padding=_torch_pad(self.kernel_size)[0])[:, 0]
        return x * torch.sigmoid(y)[:, :, None, None]


def eca_kernel_size(channels: int, gamma: int = 2, beta: int = 1) -> int:
    """timm EcaModule adaptive kernel: odd(|log2(C)+beta|/gamma), min 3."""
    t = int(abs(math.log(channels, 2) + beta) / gamma)
    return max(t if t % 2 else t + 1, 3)


def make_divisible(v, divisor: int = 8, min_value=None,
                   round_limit: float = 0.9) -> int:
    """timm layers/helpers.py make_divisible — exact."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


class NFBlock(nn.Module):
    """timm 0.6.5 NormFreeBlock (reg=False, extra_conv=True,
    skipinit=False): ``out = silu(x) * beta``; the shortcut is
    downsample(out) (2x2 average pool where strided, then a 1x1 StdConv)
    or x; the residual is conv3(silu(conv2b(silu(conv2(silu(conv1(out)))))))
    with grouped 3x3 convs, and ``shortcut + attn_gain * eca(residual) *
    alpha`` comes out.  conv3's gain starts at 0."""

    def __init__(self, in_features: int, out_features: int,
                 bottleneck_ratio: float = 0.25, group_size: int = 64,
                 strides: int = 1, alpha: float = 0.2, beta: float = 1.0,
                 attn_gain: float = 2.0):
        super().__init__()
        # timm: mid_chs = make_divisible(out_chs * bottle_ratio); groups =
        # mid_chs // group_size; mid_chs re-snapped to group_size * groups
        width = make_divisible(out_features * bottleneck_ratio)
        groups = max(width // group_size, 1)
        width = groups * group_size if width >= group_size else width
        self.strides, self.alpha, self.beta = strides, alpha, beta
        self.attn_gain = attn_gain

        def conv(cin, f, k, s=1, g=1, **kw):
            return StdConv(cin, f, (k, k), s, groups=g, gamma=_SILU_GAMMA,
                           **kw)

        self.downsample = None
        if strides != 1 or in_features != out_features:
            self.downsample = conv(in_features, out_features, 1)
        self.conv1 = conv(in_features, width, 1)
        self.conv2 = conv(width, width, 3, strides, groups)
        self.conv2b = conv(width, width, 3, 1, groups)
        self.conv3 = conv(width, out_features, 1, gain_init=0.0)
        self.attn_last = ECA(eca_kernel_size(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(x) * self.beta
        shortcut = x
        if self.downsample is not None:
            s = F.avg_pool2d(h, 2, 2) if self.strides != 1 else h
            shortcut = self.downsample(s)
        h = self.conv1(h)
        h = self.conv2(F.silu(h))
        h = self.conv2b(F.silu(h))
        h = self.conv3(F.silu(h))
        h = self.attn_gain * self.attn_last(h)
        return shortcut + h * self.alpha


class NFNet(nn.Module):
    """timm ``eca_nfnet_l0``-shaped normaliser-free net; the pooled
    ``channels[-1] * feat_mult`` features out (2304 at the defaults)."""

    def __init__(self, depths: Sequence[int] = (1, 2, 6, 3),
                 channels: Sequence[int] = (256, 512, 1536, 1536),
                 group_size: int = 64, alpha: float = 0.2,
                 stem_chs: int = 128, feat_mult: float = 1.5):
        super().__init__()
        self.depths, self.channels = tuple(depths), tuple(channels)
        self.group_size, self.alpha = group_size, alpha
        self.stem_chs, self.feat_mult = stem_chs, feat_mult

        def conv(cin, f, k, s=1):
            return StdConv(cin, f, (k, k), s, gamma=_SILU_GAMMA)

        # deep_quad stem (timm create_stem): 3x3 convs at strides 2, 1, 1, 2
        # with out/8, out/4, out/2 and out channels; silu between them
        c = stem_chs
        self.stem0 = conv(3, c // 8, 3, 2)
        self.stem1 = conv(c // 8, c // 4, 3)
        self.stem2 = conv(c // 4, c // 2, 3)
        self.stem3 = conv(c // 2, c, 3, 2)
        # timm variance bookkeeping: beta from the running expected_var,
        # reset to 1 after each stage's first block, += alpha^2 a block
        expected_var, prev = 1.0, c
        for i, (depth, ch) in enumerate(zip(self.depths, self.channels)):
            for j in range(depth):
                beta = 1.0 / expected_var ** 0.5
                # the stem's stride is 4, so stage 0 keeps stride 1
                strides = 2 if (j == 0 and i > 0) else 1
                self.add_module(f"stage{i}_block{j}", NFBlock(
                    prev, ch, group_size=group_size, strides=strides,
                    alpha=alpha, beta=beta))
                if j == 0:
                    expected_var = 1.0
                expected_var += alpha ** 2
                prev = ch
        self.final_conv = conv(prev, self.num_features, 1)

    @property
    def num_features(self) -> int:
        return int(self.channels[-1] * self.feat_mult)

    def forward(self, images: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        x = self.stem0(_nchw(maybe_normalize_uint8(images)))
        x = self.stem1(F.silu(x))
        x = self.stem2(F.silu(x))
        x = self.stem3(F.silu(x))
        for i, depth in enumerate(self.depths):
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
        return _pool_hw(F.silu(self.final_conv(x)))


BACKBONES = {
    # config-faithful shapes: the reference builds its ViT from the JSON
    # config (hidden_size, num_hidden_layers, num_attention_heads)
    "vit": lambda cfg: ViT(image_size=cfg.image_size,
                           patch_size=cfg.patch_size, dim=cfg.hidden_size,
                           depth=cfg.num_hidden_layers,
                           heads=cfg.num_attention_heads,
                           mlp_ratio=cfg.intermediate_size / cfg.hidden_size,
                           dropout=cfg.hidden_dropout_prob,
                           dtype=torch.bfloat16 if cfg.dtype == "bfloat16"
                           else None, quant=cfg.quant),
    "resnet": lambda cfg: ResNetV2(),
    "nfnet": lambda cfg: NFNet(),
}


def backbone_for(name: str, cfg: ModelConfig) -> nn.Module:
    for key, fn in BACKBONES.items():
        if key in name:
            return fn(cfg)
    raise ValueError(f"unknown image backbone: {name} (want vit/resnet/nfnet)")


def init_image_weights(module: nn.Module, generator: torch.Generator
                       ) -> None:
    """Flax's initialisers: StdConv and PlainConv kernels He normal
    (truncated at 2 sigma, variance 2/fan_in), the ViT patch conv and the
    Dense kernels LeCun normal, biases 0, StdConv gains ``gain_init``, ECA
    kernels normal(0.02), ``cls_token`` 0 and ``pos_embed`` normal(0.02);
    LayerNorm and AffineAct at (1, 0)."""
    def trunc(w, scale):
        dev = (scale / w[0].numel()) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, dev, -2.0 * dev, 2.0 * dev,
                              generator=generator)

    init_weights(module, 0.02, generator)  # Dense and LayerNorm
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (StdConv, PlainConv)):
                trunc(m.weight, 2.0)
                if isinstance(m, StdConv):
                    m.gain.fill_(m.gain_init)
                    if m.bias is not None:
                        m.bias.zero_()
            elif isinstance(m, ViT):
                trunc(m.patch_embed.weight, 1.0)
                m.patch_embed.bias.zero_()
                m.cls_token.zero_()
                m.pos_embed.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, ECA):
                m.conv.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, AffineAct):
                m.scale.fill_(1.0)
                m.bias.zero_()


class ImageTwoTower(nn.Module):
    """One image tower shared by both items, its pooled features (ViT's
    CLS) in fp32 into the two-tower head and the pair loss.  The tower is
    the submodule ``NFNet_0``, ``ResNetV2_0`` or ``ViT_0``, as flax names
    it, and the head ``classifier``."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            tower = backbone_for(config.image_model_name, config)
            self.tower_name = f"{type(tower).__name__}_0"
            self.add_module(self.tower_name, tower)
            self.classifier = TwoTowerClassificationHead(
                tower.num_features, dropout_rate=config.hidden_dropout_prob,
                num_labels=config.num_labels)
        if seed is not None:
            init_image_weights(self, torch.Generator(device=dev)
                               .manual_seed(seed))

    @property
    def tower(self) -> nn.Module:
        return getattr(self, self.tower_name)

    def features(self, images: torch.Tensor, deterministic: bool = True,
                 dropout_seed: Optional[int] = None) -> torch.Tensor:
        """The tower's pooled fp32 features of NHWC images: uint8 images
        normalised first, then cast to bf16 under ``dtype="bfloat16"``."""
        images = maybe_normalize_uint8(images)
        if self.config.dtype == "bfloat16":
            images = images.to(torch.bfloat16)
        f = self.tower(images, deterministic, dropout_seed)
        if isinstance(f, tuple):  # ViT returns (cls, tokens)
            f = f[0]
        return f.float()

    def forward(self, images_1, images_2, labels=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        cfg = self.config
        f1 = self.features(images_1, deterministic, fold_seed(dropout_seed, 0))
        f2 = self.features(images_2, deterministic, fold_seed(dropout_seed, 1))
        src_embeds, tgt_embeds, logits, probs = self.classifier(
            f1, f2, deterministic, fold_seed(dropout_seed, 2))
        probs_pos = probs[:, 1]
        loss = None
        if labels is not None:
            loss = pair_loss(cfg.loss_type, logits, probs_pos, labels,
                             src_embeds, tgt_embeds, cfg.loss_margin,
                             cfg.num_labels)
        return PairClassifierOutput(loss=loss, logits=logits, probs=probs_pos,
                                    src_embeds=src_embeds,
                                    tgt_embeds=tgt_embeds)
