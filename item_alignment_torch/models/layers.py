"""Dense and LayerNorm with Flax's dtype rules.

Parameters are stored in fp32.  ``Dense(dtype=bf16)`` casts both its input
and its parameters to bf16 before the product, as ``flax.linen.Dense`` does;
with ``dtype=None`` it computes in the promoted type of input and
parameters.  ``LayerNorm`` computes its statistics in fp32 (mean and
E[x^2] - mean^2, clipped at 0) and returns ``dtype``, or the input's
promoted type when ``dtype`` is None.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """``weight [out, in]`` and ``bias [out]``, the transpose of Flax's
    ``kernel [in, out]``.  ``init_std`` is the normal init's deviation;
    None means Flax's default, LeCun normal."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None,
                 init_std: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype
        self.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))


def compute_dtype(cfg) -> torch.dtype:
    """The config's compute dtype for the encoder (parameters stay fp32)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@torch.no_grad()
def init_weights(module: nn.Module, std: float,
                 generator: torch.Generator) -> None:
    """Flax's initialisers: embeddings normal(std); Dense kernels
    normal(init_std) or LeCun normal (truncated at 2 sigma), biases 0;
    LayerNorm scale 1, bias 0."""
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, std, generator=generator)
        elif isinstance(m, Dense):
            if m.init_std is not None:
                m.weight.normal_(0.0, m.init_std, generator=generator)
            else:
                # flax lecun_normal: truncated normal with variance 1/fan_in
                dev = (1.0 / m.weight.shape[1]) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, dev, -2.0 * dev,
                                      2.0 * dev, generator=generator)
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
