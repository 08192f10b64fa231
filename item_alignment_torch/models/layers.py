"""Dense and LayerNorm with Flax's dtype rules, and the embedding lookup.

Parameters are stored in fp32.  ``Dense(dtype=bf16)`` casts both its input
and its parameters to bf16 before the product, as ``flax.linen.Dense`` does;
with ``dtype=None`` it computes in the promoted type of input and
parameters.  ``LayerNorm`` computes its statistics in fp32 (mean and
E[x^2] - mean^2, clipped at 0) and returns ``dtype``, or the input's
promoted type when ``dtype`` is None.

``embedding_lookup`` reads rows of an ``nn.Embedding``'s table and sums its
gradient in a fixed order; ``take_rows`` does the same for any tensor whose
first dimension it indexes (the KGE tables, ``[n, d]`` or ``[n, d, d]``).
torch's own embedding backward on CUDA sums the duplicates of a row
(thousands for the pad token, the pad position and the token types) in an
order that changes from run to run, which would break bit-for-bit repeat and
resume.  Here the gradient of a small table read by few ids is a one-hot
matrix product, and otherwise a stable sort of the ids followed by
``torch.segment_reduce``, which adds each row's duplicates in turn
(``index_put_`` with ``accumulate=True`` is as repeatable but took 23 ms of
a RoBERTa-large train step on an H100 against about 2 ms for these).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from item_alignment_torch.engine.observability import span
from item_alignment_torch.ops.layer_norm import layer_norm
from item_alignment_torch.utils.flops import count_as


ONE_HOT_ROWS = 2048  # tables up to this many rows take the one-hot product
# ... unless the one-hot matrix (rows x ids) would exceed this many elements
ONE_HOT_ELEMS = 1 << 25


class _EmbeddingLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).long()
        g = g.reshape(flat.shape[0], -1)
        n = ctx.shape[0]
        rows = torch.arange(n, device=g.device)
        if n <= ONE_HOT_ROWS and n * flat.shape[0] <= ONE_HOT_ELEMS:
            # a scatter-add as a product: no model FLOP, as JAX counts the
            # transpose of its gather
            grad = count_as(0, torch.matmul,
                            (rows[:, None] == flat[None, :]).to(g.dtype), g)
        else:
            order = torch.sort(flat, stable=True).indices
            lengths = torch.zeros_like(rows).index_add_(0, flat,
                                                        torch.ones_like(flat))
            grad = torch.segment_reduce(g[order], "sum", lengths=lengths,
                                        axis=0, unsafe=True)
        return grad.reshape(ctx.shape), None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with a gradient that repeats run to run."""
    return _EmbeddingLookup.apply(table, ids)


def embedding_lookup(table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``table.weight[ids]`` with a gradient that repeats run to run."""
    return take_rows(table.weight, ids)


class Dense(nn.Linear):
    """``weight [out, in]`` and ``bias [out]``, the transpose of Flax's
    ``kernel [in, out]``.  ``init_std`` is the normal init's deviation;
    None means Flax's default, LeCun normal.  ``use_bias=False`` has no
    bias, as Flax's ``use_bias=False``.  An ``nn.Linear`` (whose own
    initialisation it skips), so that torch's tensor-parallel styles
    (``parallel/sharding.py``) take it."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None,
                 init_std: Optional[float] = None, use_bias: bool = True):
        nn.Module.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(out_features)) if use_bias
            else None)
        self.dtype = dtype
        self.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        with span("cast"):
            bias = None if self.bias is None else self.bias.to(dt)
            x, weight = x.to(dt), self.weight.to(dt)
        return F.linear(x, weight, bias)


class StackedDense(nn.Module):
    """``layers`` bias-free Dense kernels of one shape in one parameter,
    ``weight [layers, out, in]``: the layer stack that Flax's ``nn.scan``
    makes of a Dense (``kernel [layers, in, out]``).  ``forward(x, l)``
    applies layer ``l``'s kernel."""

    def __init__(self, layers: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(layers, out_features,
                                               in_features))

    def forward(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        with span("cast"):
            weight = self.weight[layer].to(x.dtype)
        return F.linear(x, weight)


class LayerNorm(nn.Module):
    """``use_bias=False`` has no bias, as Flax's ``use_bias=False``.  On
    CUDA the forward and backward are the kernels of ``ops/layer_norm.py``;
    on the CPU its plain version."""

    def __init__(self, features: int, eps: float,
                 dtype: Optional[torch.dtype] = None, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("layernorm"):
            return layer_norm(x, self.weight, self.bias, self.eps,
                              self.dtype)


def compute_dtype(cfg) -> torch.dtype:
    """The config's compute dtype for the encoder (parameters stay fp32)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@torch.no_grad()
def init_weights(module: nn.Module, std: float,
                 generator: torch.Generator) -> None:
    """Flax's initialisers: embeddings normal(std); Dense kernels
    normal(init_std) or LeCun normal (truncated at 2 sigma), biases 0, and
    each kernel of a ``StackedDense`` LeCun normal;
    ``nn.Conv1d`` kernels LeCun normal over a fan-in of in_channels x
    kernel size, biases 0; LayerNorm scale 1, bias 0."""
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
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, StackedDense):
            dev = (1.0 / m.weight.shape[2]) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, dev, -2.0 * dev, 2.0 * dev,
                                  generator=generator)
        elif isinstance(m, nn.Conv1d):
            fan_in = m.weight.shape[1] * m.weight.shape[2]
            dev = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, dev, -2.0 * dev, 2.0 * dev,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
