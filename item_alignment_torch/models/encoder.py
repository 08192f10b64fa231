"""BERT/RoBERTa-style post-LN transformer encoder.

Port of ``item_alignment_tpu/models/encoder.py``.  Attention runs through
``ops.attention.flash_attention``, which launches the fused CUDA kernels on
the card.  Parameter names follow the Flax tree (``layer_{i}.attention.query``
...), so converted checkpoints load as they are.  The int8 ``QuantDense``
path is not ported yet.

Training: ``dropout_seed`` is the forward's seed; each layer folds in its
index and each site its place in the layer (``ops.dropout.fold_seed``).
``config.remat`` recomputes each layer in the backward with
``torch.utils.checkpoint``: ``remat_policy`` "full" recomputes the whole
layer, "dots" keeps every dense-projection product (the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``) and recomputes
the rest, and "mlp" is "dots" minus the [B, S, 4H] intermediate product.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.models.layers import Dense, LayerNorm, compute_dtype
from item_alignment_torch.ops.attention import (
    dot_product_attention,
    flash_attention,
    make_attention_bias,
)
from item_alignment_torch.ops.dropout import ReplayDropout, fold_seed

ACT = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "swish": F.silu,
    "silu": F.silu,
}


class SelfAttention(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        if cfg.quant == "int8":
            raise NotImplementedError(
                "quant='int8' needs ops/quant and QuantDense, not ported yet "
                "(ROADMAP Queue 1 #7)")
        self.config = cfg
        dt, H, std = compute_dtype(cfg), cfg.hidden_size, cfg.initializer_range
        self.query = Dense(H, H, dt, std)
        self.key = Dense(H, H, dt, std)
        self.value = Dense(H, H, dt, std)
        self.output = Dense(H, H, dt, std)

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        B, S, H = hidden.shape
        N, D = cfg.num_attention_heads, cfg.head_dim
        if cfg.fuse_qkv:
            # one [3H, H] product instead of three; the parameters stay
            # separate, so checkpoints interchange with the unfused path
            dt = compute_dtype(cfg)
            w = torch.cat([self.query.weight, self.key.weight,
                           self.value.weight]).to(dt)
            b = torch.cat([self.query.bias, self.key.bias,
                           self.value.bias]).to(dt)
            qkv = F.linear(hidden.to(dt), w, b)
            q, k, v = (t.reshape(B, S, N, D) for t in qkv.split(H, dim=-1))
        else:
            q = self.query(hidden).reshape(B, S, N, D)
            k = self.key(hidden).reshape(B, S, N, D)
            v = self.value(hidden).reshape(B, S, N, D)
        attend = (flash_attention if cfg.use_flash_attention
                  else dot_product_attention)
        rate = 0.0 if deterministic else cfg.attention_probs_dropout_prob
        if rate > 0.0 and dropout_seed is None:
            raise ValueError("training-mode attention dropout needs a "
                             "dropout seed")
        ctx = attend(q, k, v, bias, dropout_rate=rate,
                     dropout_seed=dropout_seed if rate > 0.0 else None,
                     dtype=hidden.dtype)
        return self.output(ctx.reshape(B, S, H))


class TransformerLayer(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        dt, std = compute_dtype(cfg), cfg.initializer_range
        self.act = ACT[cfg.hidden_act]
        self.dropout = ReplayDropout(cfg.hidden_dropout_prob)
        self.attention = SelfAttention(cfg)
        # LN statistics are fp32; the output stays in the compute dtype
        self.attention_layer_norm = LayerNorm(cfg.hidden_size,
                                              cfg.layer_norm_eps, dt)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size, dt,
                                  std)
        self.mlp_output = Dense(cfg.intermediate_size, cfg.hidden_size, dt,
                                std)
        self.output_layer_norm = LayerNorm(cfg.hidden_size,
                                           cfg.layer_norm_eps, dt)

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        seed = dropout_seed
        attn_out = self.attention(hidden, bias, deterministic,
                                  fold_seed(seed, 0))
        attn_out = self.dropout(attn_out, fold_seed(seed, 1), deterministic)
        hidden = self.attention_layer_norm(hidden + attn_out)
        mlp = self.mlp_output(self.act(self.intermediate(hidden)))
        mlp = self.dropout(mlp, fold_seed(seed, 2), deterministic)
        return self.output_layer_norm(hidden + mlp)


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """"dots": save every 2-D product (the dense projections; attention's
    batched products are recomputed, as JAX's policy leaves them)."""
    if op in _PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _keep_products_but(wide: int):
    """"mlp": "dots" minus the product whose right operand is the
    [H, 4H] intermediate kernel."""

    def policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
        if (op in _PRODUCTS and args[-1].dim() == 2
                and args[-1].shape[-1] == wide):
            return CheckpointPolicy.PREFER_RECOMPUTE
        return _keep_products(ctx, op, *args, **kwargs)

    return policy


class TransformerEncoder(nn.Module):
    """Stack of post-LN layers; returns all hidden states (embeddings
    first), as HF's ``output_hidden_states=True`` does for ``cls_layers``."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.num_layers = config.num_hidden_layers
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", TransformerLayer(config))
        self.remat = config.remat
        policies = {"full": None, "dots": _keep_products,
                    "mlp": _keep_products_but(config.intermediate_size)}
        if config.remat_policy not in policies:
            raise ValueError(f"unknown remat_policy {config.remat_policy!r}")
        policy = policies[config.remat_policy]
        self._remat_kw = {} if policy is None else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, policy)}

    def forward(self, hidden: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> List[torch.Tensor]:
        bias = None
        if attention_mask is not None:
            bias = make_attention_bias(attention_mask, dtype=torch.float32)
        states = [hidden]
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            seed = fold_seed(dropout_seed, i)
            if self.remat and torch.is_grad_enabled():
                # the masks are functions of the seed, so the recomputation
                # draws the same ones without the RNG-state stash
                hidden = checkpoint(layer, hidden, bias, deterministic, seed,
                                    use_reentrant=False,
                                    preserve_rng_state=False, **self._remat_kw)
            else:
                hidden = layer(hidden, bias, deterministic, seed)
            states.append(hidden)
        return states
