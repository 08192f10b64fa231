"""BERT/RoBERTa-style post-LN transformer encoder.

Port of ``item_alignment_tpu/models/encoder.py`` (serving half).  Attention
runs through ``ops.attention.flash_attention``, which launches the fused
CUDA kernel on the card.  Parameter names follow the Flax tree
(``layer_{i}.attention.query`` ...), so converted checkpoints load as they
are.  The int8 ``QuantDense`` path and layer recomputation (remat) are not
ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.models.layers import Dense, LayerNorm, compute_dtype
from item_alignment_torch.ops.attention import (
    dot_product_attention,
    flash_attention,
    make_attention_bias,
)
from item_alignment_torch.ops.dropout import ReplayDropout

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
                deterministic: bool = True) -> torch.Tensor:
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
        ctx = attend(q, k, v, bias, dropout_rate=rate, dtype=hidden.dtype)
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
                deterministic: bool = True) -> torch.Tensor:
        attn_out = self.attention(hidden, bias, deterministic)
        attn_out = self.dropout(attn_out, deterministic=deterministic)
        hidden = self.attention_layer_norm(hidden + attn_out)
        mlp = self.mlp_output(self.act(self.intermediate(hidden)))
        mlp = self.dropout(mlp, deterministic=deterministic)
        return self.output_layer_norm(hidden + mlp)


class TransformerEncoder(nn.Module):
    """Stack of post-LN layers; returns all hidden states (embeddings
    first), as HF's ``output_hidden_states=True`` does for ``cls_layers``."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        # config.remat only changes the backward pass, which the training
        # slice ports; the forward is the same with or without it
        self.num_layers = config.num_hidden_layers
        for i in range(config.num_hidden_layers):
            self.add_module(f"layer_{i}", TransformerLayer(config))

    def forward(self, hidden: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> List[torch.Tensor]:
        bias = None
        if attention_mask is not None:
            bias = make_attention_bias(attention_mask, dtype=torch.float32)
        states = [hidden]
        for i in range(self.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, bias, deterministic)
            states.append(hidden)
        return states
