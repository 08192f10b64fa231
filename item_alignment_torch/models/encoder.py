"""BERT/RoBERTa-style post-LN transformer encoder.

Port of ``item_alignment_tpu/models/encoder.py``.  Attention runs through
``ops.attention.flash_attention``, which launches the fused CUDA kernels on
the card.  Parameter names follow the Flax tree (``layer_{i}.attention.query``
...), so converted checkpoints load as they are.  With ``config.quant ==
"int8"`` (inference only) the dense projections are ``QuantDense``: the same
parameters, the product on the int8 path of ``ops/quant.py``.  ``Pooler`` is
HF's dense + tanh over [CLS], for ``pred-text``.

Training: ``dropout_seed`` is the forward's seed; each layer folds in its
index and each site its place in the layer (``ops.dropout.fold_seed``).
``config.remat`` recomputes each layer in the backward with
``torch.utils.checkpoint``: ``remat_policy`` "full" recomputes the whole
layer, "dots" keeps every dense-projection product (the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``) and recomputes
the rest, and "mlp" is "dots" minus the [B, S, 4H] intermediate product.

Under tensor parallelism (``parallel/sharding.py``) q/k/v and
``intermediate`` are column-parallel and ``attention.output`` and
``mlp_output`` row-parallel: ``SelfAttention`` then runs on its rank's heads,
``head_offset`` onwards of ``num_attention_heads``, and hands both to the
attention kernels so that their dropout draws those heads' bits.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.engine.observability import span
from item_alignment_torch.models.layers import Dense, LayerNorm, compute_dtype
from item_alignment_torch.ops.attention import (
    dot_product_attention,
    flash_attention,
    make_attention_bias,
)
from item_alignment_torch.ops.dropout import ReplayDropout, fold_seed
from item_alignment_torch.ops.quant import int8_matmul, int8_matmul_tensor_parallel

ACT = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "swish": F.silu,
    "silu": F.silu,
}


class QuantDense(Dense):
    """``Dense`` with its product on the int8 path (``ops/quant.py``):
    dynamic per-token activation scales, per-channel weight scales, int32
    accumulation.  The parameters are ``Dense``'s, so fp32 checkpoints load
    unchanged; the input goes to the quantizer in its own dtype and the
    output is cast to ``dtype``, as the JAX package's ``QuantDense`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        if isinstance(self.weight, DTensor):
            return int8_matmul_tensor_parallel(x, self.weight, self.bias, dt)
        return int8_matmul(x, self.weight, self.bias, out_dtype=dt)


def _dense_cls(cfg: ModelConfig):
    """The encoder's dense-projection class: ``QuantDense`` under the
    inference knob ``cfg.quant == "int8"``, ``Dense`` otherwise."""
    if cfg.quant not in (None, "int8"):
        raise ValueError(f"unknown quant {cfg.quant!r}")
    return QuantDense if cfg.quant == "int8" else Dense


class SelfAttention(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        dt, H, std = compute_dtype(cfg), cfg.hidden_size, cfg.initializer_range
        dense = _dense_cls(cfg)
        self.query = dense(H, H, dt, std)
        self.key = dense(H, H, dt, std)
        self.value = dense(H, H, dt, std)
        self.output = dense(H, H, dt, std)
        self.head_offset = 0  # this rank's first head under tensor parallelism

    def _fused_qkv(self, hidden: torch.Tensor):
        """q, k and v of one [3H, H] product instead of three; the
        parameters stay separate, so checkpoints interchange with the
        unfused path.  Under tensor parallelism the product takes this
        rank's rows of each of the three, side by side, and its output
        splits by the local width."""
        dt = compute_dtype(self.config)
        parts = (self.query, self.key, self.value)
        w = [m.weight for m in parts]
        b = [m.bias for m in parts]
        if isinstance(w[0], DTensor):
            mesh = w[0].device_mesh
            w, b = (DTensor.from_local(torch.cat([t.to_local() for t in ts]),
                                       mesh, [Shard(0)], run_check=False)
                    for ts in (w, b))
            x = DTensor.from_local(hidden, mesh, [Replicate()],
                                   run_check=False)
            qkv = F.linear(x.to(dt), w.to(dt), b.to(dt)).to_local()
        else:
            qkv = F.linear(hidden.to(dt), torch.cat(w).to(dt),
                           torch.cat(b).to(dt))
        return qkv.split(qkv.shape[-1] // 3, dim=-1)

    def forward(self, hidden: torch.Tensor, bias: Optional[torch.Tensor],
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        B, S, H = hidden.shape
        D = cfg.head_dim
        if cfg.fuse_qkv and cfg.quant != "int8":
            # int8 quantizes each projection's activations on its own, as
            # the JAX package does
            q, k, v = self._fused_qkv(hidden)
        else:
            q, k, v = self.query(hidden), self.key(hidden), self.value(hidden)
        # [B, S, heads, D]: every head, or this rank's under tensor
        # parallelism
        q, k, v = (t.reshape(B, S, -1, D) for t in (q, k, v))
        attend = (flash_attention if cfg.use_flash_attention
                  else dot_product_attention)
        rate = 0.0 if deterministic else cfg.attention_probs_dropout_prob
        if rate > 0.0 and dropout_seed is None:
            raise ValueError("training-mode attention dropout needs a "
                             "dropout seed")
        ctx = attend(q, k, v, bias, dropout_rate=rate,
                     dropout_seed=dropout_seed if rate > 0.0 else None,
                     dtype=hidden.dtype, head_offset=self.head_offset,
                     num_heads=cfg.num_attention_heads)
        return self.output(ctx.reshape(B, S, -1))


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
        dense = _dense_cls(cfg)
        self.intermediate = dense(cfg.hidden_size, cfg.intermediate_size, dt,
                                  std)
        self.mlp_output = dense(cfg.intermediate_size, cfg.hidden_size, dt,
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
        mlp = self.intermediate(hidden)
        with span("gelu"):
            mlp = self.act(mlp)
        mlp = self.mlp_output(mlp)
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


class Pooler(nn.Module):
    """dense + tanh over [CLS] (HF ``RobertaPooler``), in fp32 as flax's
    ``nn.Dense`` with no dtype computes against fp32 parameters."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.dense = Dense(config.hidden_size, config.hidden_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))
