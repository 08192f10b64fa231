"""The plain reference: RoBERTa's embeddings (with the image splice of
``ensemble == "begin"``), the post-LayerNorm encoder, the one-tower
classification head with its cross-entropy, and the two-tower head, as
plain PyTorch operations on a dict of weights named as the port's state
dict.

It computes in fp32 with TF32 off (``precision="fp32"``), materialises the
attention scores and softmax, and regenerates the program's dropout masks
from the step's seed (``reference/dropout.py``).  ``precision="fp8"`` is
the control, the encoder computed a precision below the configuration's
bf16: wherever the program holds a bf16 tensor (the encoder's input, every
product's operands and outputs, the residual sums, LayerNorm and GELU
outputs) the value is rounded to float8 e4m3 with a per-tensor scale, and
its gradient to e5m2 on the way back; the attention scores and softmax
and the heads stay fp32, as in the program.

A batch is run in blocks of rows; the dropout draws are made over the whole
batch and sliced, and the loss of a block is its rows' share of the whole
batch's mean, so the gradients of the blocks add up to the whole batch's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.dropout import (
    attention_keep,
    dropout_consts,
    fold_seed,
    head_keep,
    hidden_keep,
)

Weights = Dict[str, torch.Tensor]
NEG_INF = -1e9


def fp32_exact() -> None:
    """fp32 products in fp32: TF32 off for matrix products and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


def rnd(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A point where the program rounds to its compute dtype."""
    return _Fp8.apply(x) if precision == "fp8" else x


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return rnd(a, precision) @ rnd(b, precision)


def linear(x, w: Weights, name: str, precision: str) -> torch.Tensor:
    return mm(x, w[name + ".weight"].t(), precision) + w[name + ".bias"]


def layer_norm(x, w: Weights, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"],
                        w[name + ".bias"], eps)


@dataclass
class Drops:
    """Where a block sits in the batch, and the dropout of a train step
    (``seed`` None: evaluation, nothing dropped)."""
    rows: slice
    total: int
    seed: Optional[int] = None
    rate: float = 0.0

    @property
    def on(self) -> bool:
        return self.seed is not None and self.rate > 0.0


def _hidden_dropout(x, drops: Drops, seed: int):
    if not drops.on:
        return x
    keep = hidden_keep(seed, (drops.total,) + tuple(x.shape[1:]), drops.rows,
                       x.device, drops.rate)
    return torch.where(keep, x / dropout_consts(drops.rate)[1],
                       torch.zeros_like(x))


def _head_dropout(x, drops: Drops, seed: int):
    if not drops.on:
        return x
    keep = head_keep(seed, (drops.total,) + tuple(x.shape[1:]), drops.rows,
                     x.device, drops.rate)
    return torch.where(keep, x / (1.0 - drops.rate), torch.zeros_like(x))


def embeddings(w: Weights, cfg: Dict, ids, mask, token_types, drops: Drops,
               seed: Optional[int], images: Optional[Tuple] = None,
               image_indices=None) -> torch.Tensor:
    """Word + token-type + position embeddings, LayerNorm, dropout.
    Positions count the unmasked tokens (``cumsum(mask) * mask + pad``);
    with ``images`` the projected src image replaces position 1 and the
    tgt image position ``image_indices``."""
    p = "roberta.embeddings."
    x = w[p + "word_embeddings.weight"][ids]
    if images is not None:
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :, None]
        src = images[0] @ w[p + "img2txt.weight"].t() + w[p + "img2txt.bias"]
        tgt = images[1] @ w[p + "img2txt.weight"].t() + w[p + "img2txt.bias"]
        x = torch.where(pos == 1, src[:, None, :], x)
        x = torch.where(pos == image_indices[:, None, None], tgt[:, None, :],
                        x)
    positions = torch.cumsum(mask, dim=1) * mask + cfg["pad_token_id"]
    if token_types is None:
        token_types = torch.zeros_like(ids)
    x = (x + w[p + "post.token_type_embeddings.weight"][token_types]
         + w[p + "post.position_embeddings.weight"][positions])
    x = layer_norm(x, w, p + "post.layer_norm", cfg["layer_norm_eps"])
    return _hidden_dropout(x, drops, seed)


def attention(q, k, v, bias, heads: int, drops: Drops, seed, precision):
    B, S, H = q.shape
    D = H // heads
    q, k, v = (t.reshape(B, S, heads, D).transpose(1, 2) for t in (q, k, v))
    scores = mm(q, k.transpose(-1, -2), precision) / math.sqrt(D) + bias
    probs = torch.softmax(scores, dim=-1)
    if drops.on:
        keep = attention_keep(seed, drops.rows, heads, S, drops.rate, q.device)
        probs = torch.where(keep, probs, torch.zeros_like(probs)) \
            / dropout_consts(drops.rate)[1]
    return mm(probs, v, precision).transpose(1, 2).reshape(B, S, H)


def encoder(w: Weights, cfg: Dict, h, mask, drops: Drops, seed, precision
            ) -> torch.Tensor:
    """The post-LN layers; returns the last hidden state."""
    bias = ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    def r(x):
        return rnd(x, precision)

    h = r(h)
    for i in range(cfg["num_hidden_layers"]):
        p = f"roberta.encoder.layer_{i}."
        ls = fold_seed(seed, i)
        q, k, v = (r(linear(h, w, p + "attention." + n, precision))
                   for n in ("query", "key", "value"))
        ctx = r(attention(q, k, v, bias, heads, drops, fold_seed(ls, 0),
                          precision))
        a = r(linear(ctx, w, p + "attention.output", precision))
        a = _hidden_dropout(a, drops, fold_seed(ls, 1))
        h = r(layer_norm(r(h + a), w, p + "attention_layer_norm", eps))
        m = r(F.gelu(r(linear(h, w, p + "intermediate", precision))))
        m = r(linear(m, w, p + "mlp_output", precision))
        m = _hidden_dropout(m, drops, fold_seed(ls, 2))
        h = r(layer_norm(r(h + m), w, p + "output_layer_norm", eps))
    return h


def one_tower_logits(w: Weights, cfg: Dict, batch: Dict[str, torch.Tensor],
                     drops: Drops, precision: str = "fp32") -> torch.Tensor:
    """Logits ``[rows, labels]`` of the cross-encoder (and of the image
    cross-encoder when ``batch`` holds image features) under the step
    seed ``drops.seed``: the backbone takes fold 0 of it (embeddings fold
    0, encoder fold 1), the head fold 1."""
    ds = drops.seed
    rs = fold_seed(ds, 0)
    images = None
    if "src_image_embeds" in batch:
        images = (batch["src_image_embeds"], batch["tgt_image_embeds"])
    h = embeddings(w, cfg, batch["input_ids"], batch["attention_mask"],
                   batch.get("token_type_ids"), drops, fold_seed(rs, 0),
                   images, batch.get("image_indices"))
    h = encoder(w, cfg, h, batch["attention_mask"], drops, fold_seed(rs, 1),
                precision)
    hs = fold_seed(fold_seed(ds, 1), 0)
    x = _head_dropout(h[:, 0], drops, fold_seed(hs, 0))
    x = torch.tanh(linear(x, w, "head.classifier.dense", "fp32"))
    x = _head_dropout(x, drops, fold_seed(hs, 1))
    return linear(x, w, "head.classifier.out_proj", "fp32")


def block_loss(logits: torch.Tensor, labels: torch.Tensor, total: int
               ) -> torch.Tensor:
    """The block's share of the whole batch's mean cross-entropy."""
    nll = -torch.gather(F.log_softmax(logits, dim=-1), 1,
                        labels[:, None].long())
    return nll.sum() / total


def item_embedding(w: Weights, cfg: Dict, ids, mask, precision: str = "fp32"
                   ) -> torch.Tensor:
    """The two-tower item encoder: the last layer's [CLS] state."""
    drops = Drops(rows=slice(0, ids.shape[0]), total=ids.shape[0])
    h = embeddings(w, cfg, ids, mask, None, drops, None)
    return encoder(w, cfg, h, mask, drops, None, precision)[:, 0]


def two_tower_probs(w: Weights, src, tgt) -> torch.Tensor:
    logits = (torch.cat((src, tgt), dim=-1) @ w["classifier.out_proj.weight"].t()
              + w["classifier.out_proj.bias"])
    return torch.softmax(logits, dim=-1)[:, 1]
