"""Pair-classification heads.

Port of ``item_alignment_tpu/models/heads.py``.  Heads run in fp32 on hidden
states already cast to fp32.  Their dropout is flax's ``nn.Dropout`` at the
exact rate (``ops.dropout.dropout``): each call site folds its own number
into the head's ``dropout_seed``, as each call of a flax ``nn.Dropout``
draws a fresh key.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.models.layers import Dense
from item_alignment_torch.ops.dropout import dropout, fold_seed


def inner_product(x1: torch.Tensor, x2: torch.Tensor, normalize: bool = False
                  ) -> torch.Tensor:
    if normalize:
        x1 = x1 / torch.clamp(torch.linalg.norm(x1, dim=-1, keepdim=True),
                              min=1e-12)
        x2 = x2 / torch.clamp(torch.linalg.norm(x2, dim=-1, keepdim=True),
                              min=1e-12)
    return torch.sum(x1 * x2, dim=-1)


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor, eps: float = 1e-8
                      ) -> torch.Tensor:
    denom = torch.clamp(
        torch.linalg.norm(x1, dim=-1) * torch.linalg.norm(x2, dim=-1),
        min=eps)
    return torch.sum(x1 * x2, dim=-1) / denom


def pairwise_distance(x1: torch.Tensor, x2: torch.Tensor, p: int,
                      eps: float = 1e-6) -> torch.Tensor:
    # torch.nn.PairwiseDistance adds eps to the difference
    d = torch.abs(x1 - x2 + eps)
    if p == 1:
        return torch.sum(d, dim=-1)
    return torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=0.0))


def _head_rate(cfg: ModelConfig) -> float:
    return (cfg.classifier_dropout if cfg.classifier_dropout is not None
            else cfg.hidden_dropout_prob)


class VecSimClassificationHead(nn.Module):
    """Shared dense+tanh on two summary vectors (``in_features`` wide,
    by default ``config.num_cls_features``), then a similarity score.

    probs: inner_product -> sigmoid(sim); cosine -> (sim+1)/2;
    l1/l2 -> exp(-sim)."""

    def __init__(self, config: ModelConfig, in_features=None):
        super().__init__()
        self.config = config
        self.dense = Dense(in_features or config.num_cls_features,
                           config.hidden_size)
        self.rate = _head_rate(config)

    def forward(self, features_1, features_2, deterministic: bool = True,
                dropout_seed=None):
        def drop(x, site):
            return dropout(x, self.rate, fold_seed(dropout_seed, site),
                           deterministic)

        def proj(f, site):
            x = torch.tanh(self.dense(drop(f, site)))
            return drop(x, site + 1)

        x, y = proj(features_1, 0), proj(features_2, 2)
        sm = self.config.similarity_measure
        if sm == "inner_product":
            sim = inner_product(x, y)
            probs = torch.sigmoid(sim)
        elif sm == "cosine":
            sim = cosine_similarity(x, y)
            probs = (sim + 1.0) / 2.0
        elif sm == "l1":
            sim = pairwise_distance(x, y, p=1)
            probs = torch.exp(-sim)
        elif sm == "l2":
            sim = pairwise_distance(x, y, p=2)
            probs = torch.exp(-sim)
        else:
            raise ValueError(f"Unsupported similarity measure: {sm}")
        return x, y, sim, probs


class TwoTowerClassificationHead(nn.Module):
    """concat(two tower outputs) -> Linear(2F -> num_labels) -> softmax."""

    def __init__(self, in_features: int, dropout_rate: float = 0.0,
                 num_labels: int = 2):
        super().__init__()
        self.rate = float(dropout_rate)
        self.out_proj = Dense(2 * in_features, num_labels)

    def forward(self, features_1, features_2, deterministic: bool = True,
                dropout_seed=None):
        x = dropout(features_1, self.rate, fold_seed(dropout_seed, 0),
                    deterministic)
        y = dropout(features_2, self.rate, fold_seed(dropout_seed, 1),
                    deterministic)
        logits = self.out_proj(torch.cat((x, y), dim=-1))
        return x, y, logits, torch.softmax(logits, dim=-1)


class ClsClassificationHead(nn.Module):
    """[CLS] -> dropout -> dense -> tanh -> dropout -> out_proj.

    With ``ensemble == "end"`` the two raw image embeddings are concatenated,
    projected by ``dense_img`` (dropout, dense, tanh, dropout) and joined to
    the text features before ``out_proj``, whose input is then
    ``2 * hidden_size`` wide."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.end = config.ensemble == "end"
        self.dense = Dense(config.num_cls_features, config.hidden_size)
        if self.end:
            self.dense_img = Dense(2 * config.image_hidden_size,
                                   config.hidden_size)
        self.out_proj = Dense((1 + self.end) * config.hidden_size,
                              config.num_labels)
        self.rate = _head_rate(config)

    def forward(self, features, deterministic: bool = True,
                dropout_seed=None, image_embeds=None):
        def proj(x, dense, site):
            x = dropout(x, self.rate, fold_seed(dropout_seed, site),
                        deterministic)
            x = torch.tanh(dense(x))
            return dropout(x, self.rate, fold_seed(dropout_seed, site + 1),
                           deterministic)

        x = proj(features[:, 0, :], self.dense, 0)
        if self.end:
            y = proj(torch.cat(image_embeds, dim=-1), self.dense_img, 2)
            x = torch.cat((x, y), dim=-1)
        return self.out_proj(x)


class AuxiliaryPairHead(nn.Module):
    """Auxiliary aligned-pv-pair task.  ``pair_spans [B, P, 5]`` =
    (src_start, src_end, tgt_start, tgt_end, label), padded with -1 rows;
    span mean-pools are one masked product.  Returns
    (logits [B,P,C], labels [B,P], valid [B,P])."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.out_proj = Dense(2 * config.num_cls_features, config.num_labels)
        self.rate = _head_rate(config)

    def forward(self, sequence_output: torch.Tensor, pair_spans: torch.Tensor,
                deterministic: bool = True, dropout_seed=None):
        S = sequence_output.shape[1]
        t = torch.arange(S, device=sequence_output.device)[None, None, :]
        seq = sequence_output.float()

        def span_mean(starts, ends):
            w = ((t >= starts[..., None]) & (t < ends[..., None])).float()
            width = torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
            return torch.einsum("bps,bsh->bph", w / width, seq)

        x = span_mean(pair_spans[..., 0], pair_spans[..., 1])
        y = span_mean(pair_spans[..., 2], pair_spans[..., 3])
        x = dropout(x, self.rate, fold_seed(dropout_seed, 0), deterministic)
        y = dropout(y, self.rate, fold_seed(dropout_seed, 1), deterministic)
        logits = self.out_proj(torch.cat((x, y), dim=-1))
        labels = torch.clamp(pair_spans[..., 4], min=0)
        valid = pair_spans[..., 0] >= 0
        return logits, labels, valid


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid entries (0 if none valid)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    v = valid.float()
    return torch.sum(nll * v) / torch.clamp(torch.sum(v), min=1.0)
