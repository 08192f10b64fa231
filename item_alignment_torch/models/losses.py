"""Pair-classification losses (port of ``item_alignment_tpu/models/losses.py``).

- ``ce``:        softmax cross-entropy over 2 logits vs integer label
- ``bce``:       sigmoid BCE on a scalar logit vs {0,1} label
- ``cosine``:    CosineEmbeddingLoss(src_emb, tgt_emb, y in {-1,1})
- ``hinge``:     mean(max(0, margin - y * x)) on a scalar score
- ``euclidean``: mean(x ** y) with y in {-1,1} (the reference literally
                 computes pow(input, target))
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """logits [B, C], labels [B] int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels[:, None].long()).mean()


def bce_with_logits_loss(logits: torch.Tensor, labels: torch.Tensor
                         ) -> torch.Tensor:
    """Elementwise sigmoid BCE, mean-reduced (torch BCEWithLogitsLoss)."""
    x = logits.float().reshape(-1)
    y = labels.float().reshape(-1)
    loss = torch.clamp(x, min=0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return loss.mean()


def cosine_embedding_loss(x1: torch.Tensor, x2: torch.Tensor,
                          target: torch.Tensor, margin: float = 0.0
                          ) -> torch.Tensor:
    """torch.nn.CosineEmbeddingLoss semantics; target in {-1, 1}."""
    x1, x2 = x1.float(), x2.float()
    cos = torch.sum(x1 * x2, dim=-1) / torch.clamp(
        torch.linalg.norm(x1, dim=-1) * torch.linalg.norm(x2, dim=-1),
        min=1e-8)
    target = target.float().reshape(cos.shape)
    pos = 1.0 - cos
    neg = torch.clamp(cos - margin, min=0.0)
    return torch.where(target > 0, pos, neg).mean()


def hinge_loss(scores: torch.Tensor, target: torch.Tensor,
               margin: float = 1.0) -> torch.Tensor:
    """mean(max(0, margin - y*x)), y in {-1,1}."""
    scores = scores.float().reshape(-1)
    target = target.float().reshape(-1)
    return torch.clamp(margin - scores * target, min=0.0).mean()


def euclidean_distance_loss(scores: torch.Tensor, target: torch.Tensor
                            ) -> torch.Tensor:
    """mean(x ** y), y in {-1,1}."""
    return torch.pow(scores.float().reshape(-1),
                     target.float().reshape(-1)).mean()


def pair_loss(
    loss_type: str,
    logits: torch.Tensor,
    probs: torch.Tensor,
    labels: torch.Tensor,
    src_embeds: Optional[torch.Tensor] = None,
    tgt_embeds: Optional[torch.Tensor] = None,
    margin: float = 0.0,
    num_labels: int = 2,
) -> torch.Tensor:
    """The reference's loss dispatch.

    - cosine:          loss(src_emb, tgt_emb, 2*labels-1)
    - ce:              CE(logits [B,2], labels)
    - hinge/euclidean: loss(logits.flat, 2*labels-1)
    - bce (default):   BCEWithLogits(logits.flat, labels.flat)
    """
    if loss_type == "cosine":
        return cosine_embedding_loss(src_embeds, tgt_embeds, labels * 2 - 1,
                                     margin)
    if loss_type == "ce":
        return cross_entropy_loss(logits.reshape(-1, num_labels),
                                  labels.reshape(-1))
    if loss_type == "hinge":
        return hinge_loss(logits, labels * 2 - 1, margin)
    if loss_type == "euclidean":
        return euclidean_distance_loss(logits, labels * 2 - 1)
    return bce_with_logits_loss(logits, labels)
