"""KGE losses (torchkge ``utils/losses.py:12-122``).

Port of ``item_alignment_tpu/kge/losses.py``: margin (sum reduction),
logistic and binary cross-entropy over positive and negative scores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def margin_ranking_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                        margin: float = 1.0, reduction: str = "sum"
                        ) -> torch.Tensor:
    """torchkge ``MarginLoss``: sum(max(0, margin - pos + neg))."""
    loss = torch.clamp(margin - pos_scores + neg_scores, min=0.0)
    return loss.sum() if reduction == "sum" else loss.mean()


def logistic_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor
                  ) -> torch.Tensor:
    """mean(softplus(-pos)) + mean(softplus(neg)) (LogisticLoss)."""
    return F.softplus(-pos_scores).mean() + F.softplus(neg_scores).mean()


def binary_cross_entropy_loss(pos_scores: torch.Tensor,
                              neg_scores: torch.Tensor) -> torch.Tensor:
    """BCE on sigmoid(score): positives -> 1, negatives -> 0."""
    eps = 1e-7
    p = torch.clamp(torch.sigmoid(pos_scores), eps, 1 - eps)
    n = torch.clamp(torch.sigmoid(neg_scores), eps, 1 - eps)
    return -(torch.log(p).mean() + torch.log(1 - n).mean())


def kge_loss(kind: str, pos, neg, margin: float = 1.0) -> torch.Tensor:
    if kind == "margin":
        return margin_ranking_loss(pos, neg, margin)
    if kind == "logistic":
        return logistic_loss(pos, neg)
    if kind == "bce":
        return binary_cross_entropy_loss(pos, neg)
    raise ValueError(f"unknown kge loss {kind}")
