"""The graph model: GCNII over the item/attribute graph.

Port of ``item_alignment_tpu/models/graph.py`` (``GCN2Layer``, ``GCNII``,
``GCNTwoTower``).  A GCN2Conv layer l (PyG semantics, shared weights):

    h   = A_hat @ x                      (``ops/sparse.py:spmm``)
    s   = (1 - alpha) * h + alpha * x0
    out = (1 - beta_l) * s + beta_l * (s @ W_l),  beta_l = log(theta/(l+1) + 1)

then ReLU.  Dropout is flax's exact rate at three sites: the input
features, each layer's input and the output.  The adjacency comes
normalised (``build-graph``) and planned once (``ops/sparse.Adjacency``).

Parameter names follow the Flax tree of ``gcn_scan_layers``, where
``nn.scan`` stacks the layers' bias-free Dense kernels into one
``encoder.conv.weight`` ``[L, H, H]`` (a ``StackedDense``): ``encoder.linear``
and ``encoder.conv.weight``.  The port holds that layout alone, whatever the
flag; ``convert.py`` stacks the other tree's ``conv_0..conv_{L-1}`` into it
and writes either tree back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.device import resolve_device
from item_alignment_torch.models.heads import TwoTowerClassificationHead
from item_alignment_torch.models.layers import Dense, StackedDense, take_rows
from item_alignment_torch.models.losses import pair_loss
from item_alignment_torch.models.outputs import PairClassifierOutput
from item_alignment_torch.models.text import Device, _initialise
from item_alignment_torch.ops.dropout import dropout, fold_seed, whole_batch
from item_alignment_torch.ops.sparse import Adjacency, spmm


def gcn_betas(config: ModelConfig):
    return [math.log(config.gcn_theta / (l + 1) + 1.0)
            for l in range(config.gcn_layers)]


class GCN2Layer(nn.Module):
    """The GCN2Conv of every layer, each with its own bias-free Dense
    kernel, stacked in ``weight`` as ``nn.scan`` stacks JAX's
    ``GCN2Layer``; ``forward(x, x0, adj, l)`` is layer ``l``."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.alpha, self.betas = config.gcn_alpha, gcn_betas(config)
        H = config.gcn_hidden
        self.weight = StackedDense(config.gcn_layers, H, H)

    def forward(self, x, x0, adj: Adjacency, l: int):
        a, beta = self.alpha, self.betas[l]
        support = (1.0 - a) * spmm(adj, x) + a * x0
        return (1.0 - beta) * support + beta * self.weight(support, l)


class GCNII(nn.Module):
    """Linear(feature_dim -> hidden) + ReLU, then ``gcn_layers`` GCN2Conv
    layers, each followed by ReLU."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.rate = float(config.hidden_dropout_prob)
        self.linear = Dense(config.gcn_feature_dim, config.gcn_hidden)
        self.conv = GCN2Layer(config)

    def forward(self, features, adj: Adjacency, deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        def drop(x, site):
            return dropout(x, self.rate, fold_seed(dropout_seed, site),
                           deterministic)

        # the sites drop graph nodes, the same on every data-parallel rank
        with whole_batch():
            x = x0 = F.relu(self.linear(drop(features, 0)))
            for l in range(self.config.gcn_layers):
                x = F.relu(self.conv(drop(x, 1 + l), x0, adj, l))
            return drop(x, 1 + self.config.gcn_layers)


class GCNTwoTower(nn.Module):
    """Full-graph node embeddings, then the pair head on the two nodes'
    rows (one repeatable gather for the batch).  The embeds are the two
    probability columns, the reference's quirk."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.encoder = GCNII(config)
            self.classifier = TwoTowerClassificationHead(
                config.gcn_hidden, dropout_rate=config.hidden_dropout_prob,
                num_labels=config.num_labels)
        _initialise(self, config, dev, seed)

    def forward(self, features, adj: Adjacency, src_idx, tgt_idx,
                labels=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        cfg = self.config
        nodes = self.encoder(features, adj, deterministic,
                             fold_seed(dropout_seed, 0))
        _, _, logits, full_probs = self.classifier(
            take_rows(nodes, src_idx), take_rows(nodes, tgt_idx),
            deterministic, fold_seed(dropout_seed, 1))
        src_embeds = full_probs[:, 0]
        tgt_embeds = full_probs[:, 1]
        probs = full_probs[:, 1]
        loss = None
        if labels is not None:
            loss = pair_loss(cfg.loss_type, logits, probs, labels,
                             src_embeds, tgt_embeds, cfg.loss_margin,
                             cfg.num_labels)
        return PairClassifierOutput(loss=loss, logits=logits, probs=probs,
                                    src_embeds=src_embeds,
                                    tgt_embeds=tgt_embeds)
