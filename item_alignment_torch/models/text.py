"""RoBERTa, PKGM and TextCNN text models: backbone, one-tower
cross-encoder, two-tower.

Port of ``item_alignment_tpu/models/text.py`` (``combine_cls_layers``,
``RobertaBackbone``, ``RobertaOneTower``, ``RobertaTwoTower``,
``PKGMBackbone``, ``PKGMOneTower``, ``PKGMTwoTower``, ``TextCNN``,
``TextCNNTwoTower``).  The model
classes take ``device`` (None means ``"cuda"``) and ``seed``, the seed of
the ``torch.Generator`` that draws the initial weights; ``seed=None`` skips
the draw for callers that load a state dict next.  Module and parameter
names follow the Flax tree, so ``convert.state_dict_from_flax`` is a plain
mapping.  In training (``deterministic=False``) ``dropout_seed`` is the
forward's dropout seed; each submodule gets ``fold_seed(seed, site)`` with a
site number fixed by its place in the model.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.device import resolve_device
from item_alignment_torch.models.embeddings import (
    PKGMEmbeddings,
    RobertaEmbeddings,
)
from item_alignment_torch.models.encoder import TransformerEncoder
from item_alignment_torch.models.heads import (
    AuxiliaryPairHead,
    ClsClassificationHead,
    TwoTowerClassificationHead,
    VecSimClassificationHead,
    masked_cross_entropy,
)
from item_alignment_torch.models.layers import init_weights
from item_alignment_torch.models.losses import pair_loss
from item_alignment_torch.models.outputs import PairClassifierOutput
from item_alignment_torch.ops.dropout import dropout, fold_seed

Device = Optional[Union[str, torch.device]]


def combine_cls_layers(states, cls_layers, cls_pool):
    """Select the last-k hidden states and combine them.  ``cls_layers``
    follows the reference convention: 1 = last layer, 2 = second-to-last."""
    selected = [states[-int(i)] for i in cls_layers]
    if cls_pool == "avg":
        return torch.stack(selected).mean(dim=0)
    return torch.cat(selected, dim=-1)


def _initialise(model: nn.Module, config: ModelConfig, device: torch.device,
                seed: Optional[int]) -> None:
    if seed is not None:
        gen = torch.Generator(device=device).manual_seed(seed)
        init_weights(model, config.initializer_range, gen)


class RobertaBackbone(nn.Module):
    """Embeddings + encoder; returns all hidden states in fp32.  With
    ``dtype="bfloat16"`` the encoder runs in bf16 from the embedding output
    on (the embedding LayerNorm itself is fp32)."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.embeddings = RobertaEmbeddings(config)
            self.encoder = TransformerEncoder(config)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, cate_ids=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        hidden = self.embeddings(input_ids, token_type_ids, position_ids,
                                 cate_ids, deterministic,
                                 fold_seed(dropout_seed, 0))
        return _encode(self, hidden, attention_mask, deterministic,
                       dropout_seed)


def _encode(backbone, hidden, attention_mask, deterministic, dropout_seed):
    """The encoder over the embeddings' fp32 output, cast to bf16 first
    under ``dtype="bfloat16"``; all hidden states back in fp32."""
    if backbone.config.dtype == "bfloat16":
        hidden = hidden.to(torch.bfloat16)
    states = backbone.encoder(hidden, attention_mask, deterministic,
                              fold_seed(dropout_seed, 1))
    return [s.float() for s in states]


class _OneTowerHead(nn.Module):
    """Shared one-tower head and loss logic."""

    def __init__(self, config: ModelConfig, tgt_cls_position: int):
        super().__init__()
        self.config = config
        self.tgt_cls_position = tgt_cls_position
        if config.classification_method == "vec_sim":
            self.classifier = VecSimClassificationHead(config)
        else:
            self.classifier = ClsClassificationHead(config)
        if config.auxiliary_task:
            self.auxiliary_task = AuxiliaryPairHead(config)

    def forward(self, states, labels=None, pair_spans=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None,
                image_embeds=None) -> PairClassifierOutput:
        """``image_embeds``, the (src, tgt) image vectors, reach the
        classifier of an ``ensemble == "end"`` model."""
        cfg = self.config
        seq_out = combine_cls_layers(states, cfg.cls_layers, cfg.cls_pool)
        head_seed = fold_seed(dropout_seed, 0)
        if cfg.classification_method == "vec_sim":
            src_embeds, tgt_embeds, logits, probs = self.classifier(
                seq_out[:, 0, :], seq_out[:, self.tgt_cls_position, :],
                deterministic, head_seed)
        else:
            logits = self.classifier(seq_out, deterministic, head_seed,
                                     image_embeds)
            full_probs = torch.softmax(logits, dim=-1)
            # reference quirk: the embeds are the two probability columns,
            # probs is P(label=1)
            src_embeds = full_probs[:, 0]
            tgt_embeds = full_probs[:, 1]
            probs = full_probs[:, 1]

        loss = None
        if labels is not None:
            loss = pair_loss(cfg.loss_type, logits, probs, labels,
                             src_embeds, tgt_embeds, cfg.loss_margin,
                             cfg.num_labels)
            if cfg.auxiliary_task and pair_spans is not None:
                aux_logits, aux_labels, valid = self.auxiliary_task(
                    seq_out, pair_spans, deterministic,
                    fold_seed(dropout_seed, 1))
                loss = loss + masked_cross_entropy(aux_logits, aux_labels,
                                                   valid)
        return PairClassifierOutput(loss=loss, logits=logits, probs=probs,
                                    src_embeds=src_embeds,
                                    tgt_embeds=tgt_embeds)


class RobertaOneTower(nn.Module):
    """Pair cross-encoder: ``[CLS] src [SEP] tgt [SEP]`` (cls) or
    ``src-padded [BOS] tgt-padded`` (vec_sim)."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.roberta = RobertaBackbone(config, dev, seed=None)
        with torch.device(dev):
            self.head = _OneTowerHead(config, config.item_seq_len)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, cate_ids=None, labels=None,
                pair_spans=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        states = self.roberta(input_ids, attention_mask, token_type_ids,
                              position_ids, cate_ids, deterministic,
                              fold_seed(dropout_seed, 0))
        return self.head(states, labels, pair_spans, deterministic,
                         fold_seed(dropout_seed, 1))


class RobertaTwoTower(nn.Module):
    """Two shared-weight encoder passes; CLS pair -> two-tower head."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.roberta = RobertaBackbone(config, dev, seed=None)
        with torch.device(dev):
            self.classifier = TwoTowerClassificationHead(
                config.hidden_size, dropout_rate=config.hidden_dropout_prob,
                num_labels=config.num_labels)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids_1, input_ids_2, attention_mask_1=None,
                attention_mask_2=None, token_type_ids_1=None,
                token_type_ids_2=None, cate_ids_1=None, cate_ids_2=None,
                labels=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        # the two passes draw their own masks, as flax's second call does
        out_1 = self.roberta(input_ids_1, attention_mask_1, token_type_ids_1,
                             cate_ids=cate_ids_1, deterministic=deterministic,
                             dropout_seed=fold_seed(dropout_seed, 0))[-1]
        out_2 = self.roberta(input_ids_2, attention_mask_2, token_type_ids_2,
                             cate_ids=cate_ids_2, deterministic=deterministic,
                             dropout_seed=fold_seed(dropout_seed, 1))[-1]
        return _two_tower_output(self, out_1, out_2, labels, deterministic,
                                 dropout_seed)


def _two_tower_output(model, out_1, out_2, labels, deterministic,
                      dropout_seed) -> PairClassifierOutput:
    """The two-tower head over the two towers' last hidden states."""
    cfg = model.config
    src_embeds, tgt_embeds, logits, full_probs = model.classifier(
        out_1[:, 0, :], out_2[:, 0, :], deterministic,
        fold_seed(dropout_seed, 2))
    probs = full_probs[:, 1]  # P(same); embeds stay the CLS vectors
    loss = None
    if labels is not None:
        loss = pair_loss(cfg.loss_type, logits, probs, labels, src_embeds,
                         tgt_embeds, cfg.loss_margin, cfg.num_labels)
    return PairClassifierOutput(loss=loss, logits=logits, probs=probs,
                                src_embeds=src_embeds, tgt_embeds=tgt_embeds)


class PKGMBackbone(nn.Module):
    """PKGM embeddings + encoder; returns all hidden states in fp32.  The
    knowledge-graph queries are computed in fp32 and cast with the rest of
    the embedding output under ``dtype="bfloat16"``."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.embeddings = PKGMEmbeddings(config)
            self.encoder = TransformerEncoder(config)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        hidden = self.embeddings(input_ids, token_type_ids, position_ids,
                                 deterministic, fold_seed(dropout_seed, 0))
        return _encode(self, hidden, attention_mask, deterministic,
                       dropout_seed)


class PKGMOneTower(nn.Module):
    """One-tower pair classifier over the PKGM encoder.  The embedded tgt
    [CLS] sits at ``max_seq_len + 2*max_pvs``, as in the JAX package (the
    reference's pooler reads the id-space offset instead)."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.roberta = PKGMBackbone(config, dev, seed=None)
        with torch.device(dev):
            self.head = _OneTowerHead(
                config, config.max_seq_len + 2 * config.max_pvs)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, labels=None, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        states = self.roberta(input_ids, attention_mask, token_type_ids,
                              position_ids, deterministic,
                              fold_seed(dropout_seed, 0))
        return self.head(states, labels, None, deterministic,
                         fold_seed(dropout_seed, 1))


class PKGMTwoTower(nn.Module):
    """Two shared-weight PKGM encoder passes (one position row for both);
    CLS pair -> two-tower head."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        self.roberta = PKGMBackbone(config, dev, seed=None)
        with torch.device(dev):
            self.classifier = TwoTowerClassificationHead(
                config.hidden_size, dropout_rate=config.hidden_dropout_prob,
                num_labels=config.num_labels)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids_1, input_ids_2, attention_mask_1=None,
                attention_mask_2=None, token_type_ids_1=None,
                token_type_ids_2=None, position_ids=None, labels=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        out_1 = self.roberta(input_ids_1, attention_mask_1, token_type_ids_1,
                             position_ids, deterministic,
                             fold_seed(dropout_seed, 0))[-1]
        out_2 = self.roberta(input_ids_2, attention_mask_2, token_type_ids_2,
                             position_ids, deterministic,
                             fold_seed(dropout_seed, 1))[-1]
        return _two_tower_output(self, out_1, out_2, labels, deterministic,
                                 dropout_seed)


class TextCNN(nn.Module):
    """Two-channel TextCNN: a trainable and a frozen ``RobertaEmbeddings``
    (the second detached, so its table gets no gradient; AdamW still
    decays it, as it does JAX's zero gradient), concatenated to ``[B, S,
    2H]``; for each filter size K a VALID ``Conv1d`` of ``num_filters``
    channels, ReLU and a max over all ``S - K + 1`` windows (padding
    included); the pooled features concatenated, then dropout.  Runs in
    fp32 whatever ``dtype`` says, as JAX's does."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.embedding1 = RobertaEmbeddings(config)
        self.embedding2 = RobertaEmbeddings(config)
        for k in config.filter_sizes:
            self.add_module(f"conv_{k}", nn.Conv1d(
                2 * config.hidden_size, config.num_filters, k))

    @property
    def num_features(self) -> int:
        return self.config.num_filters * len(self.config.filter_sizes)

    def forward(self, input_ids, deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        emb1 = self.embedding1(input_ids, deterministic=deterministic,
                               dropout_seed=fold_seed(dropout_seed, 0))
        emb2 = self.embedding2(input_ids, deterministic=deterministic,
                               dropout_seed=fold_seed(dropout_seed, 1))
        x = torch.cat((emb1, emb2.detach()), dim=-1).transpose(1, 2)
        feat = torch.cat([F.relu(getattr(self, f"conv_{k}")(x)).amax(dim=2)
                          for k in cfg.filter_sizes], dim=-1)
        return dropout(feat, cfg.hidden_dropout_prob,
                       fold_seed(dropout_seed, 2), deterministic)


class TextCNNTwoTower(nn.Module):
    """One shared ``TextCNN`` over both items; the ``vec_sim`` or the
    two-tower ``cls`` head.  Under ``cls`` the embeds are the two
    probability columns (the reference's quirk, as the one-tower's).  The
    masks and token types are accepted and unused: the reference's TextCNN
    reads input ids only."""

    def __init__(self, config: ModelConfig, device: Device = None,
                 seed: Optional[int] = 0):
        super().__init__()
        self.config = config
        dev = resolve_device(device)
        with torch.device(dev):
            self.textcnn = TextCNN(config)
            width = self.textcnn.num_features
            if config.classification_method == "vec_sim":
                self.classifier = VecSimClassificationHead(config, width)
            else:
                self.classifier = TwoTowerClassificationHead(
                    width, dropout_rate=config.hidden_dropout_prob,
                    num_labels=config.num_labels)
        _initialise(self, config, dev, seed)

    def forward(self, input_ids_1, input_ids_2, attention_mask_1=None,
                attention_mask_2=None, token_type_ids_1=None,
                token_type_ids_2=None, labels=None,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None) -> PairClassifierOutput:
        cfg = self.config
        f1 = self.textcnn(input_ids_1, deterministic,
                          fold_seed(dropout_seed, 0))
        f2 = self.textcnn(input_ids_2, deterministic,
                          fold_seed(dropout_seed, 1))
        head_seed = fold_seed(dropout_seed, 2)
        if cfg.classification_method == "vec_sim":
            src_embeds, tgt_embeds, logits, probs = self.classifier(
                f1, f2, deterministic, head_seed)
        else:
            _, _, logits, full_probs = self.classifier(f1, f2, deterministic,
                                                       head_seed)
            src_embeds = full_probs[:, 0]
            tgt_embeds = full_probs[:, 1]
            probs = full_probs[:, 1]
        loss = None
        if labels is not None:
            loss = pair_loss(cfg.loss_type, logits, probs, labels, src_embeds,
                             tgt_embeds, cfg.loss_margin, cfg.num_labels)
        return PairClassifierOutput(loss=loss, logits=logits, probs=probs,
                                    src_embeds=src_embeds,
                                    tgt_embeds=tgt_embeds)
