"""RoBERTa and PKGM embeddings.

Port of ``item_alignment_tpu/models/embeddings.py``: ``create_position_ids``,
``EmbedPostprocess``, ``RobertaEmbeddings`` (with the ``cate_ids`` hook) and
``PKGMEmbeddings``.  The embedding LayerNorm has no compute dtype, so it runs
and returns fp32, and so do PKGM's knowledge-graph queries.

PKGM's two lengths: per item the ids hold ``max_seq_len`` text ids, one
entity id and ``max_pvs`` relation ids (the id space), while the embedded
sequence, which the masks, token types and positions cover, holds
``max_seq_len + 2 * max_pvs`` tokens: each relation becomes a triple query
``h + r`` and a relation query ``M h - r``.

One deliberate difference: position ids derived from ``input_ids`` run up to
S + ``pad_token_id``, and a sequence whose last id would lie past the
position table raises a ``ValueError`` here.  In JAX an index past the table
is silent (``nn.Embed`` clamps or fills); in torch it is an index error on
the CPU and a device-side assert on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.models.layers import (
    Dense,
    LayerNorm,
    embedding_lookup,
)
from item_alignment_torch.ops.dropout import ReplayDropout


def create_position_ids(input_ids: torch.Tensor, padding_idx: int
                        ) -> torch.Tensor:
    """RoBERTa pad-aware position ids: cumsum(mask) * mask + pad id."""
    mask = (input_ids != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class EmbedPostprocess(nn.Module):
    """token_type + position add, LayerNorm, dropout (shared tail)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = ReplayDropout(cfg.hidden_dropout_prob)

    def forward(self, inputs_embeds, token_type_ids, position_ids,
                deterministic: bool = True,
                dropout_seed: Optional[int] = None):
        x = (inputs_embeds
             + embedding_lookup(self.token_type_embeddings, token_type_ids)
             + embedding_lookup(self.position_embeddings, position_ids))
        x = self.layer_norm(x)
        return self.dropout(x, dropout_seed, deterministic)


class RobertaEmbeddings(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        if config.cate_size:
            self.cate_embeddings = nn.Embedding(config.cate_size,
                                                config.hidden_size)
        self.post = EmbedPostprocess(config)

    def forward(
        self,
        input_ids: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        cate_ids: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        cfg = self.config
        if position_ids is None:
            last = input_ids.shape[1] + cfg.pad_token_id
            if last >= cfg.max_position_embeddings:
                raise ValueError(
                    f"a sequence of {input_ids.shape[1]} tokens needs position "
                    f"ids up to {last} (S + pad_token_id), but the position "
                    f"table has max_position_embeddings="
                    f"{cfg.max_position_embeddings} rows; grow the table "
                    f"(utils/hf_import.py copies the pretrained rows)")
            position_ids = create_position_ids(input_ids, cfg.pad_token_id)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        embeds = embedding_lookup(self.word_embeddings, input_ids)
        if cate_ids is not None:
            if not cfg.cate_size:
                raise ValueError("cate_ids passed but config.cate_size unset")
            embeds = embeds + embedding_lookup(self.cate_embeddings, cate_ids)
        return self.post(embeds, token_type_ids, position_ids, deterministic,
                         dropout_seed)


class PKGMEmbeddings(nn.Module):
    """Text + knowledge-graph query embeddings.

    Input id layout per item: ``[text ids (max_seq_len)] [entity id]
    [relation ids (max_pvs)]``; one-tower input is src then tgt.  Output per
    item: ``max_seq_len + 2*max_pvs`` embedded tokens (the text, then the
    triple queries h+r, then the relation queries M.h - r).  The three
    ``*_projector`` Dense layers exist only when ``kg_embedding_dim !=
    hidden_size``."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        D = cfg.kg_embedding_dim
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.ent_emb = nn.Embedding(cfg.num_entities, D)
        self.rel_emb = nn.Embedding(cfg.num_relations, D)
        self.proj_mat = Dense(D, D, use_bias=cfg.entity_projection_bias)
        self.projects = D != cfg.hidden_size
        if self.projects:
            self.ent_projector = Dense(D, cfg.hidden_size)
            self.rel_projector = Dense(D, cfg.hidden_size)
            self.proj_projector = Dense(D, cfg.hidden_size)
        self.post = EmbedPostprocess(cfg)

    def _item_kg_embeds(self, entity_ids: torch.Tensor,
                        relation_ids: torch.Tensor) -> torch.Tensor:
        """entity_ids [B], relation_ids [B, P] -> [B, 2P, H]."""
        h = embedding_lookup(self.ent_emb, entity_ids[:, None])  # [B, 1, D]
        if self.config.kg_entity_normalize == "l2":
            h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1,
                                                         keepdim=True),
                                min=1e-12)
        else:
            # the reference's F.normalize over the singleton axis of the
            # [B, 1, D] slice: elementwise x / max(|x|, 1e-12)
            h = h / torch.clamp(h.abs(), min=1e-12)
        r = embedding_lookup(self.rel_emb, relation_ids)  # [B, P, D]
        h_proj = self.proj_mat(h)
        if self.projects:
            h = self.ent_projector(h)
            r = self.rel_projector(r)
            h_proj = self.proj_projector(h_proj)
        return torch.cat((h + r, h_proj - r), dim=1)

    def _split_item(self, item_ids: torch.Tensor) -> torch.Tensor:
        L, P = self.config.max_seq_len, self.config.max_pvs
        text = embedding_lookup(self.word_embeddings, item_ids[:, :L])
        return torch.cat((text, self._item_kg_embeds(
            item_ids[:, L], item_ids[:, L + 1: L + 1 + P])), dim=1)

    def forward(
        self,
        input_ids: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        dropout_seed: Optional[int] = None,
    ) -> torch.Tensor:
        cfg = self.config
        if cfg.interaction_type == "one_tower":
            item_id_len = cfg.max_seq_len + cfg.max_pvs + 1
            embeds = torch.cat((self._split_item(input_ids[:, :item_id_len]),
                                self._split_item(input_ids[:, item_id_len:])),
                               dim=1)
        else:
            embeds = self._split_item(input_ids)
        B, S, _ = embeds.shape
        if position_ids is None:
            # the datasets give explicit 0..S-1 positions
            position_ids = torch.arange(S, device=embeds.device).expand(B, S)
        if token_type_ids is None:
            token_type_ids = torch.zeros((B, S), dtype=torch.long,
                                         device=embeds.device)
        return self.post(embeds, token_type_ids, position_ids, deterministic,
                         dropout_seed)
