"""Two-tower serving: encode each item once, score many pairs.

Port of ``item_alignment_tpu/engine/inference.py``.  Each unique item is
encoded once into an embedding cache on the device; pair lists are then
scored with the classification head alone, a gather plus one small product
per batch.  ``cache_quant="int8"`` stores the cache as int8 rows with
per-row absmax scales (``ops/quant.py``), dequantized in the gather before
the head.  The callables close over modules instead of taking a params
tree:

- ``encode_fn(batch_dict) -> [B, F]`` item embeddings
- ``head_fn(src_emb, tgt_emb) -> probs [B]``
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from item_alignment_torch.device import resolve_device
from item_alignment_torch.engine.observability import span
from item_alignment_torch.ops.quant import quantize_rowwise


class TwoTowerInference:
    """encode-once / score-many serving wrapper."""

    def __init__(self, encode_fn: Callable, head_fn: Callable,
                 batch_size: int = 256, cache_quant: Optional[str] = None,
                 device=None):
        if cache_quant not in (None, "int8"):
            raise ValueError(f"unknown cache_quant {cache_quant!r}")
        self.device = resolve_device(device)
        self._encode = encode_fn
        self._head = head_fn
        self.batch_size = batch_size
        self.cache_quant = cache_quant
        self.cache: Optional[torch.Tensor] = None
        self.cache_scale: Optional[torch.Tensor] = None
        self.id_to_row: Dict[str, int] = {}

    @torch.inference_mode()
    def build_cache(self, item_ids, batches: Iterable[Dict[str, torch.Tensor]]
                    ) -> torch.Tensor:
        """Encode all items once; ``batches`` yields fixed-shape feature
        dicts aligned with ``item_ids`` order (a padded tail is cut)."""
        with span("build_cache"):
            embs = []
            for batch in batches:
                with span("encode"):
                    embs.append(self._encode(batch))
            cache = torch.cat(embs)[: len(item_ids)].to(self.device)
            self.id_to_row = {iid: i for i, iid in enumerate(item_ids)}
            if self.cache_quant == "int8":
                self.cache, self.cache_scale = quantize_rowwise(cache)
            else:
                self.cache, self.cache_scale = cache, None
            return self.cache

    @torch.inference_mode()
    def score_pairs(self, src_idx: np.ndarray, tgt_idx: np.ndarray
                    ) -> np.ndarray:
        """Probabilities for (src, tgt) row-index pairs against the cache,
        in batches of ``batch_size`` with the tail padded to that size."""
        if self.cache is None:
            raise RuntimeError("call build_cache first")
        n = len(src_idx)
        if n == 0:
            return np.zeros(0, np.float32)
        bs = self.batch_size
        pad = (-n) % bs
        src = torch.as_tensor(np.concatenate(
            [src_idx, np.zeros(pad, src_idx.dtype)]), dtype=torch.long,
            device=self.device)
        tgt = torch.as_tensor(np.concatenate(
            [tgt_idx, np.zeros(pad, tgt_idx.dtype)]), dtype=torch.long,
            device=self.device)
        out = []
        for s in range(0, n + pad, bs):
            si, ti = src[s:s + bs], tgt[s:s + bs]
            se = self.cache.index_select(0, si)
            te = self.cache.index_select(0, ti)
            if self.cache_scale is not None:
                se = se.float() * self.cache_scale.index_select(0, si)
                te = te.float() * self.cache_scale.index_select(0, ti)
            out.append(self._head(se, te))
        return torch.cat(out)[:n].float().cpu().numpy()

    def score_pairs_by_id(self, pairs) -> np.ndarray:
        src = np.array([self.id_to_row[a] for a, _ in pairs], np.int64)
        tgt = np.array([self.id_to_row[b] for _, b in pairs], np.int64)
        return self.score_pairs(src, tgt)


def two_tower_encode_fn(model) -> Callable:
    """Item encoder of a two-tower model: the backbone's last-layer [CLS]
    state for ``batch["input_ids"]`` / ``batch["attention_mask"]``."""

    def encode_fn(batch):
        states = model.roberta(batch["input_ids"], batch["attention_mask"])
        return states[-1][:, 0]

    return encode_fn


def two_tower_head_fn(model) -> Callable:
    """Scoring head of a two-tower model (``classifier.out_proj``):
    probs = softmax([src; tgt] W^T + b)[:, 1]."""
    out_proj = model.classifier.out_proj

    def head_fn(src_emb, tgt_emb):
        logits = out_proj(torch.cat((src_emb, tgt_emb), dim=-1))
        return torch.softmax(logits, dim=-1)[:, 1]

    return head_fn
