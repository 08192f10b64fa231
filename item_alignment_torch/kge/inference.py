"""KGE inference helpers: top-k entity / relation prediction.

Port of ``item_alignment_tpu/kge/inference.py`` (torchkge
``RelationInference`` / ``EntityInference``, ``inference.py:78-250``):
given known (heads, tails) predict the missing relation, or given
(known entities, relations) predict the missing entity, optionally with the
already-known facts of a dictionary filtered out.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from item_alignment_torch.kge.models import KGEModel


def _top_k(sc: np.ndarray, k: int):
    idx = np.argsort(-sc, axis=1)[:, :k]
    return idx, np.take_along_axis(sc, idx, axis=1)


class EntityInference:
    """Top-k missing-entity prediction for (entity, relation) queries."""

    def __init__(self, model: KGEModel, params, known_entities: np.ndarray,
                 known_relations: np.ndarray, top_k: int = 10,
                 missing: str = "tails",
                 dictionary: Optional[Dict[Tuple[int, int], set]] = None):
        if missing not in ("heads", "tails"):
            raise ValueError(f"missing must be heads or tails, not {missing}")
        self.model = model
        self.params = params
        self.known_entities = np.asarray(known_entities)
        self.known_relations = np.asarray(known_relations)
        self.top_k = top_k
        self.missing = missing
        self.dictionary = dictionary
        self.predictions: Optional[np.ndarray] = None
        self.scores: Optional[np.ndarray] = None

    @torch.no_grad()
    def evaluate(self, b_size: int = 128) -> np.ndarray:
        preds, scores = [], []
        fn = (self.model.scores_all_tails if self.missing == "tails"
              else self.model.scores_all_heads)
        for s in range(0, len(self.known_entities), b_size):
            e = self.known_entities[s:s + b_size]
            r = self.known_relations[s:s + b_size]
            sc = fn(self.params, e, r).cpu().numpy().copy()
            if self.dictionary is not None:
                for i in range(len(sc)):
                    for known in self.dictionary.get((int(e[i]), int(r[i])),
                                                     ()):
                        sc[i, known] = -np.inf
            idx, top = _top_k(sc, self.top_k)
            preds.append(idx)
            scores.append(top)
        self.predictions = np.concatenate(preds)
        self.scores = np.concatenate(scores)
        return self.predictions


class RelationInference:
    """Top-k missing-relation prediction for (head, tail) queries."""

    def __init__(self, model: KGEModel, params, heads: np.ndarray,
                 tails: np.ndarray, top_k: int = 10,
                 dictionary: Optional[Dict[Tuple[int, int], set]] = None):
        self.model = model
        self.params = params
        self.heads = np.asarray(heads)
        self.tails = np.asarray(tails)
        self.top_k = top_k
        self.dictionary = dictionary
        self.predictions: Optional[np.ndarray] = None
        self.scores: Optional[np.ndarray] = None

    @torch.no_grad()
    def evaluate(self, b_size: int = 128) -> np.ndarray:
        n_rel = self.model.n_rel
        preds, scores = [], []
        for s in range(0, len(self.heads), b_size):
            h = self.heads[s:s + b_size]
            t = self.tails[s:s + b_size]
            B = len(h)
            sc = self.model.score(
                self.params, np.repeat(h, n_rel), np.tile(np.arange(n_rel), B),
                np.repeat(t, n_rel)).cpu().numpy().reshape(B, n_rel).copy()
            if self.dictionary is not None:
                for i in range(B):
                    for known in self.dictionary.get((int(h[i]), int(t[i])),
                                                     ()):
                        sc[i, known] = -np.inf
            idx, top = _top_k(sc, self.top_k)
            preds.append(idx)
            scores.append(top)
        self.predictions = np.concatenate(preds)
        self.scores = np.concatenate(scores)
        return self.predictions
