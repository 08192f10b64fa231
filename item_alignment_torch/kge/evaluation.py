"""Link-prediction / relation-prediction / triplet-classification evaluation.

Port of ``item_alignment_tpu/kge/evaluation.py`` (torchkge
``evaluation.py:16-530``):

- ``LinkPredictionEvaluator``: raw and filtered mean rank / MRR / hit@k by
  scoring every entity as the candidate of each test fact
  (``KGEModel.scores_all_*``).  The ranks are computed on the device, and
  per batch only the rank vectors come back: the filtered rank is the raw
  rank less the known-true candidates that score above the target, with
  each fact's known set padded to one fixed width.
- ``RelationPredictionEvaluator``: ranks all relations of each fact.
- ``TripletClassificationEvaluator``: per-relation score thresholds chosen
  on a validation set, accuracy on test (evaluation.py:428-530).

A rank is 1 + the number of candidates scoring strictly higher: ties count
for the target.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from item_alignment_torch.kge.graph import KnowledgeGraph
from item_alignment_torch.kge.models import KGEModel


def _ranks_from_scores(scores: np.ndarray, true_idx: np.ndarray) -> np.ndarray:
    """rank = 1 + #candidates with strictly higher score."""
    true_scores = scores[np.arange(len(true_idx)), true_idx]
    return 1 + (scores > true_scores[:, None]).sum(axis=1)


def _score_numpy(model: KGEModel, params, h, r, t) -> np.ndarray:
    with torch.no_grad():
        return model.score(params, h, r, t).cpu().numpy()


class LinkPredictionEvaluator:
    """Raw and filtered ranks of each fact's tail and head among all
    entities, computed on the parameters' device."""

    def __init__(self, model: KGEModel, params, kg_test: KnowledgeGraph,
                 kg_filter: Optional[Tuple[KnowledgeGraph, ...]] = None,
                 batch_size: int = 128):
        self.model = model
        self.params = params
        self.kg = kg_test
        self.batch_size = batch_size
        filters = kg_filter if kg_filter is not None else (kg_test,)
        others = [k for k in filters if k is not kg_test]
        self.true_tails = kg_test.dict_of_tails(*others)
        self.true_heads = kg_test.dict_of_heads(*others)
        self.ranks_t = self.ranks_h = None
        self.filt_ranks_t = self.filt_ranks_h = None

    @torch.no_grad()
    def _ranks(self, side: str, anchor, rel, true_idx, known_idx):
        score_all = (self.model.scores_all_tails if side == "tails"
                     else self.model.scores_all_heads)
        scores = score_all(self.params, anchor, rel)  # [bs, n_ent]
        true_s = scores.gather(1, true_idx[:, None])
        raw = 1 + (scores > true_s).sum(1)
        # filtered = raw less the known-true others that score higher
        ks = scores.gather(1, known_idx.clamp(min=0))
        higher = ((known_idx >= 0) & (ks > true_s)).sum(1)
        return raw.cpu().numpy(), (raw - higher).cpu().numpy()

    @staticmethod
    def _pad_known(dct, keys_a, rels, targets, width) -> np.ndarray:
        """[bs, width] known-true candidate ids, target excluded, -1 pad."""
        out = np.full((len(keys_a), width), -1, dtype=np.int64)
        for i, (a, r, tgt) in enumerate(zip(keys_a, rels, targets)):
            known = [k for k in dct.get((int(a), int(r)), ())
                     if k != int(tgt)]
            out[i, : len(known)] = known[:width]
        return out

    def evaluate(self) -> "LinkPredictionEvaluator":
        kg, bs = self.kg, self.batch_size
        dev = self.params["ent_emb"].device
        # one filter width for the whole run
        max_known = max(
            [len(v) for v in self.true_tails.values()]
            + [len(v) for v in self.true_heads.values()] + [1])
        width = max(8, int(2 ** np.ceil(np.log2(max_known))))
        ranks = {k: [] for k in ("t", "h", "ft", "fh")}
        for s in range(0, kg.n_facts, bs):
            h = kg.head_idx[s: s + bs]
            r = kg.relations[s: s + bs]
            t = kg.tail_idx[s: s + bs]
            kt = self._pad_known(self.true_tails, h, r, t, width)
            kh = self._pad_known(self.true_heads, t, r, h, width)
            h, r, t, kt, kh = (torch.as_tensor(x, device=dev).long()
                               for x in (h, r, t, kt, kh))
            rt, ft = self._ranks("tails", h, r, t, kt)
            rh, fh = self._ranks("heads", t, r, h, kh)
            for k, v in (("t", rt), ("h", rh), ("ft", ft), ("fh", fh)):
                ranks[k].append(v)
        self.ranks_t, self.ranks_h, self.filt_ranks_t, self.filt_ranks_h = (
            np.concatenate(ranks[k]) for k in ("t", "h", "ft", "fh"))
        return self

    def _both(self):
        return (np.concatenate([self.ranks_t, self.ranks_h]),
                np.concatenate([self.filt_ranks_t, self.filt_ranks_h]))

    def mean_rank(self) -> Tuple[float, float]:
        raw, filt = self._both()
        return float(np.mean(raw)), float(np.mean(filt))

    def mrr(self) -> Tuple[float, float]:
        raw, filt = self._both()
        return float(np.mean(1.0 / raw)), float(np.mean(1.0 / filt))

    def hit_at_k(self, k: int = 10) -> Tuple[float, float]:
        raw, filt = self._both()
        return float(np.mean(raw <= k)), float(np.mean(filt <= k))


class RelationPredictionEvaluator:
    """Rank all relations for each test triple (evaluation.py:16-200)."""

    def __init__(self, model: KGEModel, params, kg_test: KnowledgeGraph):
        self.model = model
        self.params = params
        self.kg = kg_test

    def evaluate(self, batch_size: int = 256) -> Dict[str, float]:
        kg = self.kg
        n_rel = kg.n_rel
        ranks = []
        for s in range(0, kg.n_facts, batch_size):
            h = kg.head_idx[s:s + batch_size]
            r = kg.relations[s:s + batch_size]
            t = kg.tail_idx[s:s + batch_size]
            B = len(h)
            scores = _score_numpy(self.model, self.params, np.repeat(h, n_rel),
                                  np.tile(np.arange(n_rel), B),
                                  np.repeat(t, n_rel)).reshape(B, n_rel)
            ranks.append(_ranks_from_scores(scores, r))
        ranks = np.concatenate(ranks)
        return {"mean_rank": float(ranks.mean()),
                "mrr": float((1.0 / ranks).mean()),
                "hit@1": float((ranks <= 1).mean())}


class TripletClassificationEvaluator:
    """Per-relation decision thresholds from validation, accuracy on test
    (evaluation.py:428-530)."""

    def __init__(self, model: KGEModel, params, kg_val: KnowledgeGraph,
                 kg_test: KnowledgeGraph, seed: int = 0):
        self.model = model
        self.params = params
        self.kg_val = kg_val
        self.kg_test = kg_test
        self.rng = np.random.RandomState(seed)
        self.thresholds: Optional[np.ndarray] = None

    def _scores(self, kg: KnowledgeGraph, corrupt: bool) -> np.ndarray:
        h, r, t = kg.head_idx.copy(), kg.relations, kg.tail_idx.copy()
        if corrupt:
            mask = self.rng.rand(len(h)) < 0.5
            rand = self.rng.randint(0, kg.n_ent, len(h))
            h = np.where(mask, rand, h)
            t = np.where(mask, t, rand)
        return _score_numpy(self.model, self.params, h, r, t)

    def evaluate_thresholds(self) -> None:
        neg_scores = self._scores(self.kg_val, corrupt=True)
        # torchkge (evaluation.py:538) gives relations unseen in validation
        # the global neg_scores.max(); per-relation maxima override it
        self.thresholds = np.full(self.kg_val.n_rel, neg_scores.max())
        for rel in range(self.kg_val.n_rel):
            m = self.kg_val.relations == rel
            if m.any():
                self.thresholds[rel] = neg_scores[m].max()

    def accuracy(self) -> float:
        if self.thresholds is None:
            self.evaluate_thresholds()
        pos = self._scores(self.kg_test, corrupt=False)
        neg = self._scores(self.kg_test, corrupt=True)
        thr = self.thresholds[self.kg_test.relations]
        correct = (pos > thr).sum() + (neg <= thr).sum()
        return float(correct) / (2 * self.kg_test.n_facts)
