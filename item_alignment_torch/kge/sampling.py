"""Negative sampling for KGE training.

Port of ``item_alignment_tpu/kge/sampling.py`` (torchkge's samplers,
``sampling.py:16-591``).  Whole-KG corruption is one vectorized call on the
device, drawn from an explicit ``torch.Generator``:

- Uniform: corrupt the head or the tail with probability 0.5;
- Bernoulli (Wang et al. 2014): per relation, corrupt the head with
  probability tph / (tph + hpt);
- Positional (Socher et al. 2011): the corrupting entity comes from those
  seen in the same position for the same relation.

Corrupted ids are drawn from [1, n_ent), as in the reference.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Tuple

import numpy as np
import torch

from item_alignment_torch.device import resolve_device
from item_alignment_torch.kge.graph import KnowledgeGraph


def bernoulli_probs(kg: KnowledgeGraph) -> np.ndarray:
    """Per-relation P(corrupt head) = tph / (tph + hpt); 0.5 for unseen."""
    heads_per_rel = defaultdict(lambda: defaultdict(set))
    tails_per_rel = defaultdict(lambda: defaultdict(set))
    for h, r, t in zip(kg.head_idx, kg.relations, kg.tail_idx):
        heads_per_rel[int(r)][int(t)].add(int(h))
        tails_per_rel[int(r)][int(h)].add(int(t))
    probs = np.full(kg.n_rel, 0.5, dtype=np.float32)
    for r in range(kg.n_rel):
        if r in tails_per_rel and len(tails_per_rel[r]):
            tph = np.mean([len(s) for s in tails_per_rel[r].values()])
            hpt = np.mean([len(s) for s in heads_per_rel[r].values()])
            probs[r] = tph / (tph + hpt)
    return probs


class UniformNegativeSampler:
    """The KG's index arrays live on ``device`` (None means ``"cuda"``)."""

    def __init__(self, kg: KnowledgeGraph, n_neg: int = 1, device=None):
        self.kg = kg
        self.n_neg = n_neg
        self.n_ent = kg.n_ent
        self.device = resolve_device(device)
        self.kg_arrays = tuple(
            torch.as_tensor(a, device=self.device).long()
            for a in (kg.head_idx, kg.tail_idx, kg.relations))

    def _head_corruption_prob(self, relations: torch.Tensor) -> torch.Tensor:
        return torch.full(relations.shape, 0.5, device=self.device)

    def _tiled(self, n_neg, *arrays):
        return tuple(torch.as_tensor(a, device=self.device).long()
                     .repeat(n_neg) for a in arrays)

    def corrupt_batch(self, gen: torch.Generator, heads, tails, relations,
                      n_neg: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tile each fact n_neg times and corrupt its head OR its tail."""
        heads, tails, relations = self._tiled(n_neg or self.n_neg, heads,
                                              tails, relations)
        corrupt_head = torch.rand(heads.shape, generator=gen,
                                  device=self.device) \
            < self._head_corruption_prob(relations)
        rand_ent = torch.randint(1, self.n_ent, heads.shape, generator=gen,
                                 device=self.device)
        return (torch.where(corrupt_head, rand_ent, heads),
                torch.where(corrupt_head, tails, rand_ent))

    def corrupt_kg(self, gen: torch.Generator, n_neg: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Whole-graph corruption as host arrays."""
        nh, nt = self.corrupt_kg_device(gen, n_neg)
        return nh.cpu().numpy(), nt.cpu().numpy()

    def corrupt_kg_device(self, gen: torch.Generator,
                          n_neg: Optional[int] = None):
        """Whole-graph corruption, left on the device for the training
        loop."""
        return self.corrupt_batch(gen, *self.kg_arrays, n_neg)


class BernoulliNegativeSampler(UniformNegativeSampler):
    def __init__(self, kg: KnowledgeGraph, n_neg: int = 1, device=None):
        super().__init__(kg, n_neg, device)
        self.bern_probs = torch.as_tensor(bernoulli_probs(kg),
                                          device=self.device)

    def _head_corruption_prob(self, relations: torch.Tensor) -> torch.Tensor:
        return self.bern_probs[relations]


class PositionalNegativeSampler(BernoulliNegativeSampler):
    """The per-(relation, position) candidate pools are padded to a fixed
    width ``max_pool``, so sampling is one vectorized gather."""

    def __init__(self, kg: KnowledgeGraph, n_neg: int = 1,
                 max_pool: int = 64, device=None):
        super().__init__(kg, n_neg, device)
        heads_pool = [[] for _ in range(kg.n_rel)]
        tails_pool = [[] for _ in range(kg.n_rel)]
        for h, r, t in zip(kg.head_idx, kg.relations, kg.tail_idx):
            heads_pool[int(r)].append(int(h))
            tails_pool[int(r)].append(int(t))

        def pad(pools):
            table = np.zeros((kg.n_rel, max_pool), np.int64)
            sizes = np.ones(kg.n_rel, np.int64)
            for r, pool in enumerate(pools):
                uniq = sorted(set(pool)) or [0]
                k = min(len(uniq), max_pool)
                table[r, :k] = uniq[:k]
                if k < max_pool:
                    table[r, k:] = table[r, 0]
                sizes[r] = k
            return (torch.as_tensor(table, device=self.device),
                    torch.as_tensor(sizes, device=self.device))

        self.head_table, self.head_sizes = pad(heads_pool)
        self.tail_table, self.tail_sizes = pad(tails_pool)

    def corrupt_batch(self, gen, heads, tails, relations, n_neg=None):
        heads, tails, relations = self._tiled(n_neg or self.n_neg, heads,
                                              tails, relations)
        corrupt_head = torch.rand(heads.shape, generator=gen,
                                  device=self.device) \
            < self._head_corruption_prob(relations)
        u = torch.rand(heads.shape, generator=gen, device=self.device)
        h_pick = (u * self.head_sizes[relations]).long()
        t_pick = (u * self.tail_sizes[relations]).long()
        rand_heads = self.head_table[relations, h_pick]
        rand_tails = self.tail_table[relations, t_pick]
        return (torch.where(corrupt_head, rand_heads, heads),
                torch.where(corrupt_head, tails, rand_tails))
