"""Knowledge-graph triple store (numpy).

Equivalent of the vendored torchkge ``KnowledgeGraph``
(``torchkge/data_structures.py:17-432``): integer triple arrays, ent/rel id
maps, a train/val/test split that keeps at least one occurrence of every
entity and relation in train, and the (head, rel) -> tails / (tail, rel) ->
heads dictionaries used for filtered ranking.

``load_ccks`` reads the reference's on-disk format
(``torchkge/utils/datasets.py:24-81``): ``{train,valid,test}2id.txt`` rows
are tab-separated *names* ``head\\trel\\ttail`` resolved through
``entity2id.txt`` / ``relation2id.txt``.

A copy of ``item_alignment_tpu/kge/graph.py`` (numpy only), kept
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class KnowledgeGraph:
    def __init__(self, heads: np.ndarray, relations: np.ndarray,
                 tails: np.ndarray, n_ent: int, n_rel: int,
                 ent2ix: Optional[Dict[str, int]] = None,
                 rel2ix: Optional[Dict[str, int]] = None):
        self.head_idx = np.asarray(heads, dtype=np.int32)
        self.relations = np.asarray(relations, dtype=np.int32)
        self.tail_idx = np.asarray(tails, dtype=np.int32)
        assert len(self.head_idx) == len(self.relations) == len(self.tail_idx)
        self.n_ent = int(n_ent)
        self.n_rel = int(n_rel)
        self.ent2ix = ent2ix or {}
        self.rel2ix = rel2ix or {}

    @property
    def n_facts(self) -> int:
        return len(self.head_idx)

    @classmethod
    def from_triples(cls, triples: Sequence[Tuple[str, str, str]],
                     ent2ix: Optional[Dict[str, int]] = None,
                     rel2ix: Optional[Dict[str, int]] = None
                     ) -> "KnowledgeGraph":
        if ent2ix is None:
            ent2ix = {}
            for h, _, t in triples:
                for e in (h, t):
                    if e not in ent2ix:
                        ent2ix[e] = len(ent2ix)
        if rel2ix is None:
            rel2ix = {}
            for _, r, _ in triples:
                if r not in rel2ix:
                    rel2ix[r] = len(rel2ix)
        h = np.array([ent2ix[x[0]] for x in triples])
        r = np.array([rel2ix[x[1]] for x in triples])
        t = np.array([ent2ix[x[2]] for x in triples])
        n_ent = max(ent2ix.values()) + 1 if ent2ix else 0
        n_rel = max(rel2ix.values()) + 1 if rel2ix else 0
        return cls(h, r, t, n_ent, n_rel, ent2ix, rel2ix)

    def subset(self, idx: np.ndarray) -> "KnowledgeGraph":
        return KnowledgeGraph(self.head_idx[idx], self.relations[idx],
                              self.tail_idx[idx], self.n_ent, self.n_rel,
                              self.ent2ix, self.rel2ix)

    def split_kg(self, share: float = 0.8,
                 sizes: Optional[Sequence[int]] = None, seed: int = 0
                 ) -> Tuple["KnowledgeGraph", ...]:
        """Split facts into 2 or 3 graphs.

        With ``sizes``, the first len(sizes) contiguous chunks are returned
        (the reference uses this to re-split concatenated files).  With
        ``share``, a random split that keeps >=1 occurrence of every entity
        and relation in train (data_structures.py:270-350).
        """
        n = self.n_facts
        if sizes is not None:
            assert sum(sizes) == n, f"sizes {sizes} != {n}"
            out, start = [], 0
            for s in sizes:
                out.append(self.subset(np.arange(start, start + s)))
                start += s
            return tuple(out)

        rng = np.random.RandomState(seed)
        order = rng.permutation(n)
        # mark the first occurrence of each entity/relation as train-pinned
        pinned = np.zeros(n, dtype=bool)
        seen_e = np.zeros(self.n_ent, dtype=bool)
        seen_r = np.zeros(self.n_rel, dtype=bool)
        for i in order:
            h, r, t = self.head_idx[i], self.relations[i], self.tail_idx[i]
            if not (seen_e[h] and seen_e[t] and seen_r[r]):
                pinned[i] = True
                seen_e[h] = seen_e[t] = True
                seen_r[r] = True
        free = order[~pinned[order]]
        n_train = max(int(share * n) - int(pinned.sum()), 0)
        train_idx = np.concatenate([np.flatnonzero(pinned), free[:n_train]])
        test_idx = free[n_train:]
        return self.subset(np.sort(train_idx)), self.subset(np.sort(test_idx))

    def dict_of_tails(self, *others: "KnowledgeGraph") -> Dict[Tuple[int, int], set]:
        d: Dict[Tuple[int, int], set] = defaultdict(set)
        for kg in (self, *others):
            for h, r, t in zip(kg.head_idx, kg.relations, kg.tail_idx):
                d[(int(h), int(r))].add(int(t))
        return d

    def dict_of_heads(self, *others: "KnowledgeGraph") -> Dict[Tuple[int, int], set]:
        d: Dict[Tuple[int, int], set] = defaultdict(set)
        for kg in (self, *others):
            for h, r, t in zip(kg.head_idx, kg.relations, kg.tail_idx):
                d[(int(t), int(r))].add(int(h))
        return d


def _read_id_map(path: str) -> Dict[str, int]:
    d: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip("\n")
            if not line.strip():
                continue
            name, idx = line.rsplit("\t", 1)
            d[name] = int(idx)
    return d


def load_ccks(data_path: str, do_eval: bool = False, do_test: bool = False
              ) -> Tuple[KnowledgeGraph, ...]:
    ent2ix = _read_id_map(os.path.join(data_path, "entity2id.txt"))
    rel2ix = _read_id_map(os.path.join(data_path, "relation2id.txt"))

    def read_triples(fname) -> List[Tuple[str, str, str]]:
        out = []
        with open(os.path.join(data_path, fname), encoding="utf-8") as f:
            for line in f:
                line = line.strip("\n")
                if not line.strip():
                    continue
                h, r, t = line.split("\t")
                out.append((h, r, t))
        return out

    files = ["train2id.txt"]
    if do_eval:
        files.append("valid2id.txt")
    if do_test:
        files.append("test2id.txt")
    all_triples: List[Tuple[str, str, str]] = []
    sizes = []
    for f in files:
        tr = read_triples(f)
        all_triples.extend(tr)
        sizes.append(len(tr))
    kg = KnowledgeGraph.from_triples(all_triples, ent2ix, rel2ix)
    if len(sizes) == 1:
        return (kg,)
    return kg.split_kg(sizes=sizes)
