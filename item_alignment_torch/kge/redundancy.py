"""KG redundancy analysis (torchkge ``utils/data_redundancy.py``):
duplicate / reverse-duplicate relation detection and cartesian-product
relation share, following Akrami et al. 2020.

A copy of ``item_alignment_tpu/kge/redundancy.py`` (numpy only), kept
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set, Tuple

from item_alignment_torch.kge.graph import KnowledgeGraph


def _pairs_by_rel(kg: KnowledgeGraph) -> Dict[int, Set[Tuple[int, int]]]:
    d: Dict[int, Set[Tuple[int, int]]] = defaultdict(set)
    for h, r, t in zip(kg.head_idx, kg.relations, kg.tail_idx):
        d[int(r)].add((int(h), int(t)))
    return d


def duplicates(kg: KnowledgeGraph, theta1: float = 0.8, theta2: float = 0.8
               ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(duplicate relation pairs, reverse-duplicate relation pairs).

    r1, r2 are duplicates if >= theta of r1's (h,t) pairs appear in r2 and
    vice versa; reverse duplicates use (t,h)."""
    pairs = _pairs_by_rel(kg)
    rels = sorted(pairs)
    dup, rev_dup = [], []
    for i, r1 in enumerate(rels):
        p1 = pairs[r1]
        if not p1:
            continue
        rev1 = {(t, h) for h, t in p1}
        for r2 in rels[i + 1:]:
            p2 = pairs[r2]
            if not p2:
                continue
            inter = len(p1 & p2)
            if inter / len(p1) >= theta1 and inter / len(p2) >= theta2:
                dup.append((r1, r2))
            rinter = len(rev1 & p2)
            if rinter / len(p1) >= theta1 and rinter / len(p2) >= theta2:
                rev_dup.append((r1, r2))
    return dup, rev_dup


def cartesian_product_relations(kg: KnowledgeGraph, theta: float = 0.8
                                ) -> List[int]:
    """Relations whose fact set covers >= theta of the cartesian product of
    their observed heads and tails."""
    pairs = _pairs_by_rel(kg)
    out = []
    for r, p in pairs.items():
        heads = {h for h, _ in p}
        tails = {t for _, t in p}
        denom = len(heads) * len(tails)
        if denom and len(p) / denom >= theta:
            out.append(r)
    return sorted(out)
