"""OpenKE-style KG post-processing (reference ``data_prepare.post_processing``,
data_prepare.py:483-637 — dormant upstream but part of the inventory):

- ``type_constrain.txt``: per relation, the sets of entities observed as
  heads and as tails
- 1-1 / 1-n / n-1 / n-n relation-category split of the test triples, by
  average tails-per-(head,rel) and heads-per-(rel,tail) with the 1.5
  threshold of Bordes et al.

Operates on :class:`KnowledgeGraph` triple arrays instead of re-parsing the
``*2id.txt`` files.

A copy of ``item_alignment_tpu/kge/type_constraints.py`` (numpy only), kept
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, Optional, Tuple

from item_alignment_torch.kge.graph import KnowledgeGraph


def relation_categories(*kgs: KnowledgeGraph) -> Dict[int, str]:
    """Per relation: '1-1' | '1-n' | 'n-1' | 'n-n'."""
    tails_per_hr: Dict[Tuple[int, int], int] = defaultdict(int)
    heads_per_rt: Dict[Tuple[int, int], int] = defaultdict(int)
    for kg in kgs:
        for h, r, t in zip(kg.head_idx, kg.relations, kg.tail_idx):
            tails_per_hr[(int(h), int(r))] += 1
            heads_per_rt[(int(r), int(t))] += 1
    sum_t, cnt_t = defaultdict(int), defaultdict(int)
    for (h, r), n in tails_per_hr.items():
        sum_t[r] += n
        cnt_t[r] += 1
    sum_h, cnt_h = defaultdict(int), defaultdict(int)
    for (r, t), n in heads_per_rt.items():
        sum_h[r] += n
        cnt_h[r] += 1
    out = {}
    for r in set(sum_t) | set(sum_h):
        tph = sum_t[r] / cnt_t[r] if cnt_t[r] else 0.0
        hpt = sum_h[r] / cnt_h[r] if cnt_h[r] else 0.0
        if tph < 1.5 and hpt < 1.5:
            out[r] = "1-1"
        elif tph >= 1.5 and hpt < 1.5:
            out[r] = "1-n"
        elif tph < 1.5 and hpt >= 1.5:
            out[r] = "n-1"
        else:
            out[r] = "n-n"
    return out


def write_type_constraints(output_dir: str, kg_train: KnowledgeGraph,
                           kg_valid: Optional[KnowledgeGraph] = None,
                           kg_test: Optional[KnowledgeGraph] = None) -> str:
    """``type_constrain.txt``: for each relation two lines — observed head
    entities, then observed tail entities (OpenKE format)."""
    heads: Dict[int, set] = defaultdict(set)
    tails: Dict[int, set] = defaultdict(set)
    for kg in (k for k in (kg_train, kg_valid, kg_test) if k is not None):
        for h, r, t in zip(kg.head_idx, kg.relations, kg.tail_idx):
            heads[int(r)].add(int(h))
            tails[int(r)].add(int(t))
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "type_constrain.txt")
    with open(path, "w") as w:
        w.write(f"{len(heads)}\n")
        for r in sorted(heads):
            hs = sorted(heads[r])
            ts = sorted(tails[r])
            w.write("\t".join([str(r), str(len(hs))] + [str(x) for x in hs]) + "\n")
            w.write("\t".join([str(r), str(len(ts))] + [str(x) for x in ts]) + "\n")
    return path


def split_test_by_category(output_dir: str, kg_train: KnowledgeGraph,
                           kg_test: KnowledgeGraph,
                           kg_valid: Optional[KnowledgeGraph] = None
                           ) -> Dict[str, int]:
    """Write ``1-1.txt``/``1-n.txt``/``n-1.txt``/``n-n.txt`` splits of the
    test triples (count header + h t r rows, OpenKE layout)."""
    kgs = [kg_train, kg_test] + ([kg_valid] if kg_valid is not None else [])
    cats = relation_categories(*kgs)
    buckets: Dict[str, list] = {"1-1": [], "1-n": [], "n-1": [], "n-n": []}
    for h, r, t in zip(kg_test.head_idx, kg_test.relations, kg_test.tail_idx):
        buckets[cats.get(int(r), "n-n")].append((int(h), int(t), int(r)))
    os.makedirs(output_dir, exist_ok=True)
    for name, rows in buckets.items():
        with open(os.path.join(output_dir, f"{name}.txt"), "w") as w:
            w.write(f"{len(rows)}\n")
            for h, t, r in rows:
                w.write(f"{h} {t} {r}\n")
    return {k: len(v) for k, v in buckets.items()}
