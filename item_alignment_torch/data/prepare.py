"""Offline data preparation.

Port of ``item_alignment_tpu/data/prepare.py``, the JAX package's stdlib
re-implementation of the reference's ``data_prepare.py``; both write the
same files from the same inputs and seed.  Citations are into the
reference's ``data_prepare.py``:

- per-category relation statistics incl. ``0-diff-rate`` / ``1-same-rate``
  discriminativeness rates (``relation_filter``, 367-481)
- relation filtering by frequency or top-n (445-474)
- PKGM pretraining KG: triples (/item/<id>, relation, /value/<v>), entity /
  relation id maps, ``entity2id.txt`` / ``relation2id.txt`` / ``*2id.txt``
  (``pkgm_pretraining_data``, 639-765)
- finetune TSV construction with the shared-keys-first pv ordering
  (768-1065)
- reproducible train/valid split with ``prev_valid`` pinning (882-928)
- easy-negative augmentation from cross-category pairs (1030-1128)

``read_tsv`` and ``read_finetune_tsv`` read through the native scanner
(``data/native_loader.read_tsv_fast``), as the JAX package does.
``segment_title`` calls
``jieba`` when it is called and raises ``ImportError`` without it.

Known reference bug NOT reproduced: ``relation_filter`` reads
``pv2 = d1['pvs']`` (line 434) so its same/diff rates always compare an item
to itself; we compare src to tgt as intended.
"""

from __future__ import annotations

import json
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from item_alignment_torch.utils import logger

RELATION_PADDING = "[PAD]"
RELATION_PADDING_ID = 0


def parse_pvs(item: Dict) -> Dict[str, Set[str]]:
    """Split ``item_pvs``/``sku_pvs`` on ``#;#`` / ``#:#`` into
    {relation: set(values)} (375-407)."""
    pvs: Dict[str, Set[str]] = {}
    raw = item.get("item_pvs", "").split("#;#") + item.get("sku_pvs", "").split("#;#")
    for pv in raw:
        try:
            k, v = pv.split("#:#", maxsplit=1)
        except ValueError:
            continue
        k, v = k.strip(), v.strip()
        if not k or not v:
            continue
        pvs.setdefault(k, set()).add(v)
    return pvs


def load_item_info(path: str) -> Tuple[Dict[str, Dict], Dict[str, int], Dict]:
    """Read ``item_info.jsonl`` -> (id_dict with parsed ``pvs``, per-category
    item counts, per-category relation stat dicts with raw totals)."""
    id_dict: Dict[str, Dict] = {}
    cate_count: Dict[str, int] = defaultdict(int)
    relation_count: Dict[str, Dict[str, Dict[str, float]]] = {}
    with open(path, encoding="utf-8") as r:
        for line in r:
            d = json.loads(line.strip())
            id_dict[d["item_id"]] = d
            cate = d["cate_name"]
            cate_count[cate] += 1
            relation_count.setdefault(cate, {})
            pvs = parse_pvs(d)
            for k in pvs:
                relation_count[cate].setdefault(k, {
                    "total": 0, "1-total": 0, "0-total": 0, "1-same": 0,
                    "0-diff": 0, "1-diff": 0, "0-same": 0,
                    "0-diff-rate": 0.0, "1-same-rate": 0.0})
                relation_count[cate][k]["total"] += 1
            d["pvs"] = pvs
    return id_dict, dict(cate_count), relation_count


def accumulate_pair_statistics(id_dict: Dict, relation_count: Dict,
                               pair_path: str) -> None:
    """Same/diff value counts per relation over labeled same-category pairs
    (415-448)."""
    with open(pair_path, encoding="utf-8") as r:
        for line in r:
            d = json.loads(line.strip())
            d1 = id_dict[d["src_item_id"]]
            d2 = id_dict[d["tgt_item_id"]]
            label = d.get("item_label", "")
            if d1["cate_name"] != d2["cate_name"]:
                continue
            cate = d1["cate_name"]
            pv1, pv2 = d1["pvs"], d2["pvs"]
            for rel in set(pv1) & set(pv2):
                ct = relation_count[cate][rel]
                if label == "1":
                    ct["1-same" if pv1[rel] == pv2[rel] else "1-diff"] += 1
                    ct["1-total"] += 1
                elif label == "0":
                    ct["0-same" if pv1[rel] == pv2[rel] else "0-diff"] += 1
                    ct["0-total"] += 1


def filter_relations(relation_count: Dict, cate_count: Dict,
                     method: str = "freq", min_freq: int = 3,
                     min_prop: float = 0.1, max_rank: int = 20) -> Set[str]:
    """(445-474). Also fills the 0-diff-rate / 1-same-rate fields used by
    the pv ordering."""
    include: Set[str] = set()
    for cate, rels in relation_count.items():
        if method == "freq":
            for rel, ct in rels.items():
                ct["0-diff-rate"] = 0.0
                ct["1-same-rate"] = 0.0
                if ct["total"] >= min_freq or ct["total"] >= cate_count[cate] * min_prop:
                    include.add(rel)
                    ct["0-diff-rate"] = ct["0-diff"] / ct["0-total"] if ct["0-total"] else 0.0
                    ct["1-same-rate"] = ct["1-same"] / ct["1-total"] if ct["1-total"] else 0.0
        elif method == "topn":
            ranked = sorted(rels.items(), key=lambda kv: kv[1]["total"], reverse=True)
            for rel, _ in ranked[:max_rank]:
                include.add(rel)
        else:
            raise ValueError(f"unknown filter method: {method}")
    return include


# ------------------------------------------------------------------ KG ids
def build_kg(id_dict: Dict) -> Tuple[Dict[str, int], Dict[str, int],
                                     List[Tuple[str, str, str]]]:
    """Triples + id maps (655-744).  Entity order: per item — /item/<id>,
    its cate value, its industry value, then pv values; relation 0 is
    ``[PAD]``.  NB per reference, only the *last* value of a multi-valued
    relation appears in the triple set (706-711)."""
    entity_dict: Dict[str, int] = {}
    relation_dict: Dict[str, int] = {RELATION_PADDING: RELATION_PADDING_ID}
    triplets: Set[Tuple[str, str, str]] = set()

    def ent(key: str) -> int:
        if key not in entity_dict:
            entity_dict[key] = len(entity_dict)
        return entity_dict[key]

    for item_id, d in id_dict.items():
        head = f"/item/{item_id}"
        ent(head)
        ent(f"/value/{d['cate_name']}-{d['cate_id']}")
        ent(f"/value/{d['industry_name']}")
        for rel, vals in d.get("pvs", {}).items():
            tail = None
            for v in vals:
                tail = f"/value/{v}"
                ent(tail)
            if rel not in relation_dict:
                relation_dict[rel] = len(relation_dict)
            if tail is not None:
                triplets.add((head, rel, tail))
    return entity_dict, relation_dict, sorted(triplets)


def write_kg_files(output_dir: str, entity_dict: Dict[str, int],
                   relation_dict: Dict[str, int],
                   triplets: Sequence[Tuple[str, str, str]],
                   valid_proportion: float = 0.0,
                   test_proportion: float = 0.0, seed: int = 0) -> None:
    """entity2id/relation2id/{train,valid,test}2id files (722-761);
    *2id rows are (head_name, relation_name, tail_name) — the names are
    resolved through the id maps at load time (load_ccks)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "entity2id.txt"), "w", encoding="utf-8") as w:
        for name, idx in entity_dict.items():
            w.write(f"{name}\t{idx}\n")
    with open(os.path.join(output_dir, "relation2id.txt"), "w", encoding="utf-8") as w:
        for name, idx in relation_dict.items():
            w.write(f"{name}\t{idx}\n")
    triplets = list(triplets)
    random.Random(seed).shuffle(triplets)
    n_test = int(len(triplets) * test_proportion)
    n_valid = int(len(triplets) * valid_proportion)
    splits = {"test2id.txt": triplets[:n_test],
              "valid2id.txt": triplets[n_test:n_test + n_valid],
              "train2id.txt": triplets[n_test + n_valid:]}
    for fname, rows in splits.items():
        with open(os.path.join(output_dir, fname), "w", encoding="utf-8") as w:
            for h, r, t in rows:
                w.write(f"{h}\t{r}\t{t}\n")


# ----------------------------------------------------------- pv ordering
def _rate(relation_count, cate, rel) -> float:
    ct = relation_count.get(cate, {}).get(rel)
    if not ct:
        return 0.0
    return ct.get("0-diff-rate", 0.0) + ct.get("1-same-rate", 0.0)


def _total(relation_count, cate, rel) -> int:
    ct = relation_count.get(cate, {}).get(rel)
    return ct["total"] if ct else 0


def order_pvs_pair(src_pvs: Dict[str, Set[str]], tgt_pvs: Dict[str, Set[str]],
                   relation_count: Dict, src_cate: str, tgt_cate: str
                   ) -> Tuple[str, str]:
    """Shared-keys-first ordering (812-860): keys common to both items come
    first, sorted by (total freq src+tgt, discriminativeness src+tgt, values)
    descending; then each item's distinct keys sorted by its own
    (total, rate, values)."""
    shared = set(src_pvs) & set(tgt_pvs)

    def fmt(k, vs):
        return f"{k}:{','.join(vs)}"

    def union_key(cate_a, cate_b):
        def key(kv):
            k, vs = kv
            return (_total(relation_count, cate_a, k) + _total(relation_count, cate_b, k),
                    _rate(relation_count, cate_a, k) + _rate(relation_count, cate_b, k),
                    sorted(vs))
        return key

    def diff_key(cate):
        def key(kv):
            k, vs = kv
            return (_total(relation_count, cate, k),
                    _rate(relation_count, cate, k), sorted(vs))
        return key

    def one_side(pvs, own_cate):
        union = {k: v for k, v in pvs.items() if k in shared}
        diff = {k: v for k, v in pvs.items() if k not in shared}
        parts = [fmt(k, vs) for k, vs in
                 sorted(union.items(), key=union_key(src_cate, tgt_cate), reverse=True)]
        parts += [fmt(k, vs) for k, vs in
                  sorted(diff.items(), key=diff_key(own_cate), reverse=True)]
        return ";".join(parts)

    return one_side(src_pvs, src_cate), one_side(tgt_pvs, tgt_cate)


def order_pvs_single(pvs: Dict[str, Set[str]], relation_count: Dict,
                     cate: str) -> str:
    """Frequency ordering for single items (easy negatives, 1050-1060)."""
    def key(kv):
        k, vs = kv
        return (_total(relation_count, cate, k), _rate(relation_count, cate, k),
                sorted(vs))

    return ";".join(f"{k}:{','.join(vs)}"
                    for k, vs in sorted(pvs.items(), key=key, reverse=True))


# --------------------------------------------------------- pair building
def segment_title(title: str) -> str:
    import jieba
    return " ".join(jieba.cut(title))


def emb_text(e) -> str:
    """Embedding -> the TSV's comma-joined ASCII form.  Accepts either the
    preformatted text ``dump_image_embeddings`` now returns (formatted once
    per ITEM, natively) or a raw float sequence (legacy json.load path)."""
    return e if isinstance(e, str) else ",".join(str(x) for x in e)


def build_finetune_pairs(id_dict: Dict, relation_count: Dict, pair_path: str,
                         img_emb: Optional[Dict[str, object]] = None,
                         default_label: Optional[str] = None) -> List[Tuple]:
    """Labeled pair jsonl -> TSV rows (label, src_id, src_title, src_pvs
    [, src_img], tgt_id, tgt_title, tgt_pvs[, tgt_img]) with jieba-cut
    titles and shared-first pv ordering (768-928)."""
    rows = []
    with open(pair_path, encoding="utf-8") as r:
        for line in r:
            d = json.loads(line.strip())
            sid, tid = d["src_item_id"], d["tgt_item_id"]
            ds, dt = id_dict[sid], id_dict[tid]
            src_title = segment_title(ds.get("title", ""))
            tgt_title = segment_title(dt.get("title", ""))
            src_pvs, tgt_pvs = order_pvs_pair(
                ds.get("pvs", {}), dt.get("pvs", {}), relation_count,
                ds["cate_name"], dt["cate_name"])
            label = d.get("item_label", default_label)
            if label is None:
                label = "0"
            if img_emb is not None:
                se = emb_text(img_emb[sid])
                te = emb_text(img_emb[tid])
                rows.append((label, sid, src_title, src_pvs, se,
                             tid, tgt_title, tgt_pvs, te))
            else:
                rows.append((label, sid, src_title, src_pvs,
                             tid, tgt_title, tgt_pvs))
    return rows


def split_train_valid(pairs: List[Tuple], valid_proportion: float = 0.1,
                      seed: int = 0, prev_valid: Optional[str] = None,
                      with_image: bool = False
                      ) -> Tuple[List[Tuple], List[Tuple]]:
    """Random split, or pin the valid set to a previous TSV via pair keys
    (``--prev_valid``, 882-928)."""
    tgt_idx = 5 if with_image else 4
    if prev_valid is None:
        pairs = list(pairs)
        random.Random(seed).shuffle(pairs)
        idx = int(len(pairs) * valid_proportion)
        return pairs[idx:], pairs[:idx]
    pairs_dict = {f"{p[1]}-{p[tgt_idx]}": p for p in pairs}
    valid = []
    with open(prev_valid, encoding="utf-8") as r:
        for line in r:
            items = line.strip("\n").split("\t")
            key = f"{items[1]}-{items[tgt_idx]}"
            valid.append(pairs_dict.pop(key))
    return list(pairs_dict.values()), valid


def augment_easy_negatives(id_dict: Dict, relation_count: Dict,
                           num_items: int, num_neg: int, seed: int = 0,
                           img_emb: Optional[Dict] = None) -> List[Tuple]:
    """Cross-category random negatives (1030-1128)."""
    rng = random.Random(seed)
    keys = list(id_dict.keys())
    selected = rng.sample(keys, min(num_items, len(keys)))
    rows = []
    for id1 in selected:
        d1 = id_dict[id1]
        seen: Set[str] = set()
        attempts = 0
        while len(seen) < num_neg and attempts < 100 * num_neg:
            attempts += 1
            id2 = rng.choice(keys)
            d2 = id_dict[id2]
            if d2["cate_name"] == d1["cate_name"] or id2 == id1 or id2 in seen:
                continue
            pvs1 = order_pvs_single(d1.get("pvs", {}), relation_count, d1["cate_name"])
            pvs2 = order_pvs_single(d2.get("pvs", {}), relation_count, d2["cate_name"])
            t1, t2 = d1.get("title", ""), d2.get("title", "")
            if img_emb is not None:
                rows.append(("0", id1, t1, pvs1, emb_text(img_emb[id1]),
                             id2, t2, pvs2, emb_text(img_emb[id2])))
            else:
                rows.append(("0", id1, t1, pvs1, id2, t2, pvs2))
            seen.add(id2)
    return rows


def write_tsv(rows: Sequence[Tuple], path: str, shuffle: bool = False,
              seed: int = 0) -> None:
    rows = list(rows)
    if shuffle:
        random.Random(seed).shuffle(rows)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as w:
        for row in rows:
            w.write("\t".join(row) + "\n")


def read_tsv(path: str) -> List[Tuple[str, ...]]:
    """Tab-separated rows of a UTF-8 file, by the native scanner: lines end
    at ``\\n`` only (a ``\\r`` stays in the last field), fields split at
    every tab, and only empty lines are skipped."""
    from item_alignment_torch.data.native_loader import read_tsv_fast

    return read_tsv_fast(path)


def read_finetune_tsv(path: str, id_dict: Optional[Dict] = None,
                      cate2id: Optional[Dict[str, int]] = None) -> List[Tuple]:
    """TSV -> 9-tuple rows with cate ids spliced in, matching
    ``finetune_text.load_raw_data`` (finetune_text.py:91-150)."""
    rows = []
    for fields in read_tsv(path):
        (label, sid, s_title, s_pvs, tid, t_title, t_pvs) = fields
        s_cate = t_cate = 0
        if id_dict is not None and cate2id is not None:
            s_cate = cate2id.get(id_dict[sid]["cate_name"], 0)
            t_cate = cate2id.get(id_dict[tid]["cate_name"], 0)
        rows.append((label, sid, s_cate, s_title, s_pvs,
                     tid, t_cate, t_title, t_pvs))
    return rows


def prepare_all(data_dir: str, output_dir: str, valid_proportion: float = 0.1,
                seed: int = 0, num_train_augment: int = 0, num_neg: int = 5,
                prev_valid: Optional[str] = None,
                img_emb: Optional[Dict[str, object]] = None
                ) -> Dict[str, str]:
    """Full offline pipeline: stats -> KG files -> ordered finetune TSVs.
    Expects ``item_info.jsonl`` and ``item_train_pair.jsonl`` (and optionally
    ``item_test_pair.jsonl``) under ``data_dir``.  With ``img_emb`` set
    (``--with_image``), TSV rows carry the 9-column image-embedding layout
    the multimodal models consume (data_prepare.py:786-800)."""
    info_path = os.path.join(data_dir, "item_info.jsonl")
    train_pair = os.path.join(data_dir, "item_train_pair.jsonl")
    id_dict, cate_count, relation_count = load_item_info(info_path)
    accumulate_pair_statistics(id_dict, relation_count, train_pair)
    filter_relations(relation_count, cate_count)

    ent, rel, triples = build_kg(id_dict)
    write_kg_files(output_dir, ent, rel, triples)

    cate2id = {c: i for i, c in enumerate(sorted(cate_count))}
    with open(os.path.join(output_dir, "cate2id.json"), "w", encoding="utf-8") as w:
        json.dump(cate2id, w, ensure_ascii=False)

    pairs = build_finetune_pairs(id_dict, relation_count, train_pair,
                                 img_emb=img_emb)
    train, valid = split_train_valid(pairs, valid_proportion, seed, prev_valid,
                                     with_image=img_emb is not None)
    if num_train_augment > 0:
        train = train + augment_easy_negatives(
            id_dict, relation_count, num_train_augment, num_neg, seed,
            img_emb=img_emb)
    out = {}
    out["train"] = os.path.join(output_dir, "finetune_train_train.tsv")
    out["valid"] = os.path.join(output_dir, "finetune_train_valid.tsv")
    write_tsv(train, out["train"], shuffle=True, seed=seed)
    write_tsv(valid, out["valid"])
    test_pair = os.path.join(data_dir, "item_test_pair.jsonl")
    if os.path.exists(test_pair):
        test_rows = build_finetune_pairs(id_dict, relation_count, test_pair,
                                         img_emb=img_emb, default_label="0")
        out["test"] = os.path.join(output_dir, "finetune_test.tsv")
        write_tsv(test_rows, out["test"])
    logger.info(f"[prepare_all] train={len(train)} valid={len(valid)}")
    return out
