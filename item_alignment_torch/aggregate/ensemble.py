"""Prediction-level ensembling.

Port of ``item_alignment_tpu/aggregate/ensemble.py`` (the reference's
``model_ensemble.py``), plain Python:

- **threshold strategy**: per pair, add up ``prob - model_threshold`` over
  the members; the fused score is that sum, and the pair is predicted 1
  iff it is >= 0.
- **f1 strategy**: each member casts an f1-weighted vote for its side of
  its own threshold; the larger vote wins (fused score +1.0 or -1.0).
- **category-aware split**: pairs with a category that never appears in
  training take another list of (member, threshold, f1).

Inputs and outputs are submission-format JSONL rows as
``engine.train.Trainer.predict_jsonl`` writes them.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from item_alignment_torch.utils import logger

# categories absent from training (reference model_ensemble.py:9-11)
ONLY_VALID_CATES = ['投资贵金属', '客厅吸顶灯', '衬衫', '电热水壶', '养生壶/煎药壶',
                    '鞋柜', '脱毛膏', '自热火锅', '洗烘套装', '椰棕床垫', '足浴器',
                    '茶壶', '电动自行车']
ONLY_TEST_CATES = ['鞋柜', '洗衣机', '衬衫', '茶壶', '电动自行车', '脱毛膏',
                   '投资贵金属', '椰棕床垫', '身体乳液', '客厅吸顶灯', '电热水壶',
                   '足浴器', '养生壶/煎药壶', '洗烘套装', '自热火锅']

Member = Tuple[Sequence[Dict], float, float]  # (rows, threshold, f1)


def parse_prob(emb_str: str) -> float:
    """The pair probability, stored in ``tgt_item_emb[0]``."""
    return float(emb_str.strip()[1:-1].split(",")[0])


def read_prediction_file(path: str) -> List[Dict]:
    with open(path, encoding="utf-8") as r:
        return [json.loads(line) for line in r if line.strip()]


def write_prediction_file(rows: Iterable[Dict], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as w:
        for row in rows:
            w.write(json.dumps(row) + "\n")
    return path


def _accumulate(lines: Dict[str, Dict], rows: Sequence[Dict],
                threshold: float, f1: float,
                keep: Optional[Callable[[Dict], bool]] = None) -> None:
    for d in rows:
        if keep is not None and not keep(d):
            continue
        key = d["src_item_id"] + "-" + d["tgt_item_id"]
        prob = parse_prob(d["tgt_item_emb"])
        if key not in lines:
            lines[key] = {"src_item_id": d["src_item_id"],
                          "tgt_item_id": d["tgt_item_id"],
                          "src_item_emb": d.get("src_item_emb", "[0]"),
                          "score": 0.0, "vote0": 0.0, "vote1": 0.0}
        lines[key]["score"] += prob - threshold
        if prob >= threshold:
            lines[key]["vote1"] += f1
        else:
            lines[key]["vote0"] += f1


def ensemble_predictions(
    model_predictions: Sequence[Member],
    strategy: str = "threshold",
    unseen_model_predictions: Optional[Sequence[Member]] = None,
    pair_is_unseen: Optional[Callable[[Dict], bool]] = None,
) -> List[Dict]:
    """Fuse the members' prediction rows.

    With ``unseen_model_predictions`` and ``pair_is_unseen(row) -> bool``,
    seen pairs take the first list and unseen pairs the second.  Returns
    submission rows with the fused score in ``tgt_item_emb[0]`` and
    threshold 0.0, in the order the pairs first appear."""
    lines: Dict[str, Dict] = {}
    if unseen_model_predictions is not None:
        if pair_is_unseen is None:
            raise ValueError("the category split needs pair_is_unseen")
        for rows, thr, f1 in model_predictions:
            _accumulate(lines, rows, thr, f1,
                        keep=lambda d: not pair_is_unseen(d))
        for rows, thr, f1 in unseen_model_predictions:
            _accumulate(lines, rows, thr, f1, keep=pair_is_unseen)
    else:
        for rows, thr, f1 in model_predictions:
            _accumulate(lines, rows, thr, f1)

    out = []
    positives = 0
    for d in lines.values():
        if strategy == "f1":
            p = 1.0 if d["vote1"] >= d["vote0"] else -1.0
        elif strategy == "threshold":
            p = d["score"]
        else:
            raise ValueError(f"unsupported ensemble strategy: {strategy}")
        positives += int(p >= 0.0)
        out.append({"src_item_id": d["src_item_id"],
                    "src_item_emb": d["src_item_emb"],
                    "tgt_item_id": d["tgt_item_id"],
                    "tgt_item_emb": f"[{p}]",
                    "threshold": 0.0})
    logger.info(f"[ensemble/{strategy}] positives {positives}/{len(out)}")
    return out


def make_unseen_checker(id_dict: Dict[str, Dict],
                        unseen_cates: Sequence[str] = tuple(ONLY_TEST_CATES)
                        ) -> Callable[[Dict], bool]:
    """Whether a pair's src or tgt category is one of ``unseen_cates``."""
    unseen = set(unseen_cates)

    def check(row: Dict) -> bool:
        src = id_dict.get(row["src_item_id"], {}).get("cate_name")
        tgt = id_dict.get(row["tgt_item_id"], {}).get("cate_name")
        return src in unseen or tgt in unseen

    return check
