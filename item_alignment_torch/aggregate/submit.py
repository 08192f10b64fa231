"""Competition submission packaging.

Port of ``item_alignment_tpu/aggregate/submit.py``.  The scorer unzips
``result.zip``, which holds ``similarity.py`` and ``deepAI_result.jsonl``,
and calls ``compute(item_emb_1, item_emb_2)`` on each row (reference
``submit/similarity.py:27-28``); the pair probability is stored in
``tgt_item_emb[0]``.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Optional

SIMILARITY_PY = '''\
import json


def compute(item_emb_1, item_emb_2):
    """Scorer entry point: the pair score is stored in tgt_item_emb[0]."""
    return item_emb_2[0]


def load_embeddings(path):
    rows = []
    with open(path, "r", encoding="utf-8") as r:
        for line in r:
            d = json.loads(line)
            rows.append((d["src_item_id"], json.loads(d["src_item_emb"]),
                         d["tgt_item_id"], json.loads(d["tgt_item_emb"]),
                         d.get("threshold", 0.0)))
    return rows
'''


def package_submission(result_jsonl: str, output_zip: str,
                       similarity_src: Optional[str] = None) -> str:
    """Zip ``similarity.py`` and ``deepAI_result.jsonl`` into the
    submission archive."""
    os.makedirs(os.path.dirname(output_zip) or ".", exist_ok=True)
    with zipfile.ZipFile(output_zip, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("similarity.py",
                   similarity_src if similarity_src else SIMILARITY_PY)
        z.write(result_jsonl, "deepAI_result.jsonl")
    return output_zip


def validate_submission(result_jsonl: str, max_dim: int = 1024) -> dict:
    """Check the competition's contract: every row parses, has its five
    keys, and an embedding of 1 to ``max_dim`` values."""
    n = 0
    with open(result_jsonl, encoding="utf-8") as r:
        for line in r:
            d = json.loads(line)
            for key in ("src_item_id", "src_item_emb", "tgt_item_id",
                        "tgt_item_emb", "threshold"):
                if key not in d:
                    raise ValueError(f"row {n}: missing {key}")
            emb = json.loads(d["tgt_item_emb"])
            if not (isinstance(emb, list) and 1 <= len(emb) <= max_dim):
                raise ValueError(f"row {n}: tgt_item_emb has "
                                 f"{len(emb) if isinstance(emb, list) else 'no'}"
                                 f" values (1 to {max_dim} allowed)")
            n += 1
    return {"rows": n, "ok": True}
