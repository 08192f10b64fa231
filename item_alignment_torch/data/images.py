"""Image-embedding text: the form the finetune TSVs and
``image_embedding.json`` hold the image vectors in.

Port of the parts of ``item_alignment_tpu/data/images.py`` that need no
image tower: ``embedding_texts``, ``embedding_texts_from_mapping`` and
``write_embedding_json``.  Each vector is a row of comma-joined ``%.9g``
decimals, which give every fp32 value back exactly.  The port formats in
Python (the JAX package's native formatter writes the same text for finite
values).  Dumping the embeddings through an image tower, the image
transforms, shards and crops are not ported yet (ROADMAP Queue 1 #9: The
image towers).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np


def embedding_texts(mat: np.ndarray) -> List[str]:
    """[n, d] floats -> comma-joined ``%.9g`` rows, one per vector."""
    return [",".join(f"{x:.9g}" for x in row)
            for row in np.asarray(mat).tolist()]


def embedding_texts_from_mapping(raw: Dict[str, Sequence[float]]
                                 ) -> Dict[str, str]:
    """{id: floats} (a ``json.load``'ed ``image_embedding.json``) -> {id:
    text}, each vector rounded to fp32 first; rows of any length."""
    items = list(raw.items())
    if not items:
        return {}
    try:
        mat = np.asarray([v for _, v in items], np.float32)
        if mat.ndim != 2:
            raise ValueError("ragged")
        texts = embedding_texts(mat)
    except ValueError:  # ragged rows: one row at a time
        texts = [embedding_texts(np.asarray([v], np.float32))[0]
                 for _, v in items]
    return {k: t for (k, _), t in zip(items, texts)}


def load_embedding_json(path: str) -> Dict[str, str]:
    """``image_embedding.json`` -> {item id: embedding text}."""
    with open(path, encoding="utf-8") as r:
        return embedding_texts_from_mapping(json.load(r))


def write_embedding_json(ids: Sequence[str], texts: Sequence[str],
                         out_path: str) -> None:
    """``image_embedding.json``, ``{item_id: [floats...]}``, from row texts
    (``ensure_ascii=False`` keeps UTF-8 ids literal)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as w:
        w.write("{")
        for i, (iid, text) in enumerate(zip(ids, texts)):
            if i:
                w.write(",")
            w.write(f"{json.dumps(iid, ensure_ascii=False)}: [{text}]")
        w.write("}")
