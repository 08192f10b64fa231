"""The one traffic generator: every mix is a file of parameters,
``portbench/traffic/<name>.json``, from which this module draws.

Two kinds of mix:

- ``pairs``: batches of ``rows`` pair rows of ``seq_len`` tokens, as the
  one-tower datasets hold them (int32 ``input_ids``, ``attention_mask``,
  ``token_type_ids``; with ``labels`` balanced 0/1 labels; with
  ``image_hidden_size`` an fp32 image feature for each side and the tgt
  image's position ``image_indices``).  A pool of ``pool`` distinct
  batches is made and cycled.
- ``items``: mining rounds of ``items`` new item rows of ``seq_len``
  tokens (``input_ids``, ``attention_mask``) and ``candidates`` candidate
  pairs per item: each item against rows drawn uniformly from the round.
  A pool of ``pool`` distinct rounds is made and cycled.

The lengths are those of ``chip_smoke.py:pair_batch`` (uniform from
``min_len`` to ``seq_len``, the rest padding with id 0 and mask 0), except
that the same evenly spread set of lengths is drawn for every seed and the
seed only orders it, so every seed asks for the same work.  Token ids are
uniform over ``[5, vocab_size)``; token types are 0 up to the middle of a
row's length and 1 after it, where the tgt item starts and, with images,
where its ``[IMG]`` token (id 99) sits; position 1 holds the src
``[IMG]``.  Everything is drawn from ``seed`` by numpy on the host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IMG_TOKEN_ID = 99


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2 ** 64, stream])


def _lengths(gen: np.random.Generator, n: int, lo: int, hi: int
             ) -> np.ndarray:
    """``n`` lengths spread evenly over ``[lo, hi]``, in the seed's
    order."""
    even = np.round(np.linspace(lo, hi, n)).astype(np.int64)
    return gen.permutation(even)


def _rows(gen, lengths: np.ndarray, seq_len: int, vocab: int):
    n = len(lengths)
    mask = (np.arange(seq_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids = gen.integers(5, vocab, (n, seq_len)).astype(np.int32) * mask
    return ids, mask


def pair_batches(mix: Dict, vocab: int, seed: int) -> List[Dict]:
    rows, S, pool = mix["rows"], mix["seq_len"], mix["pool"]
    gen = rng(seed, 1)
    lengths = _lengths(gen, rows * pool, mix["min_len"], S)
    ids, mask = _rows(gen, lengths, S, vocab)
    split = lengths // 2
    types = ((np.arange(S)[None, :] >= split[:, None]) * mask).astype(np.int32)
    out = []
    for b in range(pool):
        r = slice(b * rows, (b + 1) * rows)
        batch = {"input_ids": ids[r], "attention_mask": mask[r],
                 "token_type_ids": types[r]}
        if mix.get("labels"):
            batch["labels"] = gen.permutation(
                np.arange(rows) % 2).astype(np.int32)
        width = mix.get("image_hidden_size")
        if width:
            batch["input_ids"] = batch["input_ids"].copy()
            batch["input_ids"][:, 1] = IMG_TOKEN_ID
            batch["input_ids"][np.arange(rows), split[r]] = IMG_TOKEN_ID
            batch["image_indices"] = split[r].astype(np.int32)
            for side in ("src_image_embeds", "tgt_image_embeds"):
                batch[side] = gen.standard_normal(
                    (rows, width), dtype=np.float32)
        out.append(batch)
    return out


def item_rounds(mix: Dict, vocab: int, seed: int) -> List[Dict]:
    n, S, per = mix["items"], mix["seq_len"], mix["candidates"]
    gen = rng(seed, 2)
    out = []
    for r in range(mix["pool"]):
        ids, mask = _rows(gen, _lengths(gen, n, mix["min_len"], S), S, vocab)
        out.append({"input_ids": ids, "attention_mask": mask,
                    "src": np.repeat(np.arange(n, dtype=np.int64), per),
                    "tgt": gen.integers(0, n, n * per).astype(np.int64)})
    return out


def make(mix: Dict, vocab: int, seed: int) -> List[Dict]:
    if mix["kind"] == "pairs":
        return pair_batches(mix, vocab, seed)
    if mix["kind"] == "items":
        return item_rounds(mix, vocab, seed)
    raise ValueError(f"unknown traffic kind {mix['kind']!r}")
