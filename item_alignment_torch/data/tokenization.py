"""Text layouts: raw pair rows -> fixed-shape numpy arrays.

Port of the text layouts of ``item_alignment_tpu/data/tokenization.py``
(the reference's ``src/data/data.py``), with the port's own tokenizer
(``data/wordpiece.py``) in place of ``transformers.BertTokenizer``:

- one-tower ``cls``:     ``[CLS] src [SEP] tgt [SEP]``, pair encoding with
  ``longest_first`` truncation to 2*max_length (data.py:558-563);
- one-tower ``vec_sim``: src and tgt padded on their own, tgt's [CLS]
  replaced by [BOS] and its token types + 1 (data.py:548-556);
- two-tower:             per item ``title [SEP] jieba(pvs)`` (data.py:786-832);
- the auxiliary task's ``pair_spans``: a colon/semicolon scan over the pv
  ids (data.py:568-615), padded to a fixed [max_pairs, 5] block.

``segment_pvs`` calls ``jieba`` when it is called, as the JAX package does;
without jieba it raises ``ImportError``.  There is no whitespace fallback:
another segmentation gives other WordPiece ids (``商品`` -> ``商 ##品``).
The PKGM, image, multimodal and pv-pair layouts come with their model
families (ROADMAP Queue 1 #5, #6).
"""

from __future__ import annotations

import functools
import multiprocessing as mp
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from item_alignment_torch.data.datasets import ArrayDataset
from item_alignment_torch.data.wordpiece import WordPieceTokenizer

COLON_ID = 131
SEMICOLON_ID = 132


def load_text_tokenizer(path: str) -> WordPieceTokenizer:
    """The tokenizer of ``path/vocab.txt`` (or of ``path`` itself when it is
    the file), with the bos token ``"<S>"``."""
    vocab = os.path.join(path, "vocab.txt") if os.path.isdir(path) else path
    return WordPieceTokenizer(vocab)


def segment_pvs(pvs: str) -> str:
    """jieba word segmentation, space-joined (data.py:541-544)."""
    import jieba

    return " ".join(jieba.cut(pvs))


def build_item_text(title: str, pvs: str, sep_token: str = "[SEP]") -> str:
    """``title [SEP] jieba(pvs)`` (data.py:541-544)."""
    return " ".join((title, sep_token, segment_pvs(pvs)))


# ----------------------------------------------------------------- layouts
def encode_one_tower_cls(tok, src_text: str, tgt_text: str, max_length: int
                         ) -> Dict[str, List[int]]:
    return tok(text=src_text, text_pair=tgt_text, max_length=2 * max_length,
               padding="max_length", truncation="longest_first")


def encode_one_tower_vec_sim(tok, src_text: str, tgt_text: str, max_length: int
                             ) -> Dict[str, List[int]]:
    src = tok(text=src_text, max_length=max_length, padding="max_length",
              truncation="longest_first")
    tgt = tok(text=tgt_text, max_length=max_length, padding="max_length",
              truncation="longest_first")
    input_ids = src["input_ids"] + [tok.bos_token_id] + tgt["input_ids"][1:]
    token_type_ids = src["token_type_ids"] + [t + 1 for t in tgt["token_type_ids"]]
    attention_mask = src["attention_mask"] + tgt["attention_mask"]
    return {"input_ids": input_ids, "token_type_ids": token_type_ids,
            "attention_mask": attention_mask}


def encode_two_tower_item(tok, text: str, max_length: int) -> Dict[str, List[int]]:
    return tok(text=text, max_length=max_length, padding="max_length",
               truncation="longest_first")


def extract_pair_indices(input_ids: Sequence[int], sep_id: int,
                         max_pairs: int) -> np.ndarray:
    """Aligned-pv-pair spans for the auxiliary task (data.py:568-615).

    Walks the src and tgt pv regions in lockstep; for each aligned key emits
    (src_start, src_end, tgt_start, tgt_end, same_value), padded to
    [max_pairs, 5] with -1 rows."""
    pos_sep = [i for i, t in enumerate(input_ids) if t == sep_id]
    out = np.full((max_pairs, 5), -1, dtype=np.int32)
    if len(pos_sep) < 4:
        return out
    src_pre, tgt_pre = pos_sep[0] + 1, pos_sep[2] + 1
    src_ids = list(input_ids[pos_sep[0] + 1: pos_sep[1]])
    tgt_ids = list(input_ids[pos_sep[2] + 1: pos_sep[3]])
    pairs = []
    src_p = tgt_p = 0
    src_colon, src_semi, src_prev_semi = None, -1, None
    tgt_colon, tgt_semi, tgt_prev_semi = None, -1, None
    while src_p < len(src_ids) and tgt_p < len(tgt_ids):
        while src_p < len(src_ids):
            if src_ids[src_p] == COLON_ID:
                src_colon = src_p
            elif src_ids[src_p] == SEMICOLON_ID:
                src_prev_semi = src_semi
                src_semi = src_p
                src_p += 1
                break
            src_p += 1
        else:
            break
        while tgt_p < len(tgt_ids):
            if tgt_ids[tgt_p] == COLON_ID:
                tgt_colon = tgt_p
            elif tgt_ids[tgt_p] == SEMICOLON_ID:
                tgt_prev_semi = tgt_semi
                tgt_semi = tgt_p
                tgt_p += 1
                break
            tgt_p += 1
        else:
            break
        src_key = src_ids[src_prev_semi + 1: src_colon]
        src_value = src_ids[src_colon + 1: src_semi]
        tgt_key = tgt_ids[tgt_prev_semi + 1: tgt_colon]
        tgt_value = tgt_ids[tgt_colon + 1: tgt_semi]
        if src_key != tgt_key:
            break
        pairs.append([src_prev_semi + 1 + src_pre, src_semi + src_pre,
                      tgt_prev_semi + 1 + tgt_pre, tgt_semi + tgt_pre,
                      1 if src_value == tgt_value else 0])
    for i, p in enumerate(pairs[:max_pairs]):
        out[i] = p
    return out


# ----------------------------------------------------------- dataset build
def _encode_one_tower_row(row, tok, max_seq_len, max_seq_len_pv,
                          classification_method, auxiliary_task, max_pairs):
    """Module-level row encoder, so that a worker process can unpickle it."""
    (label, src_item_id, _, src_title, src_pvs,
     tgt_item_id, _, tgt_title, tgt_pvs) = row
    if max_seq_len is None:
        src_text, tgt_text, max_length = src_pvs, tgt_pvs, max_seq_len_pv
    elif max_seq_len_pv is None:
        src_text, tgt_text, max_length = src_title, tgt_title, max_seq_len
    else:
        src_text = build_item_text(src_title, src_pvs, tok.sep_token)
        tgt_text = build_item_text(tgt_title, tgt_pvs, tok.sep_token)
        max_length = max_seq_len + max_seq_len_pv
    if classification_method == "vec_sim":
        enc = encode_one_tower_vec_sim(tok, src_text, tgt_text, max_length)
    else:
        enc = encode_one_tower_cls(tok, src_text, tgt_text, max_length)
    enc["labels"] = int(label)
    if auxiliary_task:
        enc["pair_spans"] = extract_pair_indices(
            enc["input_ids"], tok.sep_token_id, max_pairs)
    enc["src_item_id"] = src_item_id
    enc["tgt_item_id"] = tgt_item_id
    return enc


def rows_to_one_tower_dataset(
    rows: Sequence, tok, max_seq_len: Optional[int], max_seq_len_pv: Optional[int],
    classification_method: str = "cls", auxiliary_task: bool = False,
    max_pairs: int = 32, num_workers: int = 0,
) -> ArrayDataset:
    """TSV rows (label, src_id, src_cate, src_title, src_pvs, tgt_id,
    tgt_cate, tgt_title, tgt_pvs) -> fixed arrays (data.py:519-620).

    ``num_workers > 1`` spreads the rows over that many processes, started
    with ``spawn`` (the JAX package forks; a fork of a process that runs
    torch's thread pools is unsafe)."""
    encode = functools.partial(
        _encode_one_tower_row, tok=tok, max_seq_len=max_seq_len,
        max_seq_len_pv=max_seq_len_pv,
        classification_method=classification_method,
        auxiliary_task=auxiliary_task, max_pairs=max_pairs)
    if num_workers > 1 and len(rows) >= 4 * num_workers:
        with mp.get_context("spawn").Pool(num_workers) as pool:
            encs = pool.map(encode, rows, chunksize=64)
    else:
        encs = [encode(row) for row in rows]

    feats: Dict[str, list] = {"input_ids": [], "token_type_ids": [],
                              "attention_mask": [], "labels": []}
    if auxiliary_task:
        feats["pair_spans"] = []
    meta = {"src_item_id": [], "tgt_item_id": []}
    for enc in encs:
        for k in feats:
            feats[k].append(enc[k])
        meta["src_item_id"].append(enc["src_item_id"])
        meta["tgt_item_id"].append(enc["tgt_item_id"])
    arrays = {k: np.asarray(v, dtype=np.int32) for k, v in feats.items()}
    return ArrayDataset(arrays, meta)


def rows_to_two_tower_dataset(
    rows: Sequence, tok, max_seq_len: Optional[int], max_seq_len_pv: Optional[int],
) -> ArrayDataset:
    """-> input_ids_{1,2} / attention_mask_{1,2} / token_type_ids_{1,2}
    (data.py:786-832)."""
    feats: Dict[str, list] = {f"{k}_{i}": [] for k in
                              ("input_ids", "attention_mask", "token_type_ids")
                              for i in (1, 2)}
    feats["labels"] = []
    meta = {"src_item_id": [], "tgt_item_id": []}
    max_length = (max_seq_len or 0) + (max_seq_len_pv or 0)
    for row in rows:
        (label, src_item_id, _, src_title, src_pvs,
         tgt_item_id, _, tgt_title, tgt_pvs) = row
        for i, (title, pvs) in enumerate(((src_title, src_pvs),
                                          (tgt_title, tgt_pvs)), start=1):
            text = build_item_text(title, pvs, tok.sep_token)
            enc = encode_two_tower_item(tok, text, max_length)
            feats[f"input_ids_{i}"].append(enc["input_ids"])
            feats[f"attention_mask_{i}"].append(enc["attention_mask"])
            feats[f"token_type_ids_{i}"].append(enc["token_type_ids"])
        feats["labels"].append(int(label))
        meta["src_item_id"].append(src_item_id)
        meta["tgt_item_id"].append(tgt_item_id)
    arrays = {k: np.asarray(v, dtype=np.int32) for k, v in feats.items()}
    return ArrayDataset(arrays, meta)


def encode_texts(vocab_path: str, texts: Sequence[str], max_length: int,
                 num_workers: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Item or entity texts -> (input_ids, attention_mask) [n, max_length]
    int32, padded and truncated; ``num_workers > 1`` spreads them over that
    many ``spawn`` processes in contiguous slices (``mine`` and
    ``pred-text``)."""
    if num_workers > 1 and len(texts) >= 4 * num_workers:
        sl = (len(texts) + num_workers - 1) // num_workers
        payloads = [(vocab_path, texts[i: i + sl], max_length)
                    for i in range(0, len(texts), sl)]
        with mp.get_context("spawn").Pool(num_workers) as pool:
            parts = pool.map(_encode_texts_slice, payloads)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
    return _encode_texts_slice((vocab_path, texts, max_length))


def _encode_texts_slice(payload):
    vocab_path, texts, max_length = payload
    enc = load_text_tokenizer(vocab_path)(
        list(texts), padding="max_length", truncation=True,
        max_length=max_length)
    return (np.asarray(enc["input_ids"], np.int32).reshape(-1, max_length),
            np.asarray(enc["attention_mask"], np.int32).reshape(-1, max_length))


def load_kg_tokenizers(entity2id_path: str, relation2id_path: str
                       ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Read ``entity2id.txt`` / ``relation2id.txt``: plain ``name\\tid``
    rows, no count header (finetune_text.py:153-172)."""

    def read(path):
        d = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip("\n")
                if not line.strip():
                    continue
                name, idx = line.rsplit("\t", 1)
                d[name] = int(idx)
        return d

    return read(entity2id_path), read(relation2id_path)
