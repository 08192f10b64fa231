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
- PKGM: per item the text ids, then the entity id and the relation ids
  (the id space), with masks and token types over the embedded length
  ``max_seq_len + 2 * max_pvs`` and explicit positions (data.py:277-516).
- RobertaImage: 9-column rows with the image-embedding text of each item;
  with ``ensemble == "begin"`` each text gets an ``[unused99] [SEP]``
  prefix, and the one-tower records the tgt image token's position per
  pair (data.py:623-753).
- the pv-pair variant (``rows_to_pv_pair_dataset``, data.py:756-783):
  ``[CLS] src_title [SEP] tgt_title [SEP] jieba(pv_pair_text) [SEP]``, its
  token types bumped by one after the second [SEP].
- CoCa: each item's text and its uint8 image (``build_multimodal_pair_
  dataset``, data.py:933-989), and the pretraining examples, one item's
  text and image each (``build_multimodal_pretrain_dataset``,
  data.py:872-930).

The image token is ``[unused99]``, id 99, as the JAX package hard-codes it.
The tokenizer does not treat it as special: it comes out as id 99 only when
the vocab has ``[unused99]`` at row 99 (BERT-Chinese vocabs do).  With any
other vocab no position holds id 99, ``image_indices`` falls back to 1 and
both images land on position 1, in the port as in JAX.
"""

from __future__ import annotations

import functools
import multiprocessing as mp
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from item_alignment_torch.data.datasets import ArrayDataset
from item_alignment_torch.data.wordpiece import WordPieceTokenizer
from item_alignment_torch.utils import BOS_TOKEN

IMG_TOKEN = "[unused99]"
IMG_TOKEN_ID = 99
COLON_ID = 131
SEMICOLON_ID = 132


def _parse_embedding_column(s, image_hidden_size: int) -> np.ndarray:
    """Comma-joined float text (one TSV image-embedding column,
    data.py:650-656) -> fixed ``[image_hidden_size]`` fp32: cut to that
    width or zero-padded; empty text gives zeros."""
    out = np.zeros(image_hidden_size, np.float32)
    if s:
        parts = [p for p in s.split(",") if p.strip()]
        if parts:
            vals = np.asarray(parts[:image_hidden_size], dtype=np.float32)
            out[: len(vals)] = vals
    return out


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


# ------------------------------------------------------------ image splice
def _image_item_text(title: str, pvs: str, max_seq_len, max_seq_len_pv, tok):
    """The reference's text gating (data.py:637-648, 697-708): the pvs
    alone when ``max_seq_len`` is None, the title alone when
    ``max_seq_len_pv`` is None, else ``title [SEP] jieba(pvs)``.  Returns
    (text, max_length)."""
    if max_seq_len is None:
        return pvs, max_seq_len_pv
    if max_seq_len_pv is None:
        return title, max_seq_len
    return (build_item_text(title, pvs, tok.sep_token),
            max_seq_len + max_seq_len_pv)


def encode_image_one_tower(tok, src_text: str, tgt_text: str, max_length: int,
                           ensemble: str = "begin") -> Dict[str, list]:
    """The RobertaImage one-tower layout (data.py:650-677).  With
    ``ensemble == "begin"``: ``[CLS] [IMG] [SEP] src [SEP] [IMG] [SEP] tgt
    [SEP]`` and the position of the second id 99 as ``image_indices`` (1
    when there is none); otherwise the plain pair and ``image_indices`` 0."""
    if ensemble == "begin":
        src_text = " ".join((IMG_TOKEN, tok.sep_token, src_text))
        tgt_text = " ".join((IMG_TOKEN, tok.sep_token, tgt_text))
    enc = tok(text=src_text, text_pair=tgt_text, max_length=2 * max_length,
              padding="max_length", truncation="longest_first")
    ids = enc["input_ids"]
    image_index = 0
    if ensemble == "begin":
        img_positions = [i for i, t in enumerate(ids) if t == IMG_TOKEN_ID]
        image_index = img_positions[1] if len(img_positions) > 1 else 1
    return {"input_ids": ids, "token_type_ids": enc["token_type_ids"],
            "attention_mask": enc["attention_mask"],
            "image_indices": image_index}


def rows_to_image_one_tower_dataset(
    rows: Sequence, tok, max_seq_len: Optional[int],
    max_seq_len_pv: Optional[int], image_hidden_size: int = 3072,
    ensemble: str = "begin",
) -> ArrayDataset:
    """9-column TSV rows (label, src_id, src_title, src_pvs, src_img_emb,
    tgt_id, tgt_title, tgt_pvs, tgt_img_emb) -> RobertaImage one-tower
    arrays: int32 ids, token types, masks, ``image_indices`` and labels,
    fp32 ``src_image_embeds``/``tgt_image_embeds`` (data.py:623-680)."""
    feats: Dict[str, list] = {"input_ids": [], "token_type_ids": [],
                              "attention_mask": [], "image_indices": [],
                              "labels": []}
    img_feats = {"src_image_embeds": [], "tgt_image_embeds": []}
    meta = {"src_item_id": [], "tgt_item_id": []}
    for row in rows:
        (label, src_item_id, src_title, src_pvs, src_emb,
         tgt_item_id, tgt_title, tgt_pvs, tgt_emb) = row
        src_text, max_length = _image_item_text(
            src_title, src_pvs, max_seq_len, max_seq_len_pv, tok)
        tgt_text, _ = _image_item_text(
            tgt_title, tgt_pvs, max_seq_len, max_seq_len_pv, tok)
        enc = encode_image_one_tower(tok, src_text, tgt_text, max_length,
                                     ensemble)
        for k in ("input_ids", "token_type_ids", "attention_mask",
                  "image_indices"):
            feats[k].append(enc[k])
        feats["labels"].append(int(label))
        img_feats["src_image_embeds"].append(
            _parse_embedding_column(src_emb, image_hidden_size))
        img_feats["tgt_image_embeds"].append(
            _parse_embedding_column(tgt_emb, image_hidden_size))
        meta["src_item_id"].append(src_item_id)
        meta["tgt_item_id"].append(tgt_item_id)
    arrays = {k: np.asarray(v, np.int32) for k, v in feats.items()}
    arrays.update({k: np.stack(v) for k, v in img_feats.items()})
    return ArrayDataset(arrays, meta)


def rows_to_image_two_tower_dataset(
    rows: Sequence, tok, max_seq_len: Optional[int],
    max_seq_len_pv: Optional[int], image_hidden_size: int = 3072,
    ensemble: str = "begin",
) -> ArrayDataset:
    """9-column TSV rows -> RobertaImage two-tower arrays, each item
    encoded on its own (data.py:682-753): with ``ensemble == "begin"`` as
    ``[CLS] [IMG] [SEP] title [SEP] pvs``, the image token at position 1
    where the splice puts the image, plain text otherwise."""
    feats: Dict[str, list] = {f"{k}_{i}": [] for k in
                              ("input_ids", "attention_mask",
                               "token_type_ids")
                              for i in (1, 2)}
    feats["labels"] = []
    img_feats = {"image_embeds_1": [], "image_embeds_2": []}
    meta = {"src_item_id": [], "tgt_item_id": []}
    for row in rows:
        (label, src_item_id, src_title, src_pvs, src_emb,
         tgt_item_id, tgt_title, tgt_pvs, tgt_emb) = row
        for i, (title, pvs, emb) in enumerate(
                ((src_title, src_pvs, src_emb),
                 (tgt_title, tgt_pvs, tgt_emb)), start=1):
            text, max_length = _image_item_text(
                title, pvs, max_seq_len, max_seq_len_pv, tok)
            if ensemble == "begin":
                text = " ".join((IMG_TOKEN, tok.sep_token, text))
            enc = encode_two_tower_item(tok, text, max_length)
            feats[f"input_ids_{i}"].append(enc["input_ids"])
            feats[f"attention_mask_{i}"].append(enc["attention_mask"])
            feats[f"token_type_ids_{i}"].append(enc["token_type_ids"])
            img_feats[f"image_embeds_{i}"].append(
                _parse_embedding_column(emb, image_hidden_size))
        feats["labels"].append(int(label))
        meta["src_item_id"].append(src_item_id)
        meta["tgt_item_id"].append(tgt_item_id)
    arrays = {k: np.asarray(v, np.int32) for k, v in feats.items()}
    arrays.update({k: np.stack(v) for k, v in img_feats.items()})
    return ArrayDataset(arrays, meta)


def rows_to_pv_pair_dataset(rows: Sequence, tok, max_seq_len: int,
                            max_seq_len_pv: int) -> ArrayDataset:
    """The pv-pair text layout (RobertaOneTowerPvPairDataset,
    data.py:756-783; not on the reference's final pipeline): rows
    ``(label, src_id, src_title, tgt_id, tgt_title, pv_pair_text)``, the
    pair ``src_title`` / ``tgt_title [SEP] jieba(pv_pair_text)`` padded to
    ``2 * max_seq_len + max_seq_len_pv``, token types + 1 after the second
    [SEP]."""
    feats: Dict[str, list] = {"input_ids": [], "token_type_ids": [],
                              "attention_mask": [], "labels": []}
    meta = {"src_item_id": [], "tgt_item_id": []}
    max_length = 2 * max_seq_len + max_seq_len_pv
    for (label, src_item_id, src_title, tgt_item_id, tgt_title,
         pv_pair_text) in rows:
        tgt_text = " ".join((tgt_title, tok.sep_token,
                             segment_pvs(pv_pair_text)))
        enc = tok(text=src_title, text_pair=tgt_text, max_length=max_length,
                  padding="max_length", truncation="longest_first")
        ids = enc["input_ids"]
        i1 = ids.index(tok.sep_token_id)
        i2 = ids.index(tok.sep_token_id, i1 + 1)
        tt = enc["token_type_ids"]
        feats["input_ids"].append(ids)
        feats["token_type_ids"].append(tt[:i2 + 1] + [t + 1 for t in tt[i2 + 1:]])
        feats["attention_mask"].append(enc["attention_mask"])
        feats["labels"].append(int(label))
        meta["src_item_id"].append(src_item_id)
        meta["tgt_item_id"].append(tgt_item_id)
    arrays = {k: np.asarray(v, np.int32) for k, v in feats.items()}
    return ArrayDataset(arrays, meta)


def build_multimodal_pretrain_dataset(
    items: Sequence[Dict], tok, image_loader, max_seq_len: int,
    image_size: int, bos: bool = False,
) -> ArrayDataset:
    """CoCa pretraining examples (MultimodalDataset, data.py:872-930): each
    item's ``title [SEP] jieba(pvs)`` (with a ``[BOS]`` first when ``bos``)
    padded to ``max_seq_len``, and its image through the eval transform as
    post-transform uint8 ``[S, S, 3]``.  ``items`` are dicts with ``title``,
    ``pvs``, ``image_path`` and ``item_id``; ``image_loader(path)`` gives
    HWC uint8 or None, and an item whose image does not load is dropped."""
    from item_alignment_torch.data.images import eval_transform

    feats: Dict[str, list] = {"input_ids": [], "attention_mask": [],
                              "token_type_ids": [], "images": []}
    meta = {"item_id": []}
    for item in items:
        img = image_loader(item["image_path"])
        if img is None:
            continue
        text = build_item_text(item.get("title", ""), item.get("pvs", ""),
                               tok.sep_token)
        if bos:
            text = f"{tok.bos_token} {text}"
        enc = tok(text=text, max_length=max_seq_len, padding="max_length",
                  truncation="longest_first")
        for k in ("input_ids", "attention_mask", "token_type_ids"):
            feats[k].append(enc[k])
        feats["images"].append(eval_transform(img, image_size,
                                              normalized=False))
        meta["item_id"].append(item.get("item_id", ""))
    arrays = {k: np.asarray(v, np.int32) for k, v in feats.items()
              if k != "images"}
    arrays["images"] = np.stack(feats["images"]) if feats["images"] else \
        np.zeros((0, image_size, image_size, 3), np.uint8)
    return ArrayDataset(arrays, meta)


def build_multimodal_pair_dataset(
    rows: Sequence, tok, image_loader, image_paths: Dict[str, str],
    max_seq_len: Optional[int], max_seq_len_pv: Optional[int],
    image_size: int, bos: bool = False,
) -> ArrayDataset:
    """CoCa finetune pairs (data.py:933-989): each item's text (``title
    [SEP] pvs``, with a ``[BOS]`` first when ``bos``) padded to
    ``max_seq_len + max_seq_len_pv``, and its image through the eval
    transform, kept as post-transform uint8 ``[S, S, 3]`` (the ViT
    normalises on the device).  ``rows`` are the 9-tuples of
    ``read_finetune_tsv``; ``image_paths`` maps an item id to its file.
    A pair whose image does not load is dropped."""
    from item_alignment_torch.data.images import eval_transform

    feats: Dict[str, list] = {f"{k}_{i}": [] for k in
                              ("input_ids", "attention_mask")
                              for i in (1, 2)}
    feats.update(images_1=[], images_2=[], labels=[])
    meta = {"src_item_id": [], "tgt_item_id": []}
    max_length = (max_seq_len or 0) + (max_seq_len_pv or 0)
    for row in rows:
        (label, sid, _, s_title, s_pvs, tid, _, t_title, t_pvs) = row
        img1 = image_loader(image_paths.get(sid, ""))
        img2 = image_loader(image_paths.get(tid, ""))
        if img1 is None or img2 is None:
            continue
        for i, (title, pvs) in enumerate(((s_title, s_pvs),
                                          (t_title, t_pvs)), start=1):
            text = build_item_text(title, pvs, tok.sep_token)
            if bos:
                text = f"{tok.bos_token} {text}"
            enc = tok(text=text, max_length=max_length,
                      padding="max_length", truncation="longest_first")
            feats[f"input_ids_{i}"].append(enc["input_ids"])
            feats[f"attention_mask_{i}"].append(enc["attention_mask"])
        for i, img in ((1, img1), (2, img2)):
            feats[f"images_{i}"].append(eval_transform(img, image_size,
                                                      normalized=False))
        feats["labels"].append(int(label))
        meta["src_item_id"].append(sid)
        meta["tgt_item_id"].append(tid)
    arrays = {k: np.asarray(v, np.int32) for k, v in feats.items()
              if not k.startswith("images")}
    for k in ("images_1", "images_2"):
        arrays[k] = np.stack(feats[k]) if feats[k] else \
            np.zeros((0, image_size, image_size, 3), np.uint8)
    return ArrayDataset(arrays, meta)


# ------------------------------------------------------------------ PKGM
def _pad_text_sequence(ids: List[int], token_type_id: int, max_len: int):
    mask = [1] * len(ids)
    tt = [token_type_id] * len(ids)
    ids = ids + [0] * (max_len - len(ids))
    mask = mask + [0] * (max_len - len(mask))
    tt = tt + [0] * (max_len - len(tt))
    return ids, mask, tt


def _pad_kg_sequence(ids: List[int], token_type_id: int, max_pvs: int):
    """ids = [entity, rel...]; masks/token-types cover the 2*max_pvs embedded
    kg tokens (data.py:378-388: each relation becomes 2 query tokens)."""
    n_rel = max(len(ids) - 1, 0)
    mask = [1] * (n_rel * 2)
    tt = [token_type_id] * (n_rel * 2)
    ids = ids + [0] * (max_pvs + 1 - len(ids))
    mask = mask + [0] * (2 * max_pvs - len(mask))
    tt = tt + [0] * (2 * max_pvs - len(tt))
    return ids, mask, tt


def encode_pkgm_item(tok, kg_ent: Dict[str, int], kg_rel: Dict[str, int],
                     item_id: str, title: str, pvs: str, max_seq_len: int,
                     max_pvs: int, token_type_id: int = 0,
                     leading_token: Optional[str] = None,
                     kg_token_type_id: Optional[int] = None):
    """One PKGM item: text ids (max_seq_len) + kg ids (1+max_pvs) in the id
    space; mask and token types in the embedded space (max_seq_len +
    2*max_pvs).  An item with no known relation has an all-zero kg block,
    masked.  One-tower uses one token type for both parts (0 src / 1 tgt,
    data.py:328-341); two-tower uses text 0 / kg 1 (data.py:430-445) via
    ``kg_token_type_id``."""
    if kg_token_type_id is None:
        kg_token_type_id = token_type_id
    title_ids = tok.convert_tokens_to_ids(tok.tokenize(title))[: max_seq_len - 2]
    lead = tok.cls_token_id if leading_token is None else \
        tok.convert_tokens_to_ids(leading_token)
    text_ids, text_mask, text_tt = _pad_text_sequence(
        [lead] + title_ids + [tok.sep_token_id], token_type_id, max_seq_len)

    rel_ids = []
    for pv in pvs.split(";"):
        try:
            r, _ = pv.split(":", maxsplit=1)
        except ValueError:
            continue
        if r in kg_rel:
            rel_ids.append(kg_rel[r])
    kg_ids = []
    if rel_ids:
        kg_ids = [kg_ent.get(f"/item/{item_id}", 0)] + rel_ids
    kg_ids, kg_mask, kg_tt = _pad_kg_sequence(kg_ids[: 1 + max_pvs],
                                              kg_token_type_id, max_pvs)
    return text_ids + kg_ids, text_mask + kg_mask, text_tt + kg_tt


def encode_pkgm_one_tower(tok, kg_ent, kg_rel, row, max_seq_len: int,
                          max_pvs: int, classification_method: str = "cls"):
    """(data.py:277-392): src block then tgt block; tgt leading token is
    [BOS] for vec_sim else [SEP]."""
    (label, src_item_id, _, src_title, src_pvs,
     tgt_item_id, _, tgt_title, tgt_pvs) = row
    src_ids, src_mask, src_tt = encode_pkgm_item(
        tok, kg_ent, kg_rel, src_item_id, src_title, src_pvs,
        max_seq_len, max_pvs, token_type_id=0)
    lead = BOS_TOKEN if classification_method == "vec_sim" else tok.sep_token
    tgt_ids, tgt_mask, tgt_tt = encode_pkgm_item(
        tok, kg_ent, kg_rel, tgt_item_id, tgt_title, tgt_pvs,
        max_seq_len, max_pvs, token_type_id=1, leading_token=lead)
    return {
        "input_ids": src_ids + tgt_ids,
        "attention_mask": src_mask + tgt_mask,
        "token_type_ids": src_tt + tgt_tt,
        "position_ids": list(range(2 * (max_seq_len + 2 * max_pvs))),
        "labels": int(label),
    }


def rows_to_pkgm_dataset(rows, tok, kg_ent, kg_rel, max_seq_len: int,
                         max_pvs: int, classification_method: str = "cls"
                         ) -> ArrayDataset:
    """One-tower PKGM arrays: ``input_ids`` [n, 2*(L+1+P)] and
    ``attention_mask``/``token_type_ids``/``position_ids`` [n, 2*(L+2P)]."""
    feats = {"input_ids": [], "attention_mask": [], "token_type_ids": [],
             "position_ids": [], "labels": []}
    meta = {"src_item_id": [], "tgt_item_id": []}
    for row in rows:
        enc = encode_pkgm_one_tower(tok, kg_ent, kg_rel, row, max_seq_len,
                                    max_pvs, classification_method)
        for k in feats:
            feats[k].append(enc[k])
        meta["src_item_id"].append(row[1])
        meta["tgt_item_id"].append(row[5])
    arrays = {k: np.asarray(v, dtype=np.int32) for k, v in feats.items()}
    return ArrayDataset(arrays, meta)


def rows_to_pkgm_two_tower_dataset(rows, tok, kg_ent, kg_rel,
                                   max_seq_len: int, max_pvs: int
                                   ) -> ArrayDataset:
    """Per-item PKGM layouts for the two-tower model (PKGMTwoTowerDataset,
    data.py:394-516): each side gets its own id-space ids and
    embedded-space masks; one position row serves both."""
    feats = {f"{k}_{i}": [] for k in ("input_ids", "attention_mask",
                                      "token_type_ids") for i in (1, 2)}
    feats["labels"] = []
    meta = {"src_item_id": [], "tgt_item_id": []}
    for row in rows:
        (label, src_item_id, _, src_title, src_pvs,
         tgt_item_id, _, tgt_title, tgt_pvs) = row
        for i, (iid, title, pvs) in enumerate(
                ((src_item_id, src_title, src_pvs),
                 (tgt_item_id, tgt_title, tgt_pvs)), start=1):
            ids, mask, ttids = encode_pkgm_item(
                tok, kg_ent, kg_rel, iid, title, pvs, max_seq_len, max_pvs,
                token_type_id=0, kg_token_type_id=1)
            feats[f"input_ids_{i}"].append(ids)
            feats[f"attention_mask_{i}"].append(mask)
            feats[f"token_type_ids_{i}"].append(ttids)
        feats["labels"].append(int(label))
        meta["src_item_id"].append(src_item_id)
        meta["tgt_item_id"].append(tgt_item_id)
    arrays = {k: np.asarray(v, np.int32) for k, v in feats.items()}
    embed_len = max_seq_len + 2 * max_pvs
    arrays["position_ids"] = np.tile(np.arange(embed_len, dtype=np.int32),
                                     (len(rows), 1))
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
