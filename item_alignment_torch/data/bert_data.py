"""Data preparation for the legacy 5-field BERT pipeline.

Port of ``item_alignment_tpu/data/bert_data.py`` (the reference's
``src/bert/data_utils.py`` and the structure-aware pretraining masking of
``bert_pretrain.py``), on the port's WordPiece tokenizer
(``data/wordpiece.py``).  Python's ``random.Random`` drives the masking, so
a seed gives the JAX package's examples exactly:

- ``encode_field_pairs``: per-field (src, tgt) sentence-pair tokenization
  with field-specific max lens (data_utils.py:92-94), optional pv shuffle
- the pretraining examples: whole-field masks for industry/cate
  (``do_whole_mask``, bert_pretrain.py:288-300), title-span masks where the
  title string-matches a pv value (``process_title_match_pvs`` /
  ``do_title_mask``, 267-349), per-pv key/value masking (``do_pvs_mask``,
  213-263), negative "next" examples by random last-field replacement
  (``get_next_examples``, 132-157).

MLM label convention: -1 = not predicted.  The field arrays are ``int32``,
flattened as ``<field>_<key>``; ``unflatten_fields`` nests them again, and
``align_kwargs`` makes a batch ``BertAlignModel``'s keyword arguments (the
``batch_transform`` of its ``Trainer``).

Position ids are RoBERTa's, ``cumsum(ids != pad) * (ids != pad) + pad``, so
a row of ``n`` real tokens reads position ``n + pad_token_id``.  The pvs
field is padded to 512 and ``configs/roberta_base.json`` has 512
positions: a padded width of 512 is fine, a row whose 512 tokens are all
real is not.  JAX reads past the table there and gets NaN.  The port
checks the real lengths where the arrays are built: given the model's
config, ``pairs_to_field_dataset`` and ``pretrain_dataset`` raise a
``ValueError`` that names the row (``check_position_ids``), before any
device work.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.data.datasets import ArrayDataset
from item_alignment_torch.models.bert_legacy import FIELD_MAX_LENS, FIELD_NAMES


def shuffle_pvs(pvs: str, seed: Optional[int] = None) -> str:
    parts = [p for p in pvs.split(";") if p]
    rng = random.Random(seed)
    rng.shuffle(parts)
    return ";".join(parts)


def encode_field_pairs(tok, src: Dict[str, str], tgt: Dict[str, str],
                       max_lens: Dict[str, int] = FIELD_MAX_LENS
                       ) -> Dict[str, Dict[str, List[int]]]:
    """Each field independently encoded as a (src, tgt) sentence pair."""
    out = {}
    for field in FIELD_NAMES:
        enc = tok(src.get(field, ""), tgt.get(field, ""),
                  padding="max_length", truncation=True,
                  max_length=max_lens[field])
        out[field] = {"input_ids": enc["input_ids"],
                      "attention_mask": enc["attention_mask"],
                      "token_type_ids": enc["token_type_ids"]}
    return out


def check_position_ids(arrays: Dict[str, np.ndarray], config: ModelConfig
                       ) -> None:
    """Raise a ``ValueError`` naming the first row of an ``*input_ids``
    array (``[B, S]``) whose last position id would lie past the position
    table: ``count(ids != pad) + pad_token_id >= max_position_embeddings``."""
    pad, table = config.pad_token_id, config.max_position_embeddings
    for key, ids in arrays.items():
        if not key.endswith("input_ids"):
            continue
        lens = (np.asarray(ids) != pad).sum(axis=1)
        bad = np.nonzero(lens + pad >= table)[0]
        if len(bad):
            row, n = int(bad[0]), int(lens[bad[0]])
            raise ValueError(
                f"row {row} of {key} holds {n} tokens and needs position "
                f"ids up to {n + pad} (tokens + pad_token_id), but the "
                f"position table has max_position_embeddings={table} rows; "
                f"shorten the row or grow the table")


def pairs_to_field_dataset(rows: Sequence[Dict], tok,
                           max_lens: Dict[str, int] = FIELD_MAX_LENS,
                           config: Optional[ModelConfig] = None):
    """rows: dicts with src_/tgt_ prefixed fields + item_label ->
    ArrayDataset with nested field arrays flattened as ``<field>_<key>``.
    Given the model's ``config``, a row past its position table raises
    (``check_position_ids``)."""
    feats: Dict[str, list] = {}
    labels = []
    for row in rows:
        src = {f: row.get(f"src_{f}", "") for f in FIELD_NAMES}
        tgt = {f: row.get(f"tgt_{f}", "") for f in FIELD_NAMES}
        enc = encode_field_pairs(tok, src, tgt, max_lens)
        for field, d in enc.items():
            for key, val in d.items():
                feats.setdefault(f"{field}_{key}", []).append(val)
        labels.append(int(row["item_label"]))
    arrays = {k: np.asarray(v, np.int32) for k, v in feats.items()}
    arrays["labels"] = np.asarray(labels, np.int32)
    if config is not None:
        check_position_ids(arrays, config)
    return ArrayDataset(arrays)


def unflatten_fields(batch: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    """<field>_<key> arrays -> nested {field: {key: array}} for
    BertAlignModel."""
    fields: Dict[str, Dict] = {f: {} for f in FIELD_NAMES}
    for k, v in batch.items():
        for f in FIELD_NAMES:
            for key in ("input_ids", "attention_mask", "token_type_ids"):
                if k == f"{f}_{key}":
                    fields[f][key] = v
    return fields


def align_kwargs(batch: Dict) -> Dict:
    """A batch of ``<field>_<key>`` arrays (and optionally ``labels``) ->
    ``BertAlignModel``'s keyword arguments ``fields`` (and ``labels``)."""
    batch = dict(batch)
    labels = batch.pop("labels", None)
    out = {"fields": unflatten_fields(batch)}
    if labels is not None:
        out["labels"] = labels
    return out


# ------------------------------------------------- structure-aware masking
def whole_field_mask(input_ids: List[int], mask_id: int, vocab_size: int,
                     rng: random.Random) -> Tuple[List[int], List[int]]:
    """80% keep / 10% random / 10% all-[MASK]; labels = originals
    (do_whole_mask)."""
    u = rng.random()
    labels = list(input_ids)
    if u < 0.8:
        return list(input_ids), labels
    if u < 0.9:
        return [rng.randrange(vocab_size) for _ in input_ids], labels
    return [mask_id] * len(input_ids), labels


def split_pv_tokens(pv_tokens: List[str]) -> List[Tuple[List[str], List[str]]]:
    """pv token stream -> [(key_tokens, value_tokens)]
    (process_title_match_pvs / process_single_property)."""
    chunks, start = [], 0
    for i, t in enumerate(pv_tokens):
        if t == ";" or i == len(pv_tokens) - 1:
            chunks.append(pv_tokens[start:i + 1])
            start = i + 1
    props = []
    for c in chunks:
        if not c or ":" not in c:
            continue
        sep = c.index(":")
        key = c[:sep]
        val = c[sep + 1:]
        if val and val[-1] == ";":
            val = val[:-1]
        if key and val:
            props.append((key, val))
    return props


def title_value_match_spans(title_tokens: List[str],
                            props: Sequence[Tuple[List[str], List[str]]]
                            ) -> List[Tuple[int, int]]:
    """Spans of the title that exactly match some pv value (do_match_terms)."""
    spans = []
    for _, val in props:
        v = "".join(val)
        L = len(val)
        for i in range(len(title_tokens) - L + 1):
            if "".join(title_tokens[i:i + L]) == v:
                spans.append((i, i + L))
    return spans


def title_mask(input_ids: List[int], spans: Sequence[Tuple[int, int]],
               mask_id: int, vocab_size: int, rng: random.Random
               ) -> Tuple[List[int], List[int]]:
    """Mask pv-matching title spans (50% random / 50% [MASK]); with no
    spans, fall back to 15% random token labeling (do_title_mask)."""
    ids = list(input_ids)
    labels = [-1] * len(ids)
    if not spans:
        for i in range(len(ids)):
            if rng.random() < 0.15:
                labels[i] = ids[i]
        return ids, labels
    use_random = rng.random() < 0.5
    for s, e in spans:
        for i in range(s, e):
            labels[i] = ids[i]
            ids[i] = rng.randrange(vocab_size) if use_random else mask_id
    return ids, labels


def pv_mask_examples(props: Sequence[Tuple[List[str], List[str]]], tok,
                     rng: random.Random) -> List[Dict]:
    """One example per pv key/value span: 80% keep / 10% random / 10% [MASK],
    labels on the span either way (do_pvs_mask)."""
    tokens: List[str] = []
    key_spans, value_spans = [], []
    for key, val in props:
        key_spans.append((len(tokens), len(tokens) + len(key)))
        tokens.extend(list(key) + [":"])
        value_spans.append((len(tokens), len(tokens) + len(val)))
        tokens.extend(list(val) + [";"])
    spans = value_spans + key_spans
    rng.shuffle(spans)
    input_ids = tok.convert_tokens_to_ids(tokens)
    mask_id = tok.convert_tokens_to_ids("[MASK]")
    out = []
    for s, e in spans:
        ids = list(input_ids)
        labels = [-1] * len(tokens)
        u = rng.random()
        if u < 0.8:
            pass
        elif u < 0.9:
            for p in range(s, e):
                ids[p] = rng.randrange(len(tok))
        else:
            for p in range(s, e):
                ids[p] = mask_id
        for p in range(s, e):
            labels[p] = input_ids[p]
        out.append({"input_ids": ids, "label_ids": labels,
                    "token_type_ids": [4] * len(ids),
                    "attention_mask": [1] * len(ids)})
    return out


def assemble_pretrain_example(field_examples: Sequence[Dict], max_seq_len: int,
                              tok, next_label: int = 1) -> Dict[str, List[int]]:
    """[CLS] f0 f1 ... [SEP], truncated/padded to max_seq_len+2, per-field
    token types 0..4 (create_input_features semantics)."""
    input_ids = [tok.cls_token_id]
    token_type_ids = [0]
    label_ids = [-1]
    for ex in field_examples:
        input_ids.extend(ex["input_ids"])
        token_type_ids.extend(ex["token_type_ids"])
        label_ids.extend(ex["label_ids"])
    input_ids = input_ids[:max_seq_len + 1] + [tok.sep_token_id]
    token_type_ids = token_type_ids[:max_seq_len + 1] + [token_type_ids[-1]]
    label_ids = label_ids[:max_seq_len + 1] + [-1]
    attention_mask = [1] * len(input_ids)
    pad = max_seq_len + 2 - len(input_ids)
    input_ids += [tok.pad_token_id] * pad
    token_type_ids += [0] * pad
    label_ids += [-1] * pad
    attention_mask += [0] * pad
    return {"input_ids": input_ids, "token_type_ids": token_type_ids,
            "attention_mask": attention_mask, "label_ids": label_ids,
            "next_label": next_label}


def build_pretrain_examples(item: Dict[str, str], tok, max_seq_len: int,
                            all_items: Sequence[Dict[str, str]],
                            rng: Optional[random.Random] = None,
                            n_negatives: int = 1) -> List[Dict]:
    """Full structure-aware example set for one item: industry whole-mask,
    cate whole-mask, title-span mask, per-pv masks, plus negative 'next'
    examples with a random other item's pvs (get_masked_examples +
    get_next_examples)."""
    rng = rng or random.Random(0)
    fields = ["industry_name", "cate_name", "cate_name_path", "title",
              "item_pvs"]
    seqs = [str(item.get(f, "")).replace("#", "") for f in fields]
    tokenized = []
    for idx, seq in enumerate(seqs):
        toks = tok.tokenize(seq)
        tokenized.append({"org_tokens": toks,
                          "input_ids": tok.convert_tokens_to_ids(toks),
                          "token_type_ids": [idx] * len(toks),
                          "attention_mask": [1] * len(toks),
                          "label_ids": [-1] * len(toks)})
    mask_id = tok.convert_tokens_to_ids("[MASK]")
    props = split_pv_tokens(tokenized[4]["org_tokens"])
    spans = title_value_match_spans(tokenized[3]["org_tokens"], props)

    examples = []
    for field_idx in (0, 1):  # industry / cate whole-field masks
        exs = [dict(e) for e in tokenized]
        ids, labels = whole_field_mask(exs[field_idx]["input_ids"], mask_id,
                                       len(tok), rng)
        exs[field_idx] = {**exs[field_idx], "input_ids": ids,
                          "label_ids": labels}
        examples.append(assemble_pretrain_example(exs, max_seq_len, tok))
    # title-span mask
    exs = [dict(e) for e in tokenized]
    ids, labels = title_mask(exs[3]["input_ids"], spans, mask_id, len(tok), rng)
    exs[3] = {**exs[3], "input_ids": ids, "label_ids": labels}
    examples.append(assemble_pretrain_example(exs, max_seq_len, tok))
    # per-pv masks
    for pv_ex in pv_mask_examples(props, tok, rng):
        exs = [dict(e) for e in tokenized]
        exs[4] = pv_ex
        examples.append(assemble_pretrain_example(exs, max_seq_len, tok))
    # negative next examples: replace the pv field with another item's
    for _ in range(n_negatives):
        other = all_items[rng.randrange(len(all_items))]
        other_pvs = str(other.get("item_pvs", "")).replace("#", "")
        toks = tok.tokenize(other_pvs)
        exs = [dict(e) for e in tokenized]
        exs[4] = {"org_tokens": toks,
                  "input_ids": tok.convert_tokens_to_ids(toks),
                  "token_type_ids": [4] * len(toks),
                  "attention_mask": [1] * len(toks),
                  "label_ids": [-1] * len(toks)}
        examples.append(assemble_pretrain_example(exs, max_seq_len, tok,
                                                  next_label=0))
    return examples


def pretrain_dataset(examples: Sequence[Dict],
                     config: Optional[ModelConfig] = None) -> ArrayDataset:
    """``build_pretrain_examples``' examples -> the ``BertForPretraining``
    arrays (``input_ids``, ``attention_mask``, ``token_type_ids``,
    ``mlm_labels``, ``next_label``), ``int32``.  Given the model's
    ``config``, a row past its position table raises
    (``check_position_ids``)."""
    keys = {"input_ids": "input_ids", "attention_mask": "attention_mask",
            "token_type_ids": "token_type_ids", "mlm_labels": "label_ids",
            "next_label": "next_label"}
    arrays = {k: np.asarray([e[v] for e in examples], np.int32)
              for k, v in keys.items()}
    if config is not None:
        check_position_ids(arrays, config)
    return ArrayDataset(arrays)
