"""The port's WordPiece tokenizer.

It reads a BERT ``vocab.txt`` and gives the ids that the JAX package's
tokenizer gives: ``transformers.BertTokenizer`` with basic tokenization
turned off (``do_basic_tokenize=False``) and ``"<S>"`` added as the bos
token (``item_alignment_tpu/data/tokenization.py:load_text_tokenizer``).
For every call the main path makes, that is:

1. The special tokens ([UNK] [SEP] [PAD] [CLS] [MASK] and the bos token) are
   split out first, leftmost first.  Tokens of the vocab such as
   ``[unused99]`` are not special and go through WordPiece.
2. The rest is lower-cased one character at a time (a character's own
   ``str.lower``, as transformers' regex does it, so a final sigma stays
   ``σ``) and split on whitespace.
3. Each word is matched greedily, longest piece first, later pieces with a
   ``##`` prefix.  A word longer than 100 characters, or one with any piece
   that the vocab lacks, becomes one ``[UNK]``.
4. ``[CLS] a [SEP]`` or ``[CLS] a [SEP] b [SEP]``, with token types 0 for
   the first part and 1 for the second.  ``truncation`` ``True`` or
   ``"longest_first"`` cuts tokens off the longer side (transformers'
   closed form); a single sequence too short to lose the tokens asked of it
   is left whole, as transformers leaves it.  ``padding="max_length"`` pads
   on the right with [PAD], type 0 and mask 0.

A special token missing from the vocab takes the next free id, in
transformers' order ([UNK] [SEP] [PAD] [CLS] [MASK], then the bos token),
and ``len(tok)`` counts it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Union

from item_alignment_torch.utils import BOS_TOKEN

MAX_INPUT_CHARS_PER_WORD = 100


def load_vocab(path: str) -> Dict[str, int]:
    """``vocab.txt`` -> {token: line number}; a repeated token keeps its
    last line, as transformers' ``load_vocab`` does."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return vocab


class WordPieceTokenizer:
    def __init__(self, vocab_file: str, bos_token: str = BOS_TOKEN,
                 unk_token: str = "[UNK]", sep_token: str = "[SEP]",
                 pad_token: str = "[PAD]", cls_token: str = "[CLS]",
                 mask_token: str = "[MASK]"):
        self.vocab = load_vocab(vocab_file)
        self.unk_token, self.sep_token, self.pad_token = (unk_token,
                                                          sep_token, pad_token)
        self.cls_token, self.mask_token, self.bos_token = (cls_token,
                                                           mask_token,
                                                           bos_token)
        self.special: Dict[str, int] = {}
        for tok in (unk_token, sep_token, pad_token, cls_token, mask_token,
                    bos_token):
            self.special[tok] = self.vocab.get(tok, len(self))
        # longest first, so that a special token is never cut short by
        # another that begins it
        self._special_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.special, key=len,
                                         reverse=True)))

    def __len__(self) -> int:
        return len(set(self.vocab) | set(self.special))

    @property
    def unk_token_id(self) -> int:
        return self.special[self.unk_token]

    @property
    def sep_token_id(self) -> int:
        return self.special[self.sep_token]

    @property
    def pad_token_id(self) -> int:
        return self.special[self.pad_token]

    @property
    def cls_token_id(self) -> int:
        return self.special[self.cls_token]

    @property
    def bos_token_id(self) -> int:
        return self.special[self.bos_token]

    # -------------------------------------------------------- tokenizing
    def _wordpiece(self, text: str) -> List[str]:
        out: List[str] = []
        for word in text.split():
            if len(word) > MAX_INPUT_CHARS_PER_WORD:
                out.append(self.unk_token)
                continue
            pieces, start = [], 0
            while start < len(word):
                end = len(word)
                while end > start:
                    piece = word[start:end] if start == 0 else \
                        "##" + word[start:end]
                    if piece in self.vocab:
                        break
                    end -= 1
                if end == start:  # no piece of the vocab starts here
                    pieces = [self.unk_token]
                    break
                pieces.append(piece)
                start = end
            out.extend(pieces)
        return out

    def tokenize(self, text: str) -> List[str]:
        tokens: List[str] = []
        pos = 0
        for m in self._special_re.finditer(text):
            chunk = "".join(c.lower() for c in text[pos:m.start()])
            tokens.extend(self._wordpiece(chunk))
            tokens.append(m.group())
            pos = m.end()
        tokens.extend(self._wordpiece("".join(c.lower() for c in text[pos:])))
        return tokens

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self._token_id(tokens)
        return [self._token_id(t) for t in tokens]

    def _token_id(self, token: str) -> int:
        if token in self.special:
            return self.special[token]
        return self.vocab.get(token, self.unk_token_id)

    # ---------------------------------------------------------- encoding
    def encode_one(self, text: str, text_pair: Optional[str] = None,
                   max_length: Optional[int] = None, padding=False,
                   truncation=False) -> Dict[str, List[int]]:
        if padding not in (False, None, "do_not_pad", "max_length"):
            raise ValueError(f"unsupported padding {padding!r}")
        if truncation not in (False, None, True, "longest_first",
                              "do_not_truncate"):
            raise ValueError(f"unsupported truncation {truncation!r}")
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        pair = None if text_pair is None else \
            self.convert_tokens_to_ids(self.tokenize(text_pair))
        n_special = 2 if pair is None else 3
        total = len(ids) + len(pair or ()) + n_special
        if truncation in (True, "longest_first") and max_length \
                and total > max_length:
            ids, pair = _truncate_longest_first(ids, pair, total - max_length)
        cls, sep = [self.cls_token_id], [self.sep_token_id]
        input_ids = cls + ids + sep
        token_type_ids = [0] * len(input_ids)
        if pair is not None:
            input_ids += pair + sep
            token_type_ids += [1] * (len(pair) + 1)
        attention_mask = [1] * len(input_ids)
        if padding == "max_length" and max_length \
                and len(input_ids) < max_length:
            pad = max_length - len(input_ids)
            input_ids += [self.pad_token_id] * pad
            token_type_ids += [0] * pad
            attention_mask += [0] * pad
        return {"input_ids": input_ids, "token_type_ids": token_type_ids,
                "attention_mask": attention_mask}

    def __call__(self, text, text_pair=None, max_length: Optional[int] = None,
                 padding=False, truncation=False) -> Dict[str, list]:
        """One text (and pair) -> lists of ints; a list of texts (and of
        pairs) -> lists of such lists."""
        kw = dict(max_length=max_length, padding=padding,
                  truncation=truncation)
        if isinstance(text, str):
            return self.encode_one(text, text_pair, **kw)
        pairs = [None] * len(text) if text_pair is None else text_pair
        encs = [self.encode_one(t, p, **kw) for t, p in zip(text, pairs)]
        return {k: [e[k] for e in encs]
                for k in ("input_ids", "token_type_ids", "attention_mask")}


def _truncate_longest_first(ids: List[int], pair: Optional[List[int]],
                            remove: int):
    """transformers' ``truncate_sequences`` for ``longest_first``, cutting
    on the right."""
    if pair is None:
        # a sequence that cannot lose ``remove`` tokens is left whole
        return (ids[:-remove] if len(ids) > remove else ids), None
    first = min(abs(len(pair) - len(ids)), remove)
    second = remove - first
    if len(ids) > len(pair):
        cut_ids, cut_pair = first + second // 2, second - second // 2
    else:
        cut_ids, cut_pair = second // 2, first + second - second // 2
    if cut_ids > 0:
        ids = ids[:-cut_ids]
    if cut_pair > 0:
        pair = pair[:-cut_pair]
    return ids, pair
