"""The port's legacy-BERT data layer vs the JAX package's, on the CPU.

The JAX package tokenizes with ``transformers.BertTokenizer`` (no basic
tokenization), the port with its own WordPiece tokenizer on the same vocab.
On the same rows and the same ``random.Random`` seed, the 5-field arrays
and the structure-aware pretraining examples (ids, token types, masks, MLM
labels, ``next_label``) are equal exactly.
"""

import random

import numpy as np
import pytest

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.data import bert_data as tbd
from item_alignment_torch.data.tokenization import (
    load_text_tokenizer as t_tokenizer,
)
from item_alignment_torch.models.bert_legacy import FIELD_MAX_LENS

pytest.importorskip("transformers")
pytest.importorskip("jax")

from item_alignment_tpu.data import bert_data as jbd  # noqa: E402
from item_alignment_tpu.data.tokenization import (  # noqa: E402
    load_text_tokenizer as j_tokenizer,
)

CHARS = "颜色黑白红尺码大小中品牌华为小米容量内存手机壳苹果型号材质塑料金属"
SPECIAL = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + [
    "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
VOCAB = SPECIAL + [":", ";", "a", "b", "x"] + list(CHARS) + [
    "##" + c for c in CHARS] + ["##:", "##;", "<S>"]

ITEMS = [
    {"industry_name": "数码", "cate_name": "手机", "cate_name_path": "手机 壳",
     "title": "华为 手机 黑色 大 码", "item_pvs": "颜色 : 黑色 ; 尺码 : 大 码 ;"
                                              " 品牌 : 华为"},
    {"industry_name": "数码", "cate_name": "手机壳", "cate_name_path": "",
     "title": "苹果 手机壳 红色 塑料", "item_pvs": "材质 : 塑料 ; 颜色 : 红色"},
    {"industry_name": "#数码#", "cate_name": "内存", "title": "小米 内存 大",
     "item_pvs": "容量:大;型号:x"},
    {"industry_name": "", "cate_name": "手机", "title": "白色 金属 a",
     "item_pvs": "颜色 : 白色 ; 材质 : 金属 ; 型号 : a b ; 品牌 : 小米 ;"
                 " 容量 : 中"},
]


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert_vocab")
    (d / "vocab.txt").write_text("\n".join(VOCAB), encoding="utf-8")
    return j_tokenizer(str(d)), t_tokenizer(str(d))


def _rows():
    rows = []
    for i, (a, b) in enumerate([(0, 1), (1, 3), (2, 0), (3, 3), (1, 2)]):
        row = {"item_label": str(i % 2), "src_item_id": f"i{a}",
               "tgt_item_id": f"i{b}"}
        for side, item in (("src", ITEMS[a]), ("tgt", ITEMS[b])):
            row.update({f"{side}_pvs": item["item_pvs"],
                        f"{side}_title": item["title"],
                        f"{side}_cate": item["cate_name"],
                        f"{side}_cate_path": item.get("cate_name_path", ""),
                        f"{side}_industry_name": item["industry_name"]})
        rows.append(row)
    rows[3]["src_pvs"] = " ; ".join([rows[3]["src_pvs"]] * 20)  # truncated
    return rows


@pytest.mark.parametrize("lens", ["default", "short"])
def test_field_dataset_equals_jax(toks, lens):
    jtok, ttok = toks
    max_lens = FIELD_MAX_LENS if lens == "default" else {
        k: 12 for k in FIELD_MAX_LENS}
    ours = tbd.pairs_to_field_dataset(_rows(), ttok, max_lens)
    theirs = jbd.pairs_to_field_dataset(_rows(), jtok, max_lens)
    assert ours.arrays.keys() == theirs.arrays.keys()
    for k, v in theirs.arrays.items():
        assert ours.arrays[k].dtype == v.dtype == np.int32, k
        assert np.array_equal(ours.arrays[k], v), k
    assert ours.arrays["pvs_input_ids"].shape[1] == max_lens["pvs"]
    if lens == "default":  # the long pvs pair is cut to the field's width
        assert ours.arrays["pvs_attention_mask"][3].sum() == 512
    batch = {k: v[:2] for k, v in ours.arrays.items() if k != "labels"}
    ours_f = tbd.unflatten_fields(batch)
    theirs_f = jbd.unflatten_fields(batch)
    assert ours_f.keys() == theirs_f.keys()
    for name, f in theirs_f.items():
        assert ours_f[name].keys() == f.keys()
        for key, v in f.items():
            assert ours_f[name][key] is v


def test_pretrain_examples_equal_jax(toks):
    """Every item's whole-field, title-span, per-pv and negative examples
    from one shared ``random.Random`` stream, as ``bert-pretrain`` builds
    them."""
    jtok, ttok = toks
    items = [dict(it) for it in ITEMS]
    for max_seq_len, n_neg in ((30, 1), (8, 2)):
        r_ours, r_theirs = random.Random(7), random.Random(7)
        ours, theirs = [], []
        for item in items:
            ours += tbd.build_pretrain_examples(item, ttok, max_seq_len, items,
                                                r_ours, n_neg)
            theirs += jbd.build_pretrain_examples(item, jtok, max_seq_len,
                                                  items, r_theirs, n_neg)
        assert ours == theirs
        assert {e["next_label"] for e in ours} == {0, 1}
        assert all(len(e["input_ids"]) == max_seq_len + 2 for e in ours)
        assert any(lab >= 0 for e in ours for lab in e["label_ids"])
        assert r_ours.random() == r_theirs.random()


def test_field_dataset_checks_real_lengths_against_the_position_table(toks):
    """Given the model's config, the field arrays are checked where they
    are built: row 3's pvs pair fills all 512 tokens of a 512-row table and
    is refused by name; the other rows, padded to the same 512, pass and
    give the arrays built without the check."""
    _, ttok = toks
    cfg = ModelConfig(max_position_embeddings=512, pad_token_id=0)
    with pytest.raises(ValueError, match="row 3 of pvs_input_ids holds 512"):
        tbd.pairs_to_field_dataset(_rows(), ttok, config=cfg)
    rows = [r for i, r in enumerate(_rows()) if i != 3]
    checked = tbd.pairs_to_field_dataset(rows, ttok, config=cfg).arrays
    plain = tbd.pairs_to_field_dataset(rows, ttok).arrays
    assert checked["pvs_input_ids"].shape[1] == 512
    assert checked.keys() == plain.keys()
    for k, v in plain.items():
        assert np.array_equal(checked[k], v), k


def test_pretrain_dataset_stacks_the_examples_and_checks_positions(toks):
    """``pretrain_dataset`` holds ``bert-pretrain``'s arrays (``label_ids``
    as ``mlm_labels``), ``int32``; a table one row longer than the padded
    width passes, one of exactly that width refuses a full row."""
    _, ttok = toks
    items = [dict(it) for it in ITEMS]
    rng = random.Random(7)
    examples = []
    for item in items:
        examples += tbd.build_pretrain_examples(item, ttok, 8, items, rng)
    arrays = tbd.pretrain_dataset(examples).arrays
    for key, src in (("input_ids", "input_ids"), ("mlm_labels", "label_ids"),
                     ("attention_mask", "attention_mask"),
                     ("token_type_ids", "token_type_ids"),
                     ("next_label", "next_label")):
        assert arrays[key].dtype == np.int32, key
        assert np.array_equal(arrays[key],
                              np.asarray([e[src] for e in examples])), key
    full = int(np.nonzero(arrays["attention_mask"].sum(1) == 10)[0][0])
    tbd.pretrain_dataset(examples, ModelConfig(max_position_embeddings=11))
    with pytest.raises(ValueError, match=f"row {full} of input_ids holds 10"):
        tbd.pretrain_dataset(examples, ModelConfig(max_position_embeddings=10))


def test_masking_helpers_equal_jax(toks):
    jtok, ttok = toks
    pv = ttok.tokenize(ITEMS[0]["item_pvs"])
    assert pv == jtok.tokenize(ITEMS[0]["item_pvs"])
    props = tbd.split_pv_tokens(pv)
    assert props == jbd.split_pv_tokens(pv) and len(props) == 3
    title = ttok.tokenize(ITEMS[0]["title"])
    spans = tbd.title_value_match_spans(title, props)
    assert spans == jbd.title_value_match_spans(title, props) and spans
    ids = ttok.convert_tokens_to_ids(title)
    mask_id = ttok.convert_tokens_to_ids("[MASK]")
    for seed in range(6):
        for sp in (spans, []):
            assert tbd.title_mask(ids, sp, mask_id, len(ttok),
                                  random.Random(seed)) == \
                jbd.title_mask(ids, sp, mask_id, len(jtok),
                               random.Random(seed))
        assert tbd.whole_field_mask(ids, mask_id, len(ttok),
                                    random.Random(seed)) == \
            jbd.whole_field_mask(ids, mask_id, len(jtok), random.Random(seed))
        assert tbd.pv_mask_examples(props, ttok, random.Random(seed)) == \
            jbd.pv_mask_examples(props, jtok, random.Random(seed))
        assert tbd.shuffle_pvs(ITEMS[3]["item_pvs"].replace(" ", ""), seed) \
            == jbd.shuffle_pvs(ITEMS[3]["item_pvs"].replace(" ", ""), seed)
