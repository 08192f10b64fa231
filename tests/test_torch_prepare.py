"""The port's ``data/prepare.py`` vs the JAX package's: byte-equal files
from the same corpus and seed, and the same rows read back."""

import json
import os
import random

import pytest

from item_alignment_torch.data import prepare as tprep

pytest.importorskip("jieba")
from item_alignment_tpu.data import native_loader  # noqa: E402
from item_alignment_tpu.data import prepare as jprep  # noqa: E402


def write_corpus(raw, n_items=30, seed=0):
    """The tests/test_cli.py corpus: 30 items in two categories, 14 labelled
    train pairs, 4 test pairs."""
    raw.mkdir(parents=True, exist_ok=True)
    rng = random.Random(seed)
    cates = {"coffee": ["品牌", "容量"], "watch": ["品牌", "表带"]}
    items, pairs = [], []
    for i in range(n_items):
        cate = "coffee" if i % 2 == 0 else "watch"
        pv = "#;#".join(f"{k}#:#{rng.choice(['a', 'b'])}" for k in cates[cate])
        items.append({"item_id": f"i{i}", "cate_name": cate, "cate_id": cate,
                      "industry_name": "ind", "title": f"商品{i}",
                      "item_pvs": pv, "sku_pvs": ""})
    for i in range(0, n_items - 2, 2):
        pairs.append({"src_item_id": f"i{i}", "tgt_item_id": f"i{i + 2}",
                      "item_label": str(rng.randint(0, 1))})
    with open(raw / "item_info.jsonl", "w", encoding="utf-8") as w:
        for it in items:
            w.write(json.dumps(it, ensure_ascii=False) + "\n")
    with open(raw / "item_train_pair.jsonl", "w") as w:
        for pr in pairs:
            w.write(json.dumps(pr) + "\n")
    with open(raw / "item_test_pair.jsonl", "w") as w:
        for i in range(1, 9, 2):
            w.write(json.dumps({"src_item_id": f"i{i}",
                                "tgt_item_id": f"i{i + 2}",
                                "item_label": "0"}) + "\n")
    return raw


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("kw", [
    dict(valid_proportion=0.3),
    dict(valid_proportion=0.2, seed=7, num_train_augment=6, num_neg=2),
])
def test_prepare_all_writes_the_same_files(tmp_path, kw):
    raw = write_corpus(tmp_path / "raw")
    ours = tprep.prepare_all(str(raw), str(tmp_path / "torch"), **kw)
    ref = jprep.prepare_all(str(raw), str(tmp_path / "jax"), **kw)
    assert {k: os.path.basename(v) for k, v in ours.items()} == \
        {k: os.path.basename(v) for k, v in ref.items()}
    got, expect = _files(tmp_path / "torch"), _files(tmp_path / "jax")
    assert sorted(got) == sorted(expect)
    for name in expect:
        assert got[name] == expect[name], name
    assert got["finetune_train_train.tsv"] and got["finetune_test.tsv"]


def test_prev_valid_pins_the_split(tmp_path):
    raw = write_corpus(tmp_path / "raw")
    first = jprep.prepare_all(str(raw), str(tmp_path / "first"),
                              valid_proportion=0.3)
    for name, mod in (("torch", tprep), ("jax", jprep)):
        mod.prepare_all(str(raw), str(tmp_path / name), seed=3,
                        prev_valid=first["valid"])
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert (tmp_path / "torch" / "finetune_train_valid.tsv").read_bytes() == \
        open(first["valid"], "rb").read()


def test_read_finetune_tsv_matches(tmp_path):
    raw = write_corpus(tmp_path / "raw")
    files = jprep.prepare_all(str(raw), str(tmp_path / "p"))
    id_dict, cate_count, _ = jprep.load_item_info(str(raw / "item_info.jsonl"))
    cate2id = {c: i for i, c in enumerate(sorted(cate_count))}
    for split in ("train", "valid", "test"):
        assert tprep.read_finetune_tsv(files[split]) == \
            jprep.read_finetune_tsv(files[split])
        assert tprep.read_finetune_tsv(files[split], id_dict, cate2id) == \
            jprep.read_finetune_tsv(files[split], id_dict, cate2id)


@pytest.mark.parametrize("content", [
    b"",
    b"a\tb\n\nc\td\n",
    b"\n\n1\t\xe5\x95\x86\t\n   \n\t\nx\r\ny",
    b"only\tone\tline",
    b"trailing\ttabs\t\t\n\r\n",
])
def test_read_tsv_gives_the_native_scanner_rows(tmp_path, content):
    """Blank lines skipped, whitespace-only lines and ``\\r`` kept, empty
    fields kept, a last line without a newline read."""
    path = tmp_path / "t.tsv"
    path.write_bytes(content)
    assert native_loader.get_lib() is not None or content == b""
    assert tprep.read_tsv(str(path)) == native_loader.read_tsv_fast(str(path))


def test_segment_title_and_pv_ordering_match(tmp_path):
    raw = write_corpus(tmp_path / "raw", n_items=12, seed=3)
    for title in ("商品12 咖啡机", "", "a b  c", "手表表带 iPhone13"):
        assert tprep.segment_title(title) == jprep.segment_title(title)
    info = str(raw / "item_info.jsonl")
    pairs = str(raw / "item_train_pair.jsonl")
    t_ids, t_cc, t_rc = tprep.load_item_info(info)
    j_ids, j_cc, j_rc = jprep.load_item_info(info)
    assert t_cc == j_cc
    tprep.accumulate_pair_statistics(t_ids, t_rc, pairs)
    jprep.accumulate_pair_statistics(j_ids, j_rc, pairs)
    for method in ("freq", "topn"):
        assert tprep.filter_relations(t_rc, t_cc, method) == \
            jprep.filter_relations(j_rc, j_cc, method)
    assert t_rc == j_rc
    for a, b in (("i0", "i2"), ("i1", "i4")):
        assert tprep.order_pvs_pair(t_ids[a]["pvs"], t_ids[b]["pvs"], t_rc,
                                    "coffee", "watch") == \
            jprep.order_pvs_pair(j_ids[a]["pvs"], j_ids[b]["pvs"], j_rc,
                                 "coffee", "watch")
