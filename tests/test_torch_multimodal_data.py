"""The port's RobertaImage layouts and image-embedding text vs the JAX
package's, on the CPU: arrays equal, text equal byte for byte.

The layouts run on a vocab with ``[unused99]`` at row 99 (the image token's
id in both packages) and on one without it, where neither package finds id
99 and both put the tgt image on position 1.
"""

import json

import numpy as np
import pytest

from item_alignment_torch.data import images as timg
from item_alignment_torch.data import tokenization as ttok

pytest.importorskip("jieba")
pytest.importorskip("transformers")
from item_alignment_tpu.data import images as jimg  # noqa: E402
from item_alignment_tpu.data import native_loader  # noqa: E402
from item_alignment_tpu.data import tokenization as jtok  # noqa: E402

I = 6
WORDS = [":", ";", "a", "b", "商", "品", "牌", "##品", "商品"] + \
    [str(d) for d in range(10)] + ["<S>"]
SPECIAL = ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
VOCABS = {
    # BERT-Chinese's layout: [unused99] at row 99
    "unused99_at_99": ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
    + SPECIAL + WORDS,
    # no [unused99] at all: the image token becomes [UNK]
    "no_unused99": ["[PAD]"] + SPECIAL + WORDS,
}


def _emb(rs, n):
    return ",".join(f"{x:.9g}" for x in rs.randn(n).astype(np.float32))


def _rows():
    rs = np.random.RandomState(0)
    return [
        ("1", "s0", "商品 a", "品牌:a;a:b", _emb(rs, I),
         "t0", "商品 b", "品牌:b", _emb(rs, I)),
        # a long src that truncation cuts, a short image column (zero pad)
        ("0", "s1", "商品 a b 商 品 牌 1 2 3 4 5 6 7 8", "a:1;b:2;a:3;b:4",
         _emb(rs, I - 2), "t1", "品", "b:a", _emb(rs, I + 3)),
        # empty pvs and an empty image column
        ("1", "s2", "a", "", "", "t2", "b", "", _emb(rs, I)),
    ]


@pytest.fixture(scope="module", params=sorted(VOCABS))
def tokenizers(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    (d / "vocab.txt").write_text("\n".join(VOCABS[request.param]),
                                 encoding="utf-8")
    return (request.param, ttok.load_text_tokenizer(str(d)),
            jtok.load_text_tokenizer(str(d)))


def _same(ours, theirs):
    assert ours.arrays.keys() == theirs.arrays.keys()
    for k, v in ours.arrays.items():
        assert v.dtype == theirs.arrays[k].dtype, k
        np.testing.assert_array_equal(v, theirs.arrays[k], k)
    assert ours.meta == theirs.meta


@pytest.mark.parametrize("ensemble", ["begin", "end"])
@pytest.mark.parametrize("lengths", [(4, 6), (None, 6), (4, None)])
def test_image_one_tower_layout_matches_jax(tokenizers, ensemble, lengths):
    name, ours_tok, jax_tok = tokenizers
    L, P = lengths
    ours = ttok.rows_to_image_one_tower_dataset(_rows(), ours_tok, L, P, I,
                                                ensemble)
    theirs = jtok.rows_to_image_one_tower_dataset(_rows(), jax_tok, L, P, I,
                                                  ensemble)
    _same(ours, theirs)
    assert ours.arrays["src_image_embeds"].dtype == np.float32
    assert ours.arrays["src_image_embeds"].shape == (3, I)
    ids, index = ours.arrays["input_ids"], ours.arrays["image_indices"]
    if ensemble == "end":
        assert not index.any()
    elif name == "unused99_at_99":
        assert (ids[:, 1] == 99).all() and (index > 1).all()
        assert (ids[np.arange(3), index] == 99).all()
    else:  # no id 99 anywhere: both images land on position 1
        assert not (ids == 99).any() and (index == 1).all()


@pytest.mark.parametrize("ensemble", ["begin", "sum"])
def test_image_two_tower_layout_matches_jax(tokenizers, ensemble):
    name, ours_tok, jax_tok = tokenizers
    ours = ttok.rows_to_image_two_tower_dataset(_rows(), ours_tok, 4, 6, I,
                                                ensemble)
    theirs = jtok.rows_to_image_two_tower_dataset(_rows(), jax_tok, 4, 6, I,
                                                  ensemble)
    _same(ours, theirs)
    if ensemble == "begin" and name == "unused99_at_99":
        assert (ours.arrays["input_ids_1"][:, 1] == 99).all()


def test_encode_image_one_tower_matches_jax(tokenizers):
    _, ours_tok, jax_tok = tokenizers
    for args in (("商品 a", "品 b", 5), ("a", "b 1 2 3 4 5 6 7 8 9", 4)):
        assert ttok.encode_image_one_tower(ours_tok, *args) == \
            jtok.encode_image_one_tower(jax_tok, *args)


@pytest.mark.parametrize("text,width", [
    ("1.5,-2,3e-3", 5),           # zero-padded
    ("1,2,3,4,5,6,7", 4),         # cut
    ("", 3), (" , ,", 3),         # empty
    ("0.1, 0.2 ,0.3,", 3),        # spaces and a trailing comma
])
def test_parse_embedding_column_matches_jax(text, width):
    ours = ttok._parse_embedding_column(text, width)
    theirs = jtok._parse_embedding_column(text, width)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == (width,)
    np.testing.assert_array_equal(ours, theirs)


def _matrix():
    rs = np.random.RandomState(1)
    m = (rs.randn(5, 7) * 10.0 ** rs.randint(-8, 9, (5, 7))).astype(np.float32)
    m[0, :3] = [0.0, -0.0, 1e-38]
    m[1, :2] = [3.4028235e38, 1.4e-45]
    return m


def test_embedding_texts_match_jax(monkeypatch):
    """``%.9g`` rows byte-equal to the JAX package's Python formatting and
    to its native formatter, and each gives back its fp32 value."""
    m = _matrix()
    ours = timg.embedding_texts(m)
    if native_loader.get_lib() is not None:
        assert ours == jimg.embedding_texts(m)
    monkeypatch.setattr(native_loader, "format_rows", lambda mat: None)
    assert ours == jimg.embedding_texts(m)
    back = np.asarray([r.split(",") for r in ours], np.float32)
    np.testing.assert_array_equal(back.view(np.int32), m.view(np.int32))


def test_embedding_json_round_trip_matches_jax(tmp_path, monkeypatch):
    """``write_embedding_json`` writes JAX's bytes; reading it back through
    ``embedding_texts_from_mapping`` (also with ragged rows) gives JAX's
    texts."""
    monkeypatch.setattr(native_loader, "format_rows", lambda mat: None)
    m = _matrix()
    ids = [f"i{k}" for k in range(4)] + ["商品"]
    texts = timg.embedding_texts(m)
    timg.write_embedding_json(ids, texts, str(tmp_path / "t" / "e.json"))
    jimg.write_embedding_json(ids, texts, str(tmp_path / "j" / "e.json"))
    raw = (tmp_path / "t" / "e.json").read_bytes()
    assert raw == (tmp_path / "j" / "e.json").read_bytes()
    loaded = json.loads(raw)
    back = timg.load_embedding_json(str(tmp_path / "t" / "e.json"))
    assert back == jimg.embedding_texts_from_mapping(loaded)
    # the same values; json.load reads "-0" as the integer 0, so "-0"
    # comes back as "0" in both packages
    assert back["i0"].split(",")[1] == "0" and texts[0].split(",")[1] == "-0"
    np.testing.assert_array_equal(
        np.asarray([back[i].split(",") for i in ids], np.float32), m)
    loaded["i1"] = loaded["i1"][:3]
    assert timg.embedding_texts_from_mapping(loaded) == \
        jimg.embedding_texts_from_mapping(loaded)
    assert timg.embedding_texts_from_mapping({}) == {}


# ------------------------------------------------- the last two builders
def _image_loader(path):
    """tests/test_multimodal_data.py's loader: None for a broken image,
    else an image that depends on the path alone."""
    if "bad" in str(path) or not path:
        return None
    seed = sum(map(ord, path)) % 100
    return np.random.RandomState(seed).randint(0, 255, (40, 52, 3), np.uint8)


@pytest.mark.parametrize("bos", [False, True])
def test_multimodal_pretrain_builder_matches_jax(tokenizers, bos):
    """The inputs of tests/test_multimodal_data.py:34-50 and a long title
    that truncation cuts: a broken image drops its item, and arrays and
    meta are equal to JAX's."""
    _, ours_tok, jax_tok = tokenizers
    items = [
        {"item_id": "a", "title": "商品", "pvs": "品牌:a", "image_path": "a.png"},
        {"item_id": "b", "title": "商品", "pvs": "a:b", "image_path": "bad.png"},
        {"item_id": "c", "title": "商品", "pvs": "", "image_path": "c.png"},
        {"item_id": "d", "title": "商品 a b 1 2 3 4 5 6 7 8 9",
         "pvs": "a:1;b:2", "image_path": "d.png"},
    ]
    ours = ttok.build_multimodal_pretrain_dataset(
        items, ours_tok, _image_loader, max_seq_len=12, image_size=16, bos=bos)
    theirs = jtok.build_multimodal_pretrain_dataset(
        items, jax_tok, _image_loader, max_seq_len=12, image_size=16, bos=bos)
    _same(ours, theirs)
    assert ours.meta["item_id"] == ["a", "c", "d"]
    assert ours.arrays["images"].shape == (3, 16, 16, 3)
    assert ours.arrays["images"].dtype == np.uint8
    if bos:
        assert (ours.arrays["input_ids"][:, 1] == ours_tok.bos_token_id).all()
    empty = ttok.build_multimodal_pretrain_dataset(
        items[1:2], ours_tok, _image_loader, max_seq_len=12, image_size=16)
    _same(empty, jtok.build_multimodal_pretrain_dataset(
        items[1:2], jax_tok, _image_loader, max_seq_len=12, image_size=16))
    assert empty.arrays["images"].shape == (0, 16, 16, 3)


def test_pv_pair_dataset_matches_jax(tmp_path):
    """tests/test_type_constraints.py:57-70's vocab and row, plus a row
    that truncation cuts and one with no pvs: token types go up by one
    after the second [SEP], and arrays and meta are equal to JAX's."""
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + \
        ["[UNK]", "[CLS]", "[SEP]", "[MASK]", ":", ";", "a", "b", "商", "品"] \
        + ["<S>"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab), encoding="utf-8")
    ours_tok = ttok.load_text_tokenizer(str(tmp_path))
    jax_tok = jtok.load_text_tokenizer(str(tmp_path))
    rows = [("1", "s0", "商品 a", "t0", "商品 b", "a:1;b:0"),
            ("0", "s1", "商 品 a b a b a b a b", "t1", "品 a b a b a b",
             "a:b;b:a;a:a;b:b"),
            ("1", "s2", "a", "t2", "b", "")]
    ours = ttok.rows_to_pv_pair_dataset(rows, ours_tok, max_seq_len=6,
                                        max_seq_len_pv=8)
    theirs = jtok.rows_to_pv_pair_dataset(rows, jax_tok, max_seq_len=6,
                                          max_seq_len_pv=8)
    _same(ours, theirs)
    ids, tt = ours.arrays["input_ids"], ours.arrays["token_type_ids"]
    assert ids.shape == (3, 2 * 6 + 8)
    for r in range(3):
        seps = np.flatnonzero(ids[r] == ours_tok.sep_token_id)
        assert tt[r, seps[1] + 1] == tt[r, seps[1]] + 1
