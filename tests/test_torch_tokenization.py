"""The port's WordPiece tokenizer and text layouts vs the JAX package's
(``transformers.BertTokenizer`` with basic tokenization off and ``<S>`` as
bos, real jieba): ids, token types and masks must be exactly equal."""

import random
import sys

import numpy as np
import pytest

from item_alignment_torch.data import tokenization as ttok

pytest.importorskip("transformers")
pytest.importorskip("jieba")
from item_alignment_tpu.data import tokenization as jtok  # noqa: E402

# the tests/test_cli.py vocab
CLI_VOCAB = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]", ":", ";", "a", "b", "商",
                "品", "牌", "容", "量", "表", "带"]
             + [str(d) for d in range(10)] + ["<S>"])
# ":" and ";" at the ids the auxiliary task scans for (131, 132), and
# continuation pieces for the greedy longest match
FILLER = ["c", "ab", "abc", "##b", "##c", "##bc", "##品", "##牌", "商品", "品牌",
          "hello", "##lo", "##llo", "he", "σ", "x", "##x", "1", "##1", "##2",
          "##3", "iphone", "##13", "容量", "表带", "咖啡", "手表"]
AUX_VOCAB = (CLI_VOCAB[:104] + FILLER
             + [":", ";", "a", "b", "商", "品", "牌", "容", "量", "表", "带"]
             + [str(d) for d in range(10)] + ["<S>"])
assert AUX_VOCAB.index(":") == 131 and AUX_VOCAB.index(";") == 132
VOCABS = {"cli": CLI_VOCAB, "cli_no_bos": CLI_VOCAB[:-1], "aux": AUX_VOCAB}

ALPHABET = (list("商品牌容量表带咖啡手abcABCxX:;,.0123456789σΣİ#")
            + ["[SEP]", "[CLS]", "<S>", "[unused99]", "[PAD]", "[sep]", "<s>",
               " ", "  ", "\t", "\n", "　", "##", "iPhone13", "HeLLo",
               "x" * 101, "商" * 100])


@pytest.fixture(scope="module", params=sorted(VOCABS))
def tokenizers(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(request.param)
    (d / "vocab.txt").write_text("\n".join(VOCABS[request.param]),
                                 encoding="utf-8")
    return (ttok.load_text_tokenizer(str(d)), jtok.load_text_tokenizer(str(d)),
            str(d))


def _text(rng, n_max=24):
    return "".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, n_max)))


def test_vocab_size_and_special_ids(tokenizers):
    ours, ref, _ = tokenizers
    assert len(ours) == len(ref)
    for name in ("bos", "sep", "cls", "pad", "unk"):
        assert getattr(ours, f"{name}_token_id") == \
            getattr(ref, f"{name}_token_id"), name
    assert ours.sep_token == ref.sep_token == "[SEP]"


def test_tokenize_matches(tokenizers):
    ours, ref, _ = tokenizers
    rng = random.Random(0)
    for _ in range(400):
        text = _text(rng)
        assert ours.tokenize(text) == ref.tokenize(text), repr(text)


@pytest.mark.parametrize("max_length", [None, 2, 3, 7, 16, 64])
@pytest.mark.parametrize("pair", [False, True])
def test_encode_matches(tokenizers, max_length, pair):
    """Single and pair calls, truncating (True and "longest_first") and
    not, padded to max_length and not; whole batches as lists too."""
    ours, ref, _ = tokenizers
    rng = random.Random((max_length or 0) + 100 * pair)
    calls = []
    for i in range(60):
        text = _text(rng)
        kw = {"text_pair": _text(rng)} if pair else {}
        if max_length is not None:
            kw.update(max_length=max_length,
                      truncation=("longest_first", True)[i % 2])
            if i % 3:
                kw["padding"] = "max_length"
        calls.append((text, kw))
        assert ours(text, **kw) == dict(ref(text, **kw)), (text, kw)
    if max_length is not None and max_length > 3:  # rows of equal length
        texts = [t for t, _ in calls]
        kw = dict(max_length=max_length, truncation=True,
                  padding="max_length")
        if pair:
            kw["text_pair"] = [k["text_pair"] for _, k in calls]
        assert ours(texts, **kw) == dict(ref(texts, **kw))


def test_reference_quirks(tokenizers):
    ours, _, _ = tokenizers
    assert ours.tokenize("HELLO") == ours.tokenize("hello")
    assert ours.tokenize("iPhone13 Ab,商品[unused99]x")[-1] == "[UNK]"
    assert ours.tokenize("a [SEP]<S>")[1:] == ["[SEP]", "<S>"]
    assert ours.tokenize("x" * 101) == ["[UNK]"]


def _rows(n, seed):
    """Finetune rows (label, id, cate, title, pvs, id, cate, title, pvs)
    with pvs aligned key by key, as prepare orders them."""
    rng = random.Random(seed)
    keys = ["品牌", "容量", "表带", "颜色"]
    vals = ["a", "b", "咖啡", "手表", "iPhone13", "1"]

    def pvs(ks):
        return ";".join(f"{k}:{rng.choice(vals)}" for k in ks)

    rows = []
    for i in range(n):
        ks = rng.sample(keys, rng.randint(0, 4))
        tk = ks[: rng.randint(0, len(ks))] + rng.sample(keys, 1)
        rows.append((str(rng.randint(0, 1)), f"s{i}", 0,
                     rng.choice(["商品 1", "咖啡 手表", "HeLLo 商品", ""]),
                     pvs(ks), f"t{i}", 0, rng.choice(["商品 2", "表带 a"]),
                     pvs(tk)))
    return rows


def _assert_same(ours, ref):
    assert sorted(ours.arrays) == sorted(ref.arrays)
    for k in ref.arrays:
        assert ours.arrays[k].dtype == ref.arrays[k].dtype, k
        np.testing.assert_array_equal(ours.arrays[k], ref.arrays[k], k)
    assert ours.meta == ref.meta


@pytest.mark.parametrize("method,aux,workers", [
    ("cls", False, 0), ("cls", True, 0), ("vec_sim", False, 0),
    ("vec_sim", True, 2), ("cls", True, 2)])
@pytest.mark.parametrize("lens", [(8, 16), (None, 12), (6, None)])
def test_one_tower_dataset_matches(tokenizers, method, aux, workers, lens):
    ours, ref, _ = tokenizers
    rows = _rows(24, 1)
    kw = dict(classification_method=method, auxiliary_task=aux,
              max_pairs=6)
    got = ttok.rows_to_one_tower_dataset(rows, ours, *lens,
                                         num_workers=workers, **kw)
    expect = jtok.rows_to_one_tower_dataset(rows, ref, *lens, **kw)
    _assert_same(got, expect)
    if aux and ours.vocab.get(":") == 131 and None not in lens:
        # the aux vocab puts ":" and ";" at 131/132: spans are found
        assert (got.arrays["pair_spans"][..., 0] >= 0).any()


def test_two_tower_dataset_matches(tokenizers):
    ours, ref, _ = tokenizers
    rows = _rows(12, 2)
    for lens in ((8, 16), (5, 3)):
        _assert_same(ttok.rows_to_two_tower_dataset(rows, ours, *lens),
                     jtok.rows_to_two_tower_dataset(rows, ref, *lens))


def test_encode_texts_matches(tokenizers):
    """The item/entity text batches of ``mine`` and ``pred-text``, serial
    and over two worker processes."""
    _, ref, vocab_dir = tokenizers
    rng = random.Random(3)
    texts = [_text(rng) for _ in range(16)]
    enc = ref(texts, padding="max_length", truncation=True, max_length=12)
    for workers in (0, 2):
        ids, mask = ttok.encode_texts(vocab_dir, texts, 12, workers)
        assert ids.dtype == mask.dtype == np.int32
        np.testing.assert_array_equal(ids, np.asarray(enc["input_ids"]))
        np.testing.assert_array_equal(mask,
                                      np.asarray(enc["attention_mask"]))


def test_segmentation_matches():
    rng = random.Random(4)
    for _ in range(20):
        pvs = ";".join(f"{rng.choice(['品牌', '容量大小'])}:"
                       f"{rng.choice(['咖啡机', 'a b', '手表表带'])}"
                       for _ in range(rng.randint(0, 3)))
        assert ttok.segment_pvs(pvs) == jtok.segment_pvs(pvs)
        assert ttok.build_item_text("商品 1", pvs) == \
            jtok.build_item_text("商品 1", pvs)


def test_extract_pair_indices_matches():
    """Random id runs, well-formed or not: the same spans, or the same
    error where a ";" comes before any ":"."""
    rs = np.random.RandomState(5)
    for _ in range(300):
        ids = list(rs.choice([102, 131, 132, 7, 8, 9], rs.randint(0, 40)))
        outcomes = []
        for mod in (ttok, jtok):
            try:
                outcomes.append(mod.extract_pair_indices(ids, 102, 5))
            except TypeError as e:
                outcomes.append(type(e))
        if isinstance(outcomes[1], np.ndarray):
            np.testing.assert_array_equal(outcomes[0], outcomes[1])
        else:
            assert outcomes[0] is outcomes[1]


def test_kg_tokenizers_match(tmp_path):
    path = tmp_path / "entity2id.txt"
    path.write_text("/item/i0\t0\n\n/value/a b\t1\n/value/x\ty\t2\n",
                    encoding="utf-8")
    assert ttok.load_kg_tokenizers(str(path), str(path)) == \
        jtok.load_kg_tokenizers(str(path), str(path))


def test_missing_jieba_raises(monkeypatch):
    """No whitespace fallback: without jieba the segmenters raise."""
    from item_alignment_torch.data import prepare as tprep

    monkeypatch.setitem(sys.modules, "jieba", None)
    with pytest.raises(ImportError):
        ttok.segment_pvs("品牌:a")
    with pytest.raises(ImportError):
        tprep.segment_title("商品")
