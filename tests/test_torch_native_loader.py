"""The port's native data loader (``data/native_loader.py`` over
``csrc/ia_data.cpp``) vs the JAX package's, on the CPU.

Every case of ``tests/test_native_loader.py`` runs on both packages' loaders
on the same file: offsets, rows (blank lines, ``\\r``, whitespace-only
lines, an empty file), the fp32 text, the JSON spans and the refusals must
be equal.  Then the port's own rules: the library is built by g++ at first
use into ``build/native`` (never ``native/``), nothing is built at import,
and a compiler that fails raises instead of falling back to Python.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from item_alignment_torch.data import images as timg
from item_alignment_torch.data import native_loader as T
from item_alignment_torch.data import prepare as tprep

pytest.importorskip("jax")
from item_alignment_tpu.data import images as jimg  # noqa: E402
from item_alignment_tpu.data import native_loader as J  # noqa: E402
from item_alignment_tpu.data import prepare as jprep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def jax_lib():
    """The JAX loader's own library: without it JAX's functions take their
    Python fallbacks, which are not what the port follows."""
    assert J.get_lib() is not None, "native/ia_data.cpp does not build here"


def _write_tsv(path, rows):
    with open(path, "w", encoding="utf-8") as w:
        for r in rows:
            w.write("\t".join(r) + "\n")


def _python_rows(path):
    with open(path, encoding="utf-8") as f:
        return [tuple(line.rstrip("\n").split("\t")) for line in f
                if line.strip()]


def test_tsv_index_counts_match_jax(tmp_path):
    p = str(tmp_path / "t.tsv")
    _write_tsv(p, [("1", "a", "红色咖啡机"), ("0", "b", "x y")])
    ours, theirs = T.tsv_index(p), J.tsv_index(p)
    assert ours[2].tolist() == [3, 3] and len(ours[0]) == 6
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def test_read_tsv_fast_matches_jax_and_python(tmp_path):
    p = str(tmp_path / "pairs.tsv")
    _write_tsv(p, [("1", "i01", "商品 标题", "品牌:acme;容量:12", "i02", "t", "p"),
                   ("0", "i03", "x", "", "i04", "y", "品牌:z")])
    assert T.read_tsv_fast(p) == J.read_tsv_fast(p) == _python_rows(p)


@pytest.mark.parametrize("content", [
    b"",
    b"a\tb\n\nc\td\n",
    b"\n\n1\t\xe5\x95\x86\t\n   \n\t\nx\r\ny",
    b"only\tone\tline",
    b"trailing\ttabs\t\t\n\r\n",
    b"   \n \t \n\n",
])
def test_read_tsv_fast_edge_rows_match_jax(tmp_path, content):
    """JAX's native scan: blank lines skipped, whitespace-only lines and
    ``\\r`` kept, empty fields kept, a last line without a newline read, an
    empty file no rows.  The port's plain version and ``prepare.read_tsv``
    give the same rows."""
    p = str(tmp_path / "t.tsv")
    Path(p).write_bytes(content)
    ours = T.read_tsv_fast(p)
    assert ours == J.read_tsv_fast(p)
    assert ours == T.read_tsv_reference(p) == tprep.read_tsv(p)
    if content:
        assert T.count_lines(p) == J.count_lines(p) == content.count(b"\n")


def test_read_tsv_fast_large_parity_and_speed(tmp_path):
    rs = np.random.RandomState(0)
    rows = [("%d" % (i % 2), f"id{i}", "商品" * 10,
             ";".join(f"k{j}:v{rs.randint(100)}" for j in range(8)),
             f"id{i + 1}", "商品" * 10, "k:v")
            for i in range(20000)]
    p = str(tmp_path / "big.tsv")
    _write_tsv(p, rows)
    t0 = time.time()
    fast = T.read_tsv_fast(p)
    t_fast = time.time() - t0
    assert fast == [tuple(r) for r in rows] == J.read_tsv_fast(p)
    assert T.count_lines(p) == J.count_lines(p) == 20000
    assert t_fast < 10.0


def test_prepare_reader_uses_native(tmp_path, monkeypatch):
    p = str(tmp_path / "ft.tsv")
    _write_tsv(p, [("1", "a", "ta", "k:v", "b", "tb", "k:w")])
    calls = []
    real = T.read_tsv_fast
    monkeypatch.setattr(T, "read_tsv_fast",
                        lambda path: calls.append(path) or real(path))
    out = tprep.read_finetune_tsv(p)
    assert calls == [p]
    assert out == jprep.read_finetune_tsv(p)
    assert out[0][0] == "1" and out[0][1] == "a" and out[0][5] == "b"


def test_format_rows_fp32_roundtrip_matches_jax():
    rs = np.random.RandomState(0)
    mat = np.concatenate([
        rs.randn(7, 5).astype(np.float32) * 1e3,
        np.array([[0, -0, 1e-38, 3.4e38, 1.5, -2.25, 1 / 3, 7e-20, 1, -1]],
                 np.float32).reshape(2, 5),
    ]).astype(np.float32)
    texts = T.format_rows(mat)
    assert texts == J.format_rows(mat) == T.format_rows_reference(mat)
    back = np.array([[np.float32(v) for v in t.split(",")] for t in texts],
                    np.float32)
    np.testing.assert_array_equal(back, mat)
    # more rows than a chunk, and another separator
    big = rs.randn(10, 3).astype(np.float32)
    assert T.format_rows(big, ";", chunk=4) == J.format_rows(big, ";", chunk=4)
    with pytest.raises(ValueError):
        T.format_rows(big[0])


def test_embedding_json_roundtrip_matches_jax(tmp_path):
    mat = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    ids = ["a", "b-1", "商品", "d"]
    texts = T.format_rows(mat)
    path = tmp_path / "emb.json"
    timg.write_embedding_json(ids, texts, str(path))
    loaded = json.loads(path.read_text(encoding="utf-8"))
    assert list(loaded) == ids
    np.testing.assert_array_equal(np.array(loaded["a"], np.float32), mat[0])
    spans = T.read_embedding_spans(str(path))
    assert spans == list(zip(ids, texts)) == J.read_embedding_spans(str(path))


def test_embedding_spans_read_a_reference_style_dump_as_jax(tmp_path):
    """``json.dump`` writes ``", "`` and a space after ``:``; the spans
    keep the file's own text without the spaces."""
    path = tmp_path / "ref.json"
    data = {"x1": [0.25, -1.5, 3.0], "x2": [1e-3, 2.0, 0.125]}
    path.write_text(json.dumps(data), encoding="utf-8")
    spans = T.read_embedding_spans(str(path))
    assert spans == J.read_embedding_spans(str(path))
    emb = dict(spans)
    assert emb["x1"] == "0.25,-1.5,3.0"
    assert [np.float32(v) for v in emb["x2"].split(",")] == [
        np.float32(1e-3), np.float32(2.0), np.float32(0.125)]
    # newlines inside an array (an indented dump) are taken out too
    path.write_text(json.dumps(data, indent=2), encoding="utf-8")
    assert T.read_embedding_spans(str(path)) == spans


@pytest.mark.parametrize("text", [
    '{"a\\"b": [1.0]}',   # an escaped key
    '{"a": [[1.0]]}',     # nesting
    '{"a": 1.0}',         # not an array
    '[1.0]',              # not a map
])
def test_embedding_spans_refuse_what_jax_refuses(tmp_path, text):
    p = tmp_path / "x.json"
    p.write_text(text, encoding="utf-8")
    assert T.read_embedding_spans(str(p)) is None
    assert J.read_embedding_spans(str(p)) is None


def test_embedding_spans_of_an_empty_file_and_map(tmp_path):
    p = tmp_path / "empty.json"
    p.write_text("")
    assert T.read_embedding_spans(str(p)) is None
    assert J.read_embedding_spans(str(p)) is None
    p.write_text(" { } ")
    assert T.read_embedding_spans(str(p)) == J.read_embedding_spans(str(p)) == []


def test_format_rows_max_width_values_match_jax():
    """Every value at the widest ``%.9g`` (15 characters): the staging
    buffer must keep the native side's 32-byte headroom."""
    mat = np.full((1, 2304), np.float32(-1.17549435e-38))
    texts = T.format_rows(mat)
    assert texts == J.format_rows(mat)
    back = np.array([np.float32(v) for v in texts[0].split(",")], np.float32)
    np.testing.assert_array_equal(back, mat[0])


def test_format_rows_nonfinite_json_compatible(tmp_path):
    mat = np.array([[np.nan, np.inf, -np.inf, 1.5]], np.float32)
    texts = T.format_rows(mat)
    assert texts == J.format_rows(mat) == ["NaN,Infinity,-Infinity,1.5"]
    assert T.format_rows_reference(mat) == texts
    path = tmp_path / "nf.json"
    timg.write_embedding_json(["a"], texts, str(path))
    loaded = json.loads(path.read_text())
    assert np.isnan(loaded["a"][0]) and loaded["a"][1:] == [
        float("inf"), float("-inf"), 1.5]


def test_embedding_texts_from_mapping_ragged_matches_jax():
    for raw in ({"a": [1.0, 2.0], "b": [3.0]}, {}, {"a": [0.1, -0.0]},
                {"a": [], "b": [1e-45, float("nan")]}):
        assert timg.embedding_texts_from_mapping(raw) == \
            jimg.embedding_texts_from_mapping(raw)
    assert timg.embedding_texts_from_mapping(
        {"a": [1.0, 2.0], "b": [3.0]}) == {"a": "1,2", "b": "3"}


def test_library_lands_under_build_native():
    path = Path(T.get_lib()._name).resolve()
    assert path.parent == ROOT / "build" / "native"
    assert path == T.library_path()
    assert path.name.startswith("libia_data-") and path.suffix == ".so"
    assert not path.is_relative_to(ROOT / "native")


def test_nothing_is_built_at_import(tmp_path):
    code = ("import item_alignment_torch.cli, item_alignment_torch.data.images,"
            " item_alignment_torch.data.prepare;"
            " import item_alignment_torch.data.native_loader as n;"
            " print(n._lib is None and n.BUILD_INFO == {})")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True"


def test_a_failing_compiler_raises(tmp_path, monkeypatch):
    fake = tmp_path / "bad-g++"
    fake.write_text("#!/bin/sh\necho 'ia_data.cpp: error: no compiler here' >&2"
                    "\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(T, "_lib", None)
    monkeypatch.setattr(T, "BUILD_DIR", tmp_path / "native_build")
    monkeypatch.setattr(T, "CXX", str(fake))
    with pytest.raises(RuntimeError, match="error: no compiler here"):
        T.format_rows(np.zeros((1, 2), np.float32))
    assert T._lib is None
    assert not list((tmp_path / "native_build").iterdir())  # no temp left
    monkeypatch.setattr(T, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler not found"):
        T.read_tsv_fast(__file__)
