"""The port's image data (``data/images.py``) vs the JAX package's, on the
CPU.

The host code is the same numpy and PIL calls, so transforms, shards, the
embedding JSON, the saliency boxes and the crops' files are equal bit for
bit (``train_transform`` on two ``RandomState``s of one seed).  The
on-device resize is held within 1e-5 of ``jax.image.resize``.  A missing
Pillow raises in the port, where the JAX package counts every image as
broken.
"""

import builtins
import json

import numpy as np
import pytest
import torch
from PIL import Image

from item_alignment_torch.data import images as T

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from item_alignment_tpu.data import images as J  # noqa: E402

torch.set_num_threads(1)


def _img(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def _product(h, w, seed):
    """A product (a noisy block) on a plain background."""
    rs = np.random.RandomState(seed)
    img = np.full((h, w, 3), rs.randint(200, 256), np.uint8)
    y, x = rs.randint(0, h // 3), rs.randint(0, w // 3)
    img[y:y + h // 2, x:x + w // 2] = rs.randint(0, 120, (h // 2, w // 2, 3))
    return img


@pytest.mark.parametrize("h,w", [(100, 80), (61, 97), (64, 64)])
def test_transforms_equal_jax_bit_for_bit(h, w):
    img = _img(h, w, h + w)
    for normalized in (True, False):
        for size, pct in ((32, 0.875), (48, 1.0)):
            ours = T.eval_transform(img, size, pct, normalized=normalized)
            theirs = J.eval_transform(img, size, pct, normalized=normalized)
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
        r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
        for _ in range(4):  # the generators stay in step
            np.testing.assert_array_equal(
                T.train_transform(img, 32, r1, normalized=normalized),
                J.train_transform(img, 32, r2, normalized=normalized))
    np.testing.assert_array_equal(T.center_crop(img, 40),
                                  J.center_crop(img, 40))
    np.testing.assert_array_equal(T.normalize(img), J.normalize(img))


@pytest.mark.parametrize("side,size", [(64, 24), (40, 32), (20, 32)])
def test_device_resize_normalize_matches_jax(side, size):
    imgs = np.stack([_img(side, side + 3, s) for s in range(2)])
    ours = T.device_resize_normalize(torch.from_numpy(imgs), size)
    theirs = np.asarray(jax.jit(
        lambda x: J.device_resize_normalize(x, size))(jnp.asarray(imgs)))
    assert ours.shape == theirs.shape == (2, size, size, 3)
    assert np.abs(ours.numpy() - theirs).max() < 1e-5


def test_shards_read_both_ways(tmp_path):
    pairs = [(f"s{i}|t{i}", _img(8, 8, i), _img(8, 8, i + 10), i % 2)
             for i in range(5)]
    ours = T.write_image_shards(pairs, str(tmp_path / "a"), shard_size=2,
                                transformed=True)
    theirs = J.write_image_shards(pairs, str(tmp_path / "b"), shard_size=2,
                                  transformed=True)
    assert [p.split("/")[-1] for p in ours] == \
        [p.split("/")[-1] for p in theirs] == [
            "train_feat_0.npz", "train_feat_1.npz", "train_feat_2.npz"]
    for a, b in ((T.read_image_shards(ours), J.read_image_shards(ours)),
                 (T.read_image_shards(theirs), J.read_image_shards(ours))):
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])
    f32 = [(p, a.astype(np.float32), b.astype(np.float32), lab)
           for p, a, b, lab in pairs]
    path, = T.write_image_shards(f32, str(tmp_path / "c"), shard_size=8)
    shard, = J.read_image_shards([path])
    assert shard["images_1"].dtype == np.float32
    assert not shard["transformed"]


def test_dump_image_embeddings_writes_the_same_json(tmp_path):
    ids, paths = [], []
    for i in range(7):
        ids.append(f"i{i}")
        paths.append(str(tmp_path / f"i{i}.jpg"))
        if i != 3:  # i3's image is missing: a zero vector, after the others
            Image.fromarray(_img(40 + i, 50, i)).save(paths[-1])
    w = np.random.RandomState(0).randn(3, 5).astype(np.float32)

    def encode(batch):
        return batch.mean(axis=(1, 2)) @ w

    ours = T.dump_image_embeddings(ids, paths, encode,
                                   str(tmp_path / "a.json"), image_size=16,
                                   batch_size=3, missing_dim=5)
    theirs = J.dump_image_embeddings(ids, paths, encode,
                                     str(tmp_path / "b.json"), image_size=16,
                                     batch_size=3, missing_dim=5)
    assert ours == theirs
    assert list(ours)[-1] == "i3" and set(ours["i3"].split(",")) == {"0"}
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert json.loads((tmp_path / "a.json").read_text()).keys() == set(ids)


def test_saliency_boxes_and_crops_equal_jax(tmp_path):
    imgs = [_product(120, 90, s) for s in range(4)]
    imgs.append(_img(60, 60, 9))  # a busy photo: no box
    for img in imgs:
        assert T.propose_box_saliency(img) == J.propose_box_saliency(img)
    assert T.propose_box_saliency(imgs[-1]) == []
    box = T.propose_box_saliency(imgs[0])[0]
    np.testing.assert_array_equal(T.yolo_box_crop(imgs[0], box),
                                  J.yolo_box_crop(imgs[0], box))
    dets = [(5.0, 7.0, 60.0, 80.0, "cell phone", 0.9),
            (1.0, 1.0, 20.0, 20.0, "person", 0.5)]
    for wl in (None, ["cell phone"], ["person"], ["cup"]):
        np.testing.assert_array_equal(
            T.crop_largest_detection(imgs[1], dets, wl),
            J.crop_largest_detection(imgs[1], dets, wl))
    assert T.CATE2YOLO_CLASS == J.CATE2YOLO_CLASS
    assert T.SALIENCY_CLASS == J.SALIENCY_CLASS

    src = tmp_path / "imgs"
    src.mkdir()
    cates = ["手机", "笔记本电脑", "not listed", "手机", "手机"]
    with open(tmp_path / "item_info.jsonl", "w", encoding="utf-8") as f:
        for i, (img, cate) in enumerate(zip(imgs, cates)):
            Image.fromarray(img).save(src / f"i{i}.jpg")
            f.write(json.dumps({"item_id": f"i{i}", "cate_name": cate},
                               ensure_ascii=False) + "\n")
        f.write(json.dumps({"item_id": "gone", "cate_name": "手机"}) + "\n")
    boxes = {"i1": [[2, 2, 80, 100, "laptop", 0.8]]}
    stats = {}
    for name, mod in (("a", T), ("b", J)):
        stats[name] = mod.crop_images_with_boxes(
            str(tmp_path / "item_info.jsonl"), str(src), str(tmp_path / name),
            boxes, 0.1, detector=mod.propose_box_saliency)
    assert stats["a"] == stats["b"]
    assert stats["a"]["missing"] == 1 and stats["a"]["copied"] >= 1 \
        and stats["a"]["cropped"] >= 3  # i2's category is not listed
    for i in range(5):
        assert (tmp_path / "a" / f"i{i}.jpg").read_bytes() == \
            (tmp_path / "b" / f"i{i}.jpg").read_bytes()


def test_broken_image_is_none_and_missing_pil_raises(tmp_path, monkeypatch):
    """Fault 2 of the reference: without Pillow, JAX's ``load_image``
    returns None for every image (each counts as broken); the port raises
    ``ImportError``.  A file that does not decode is None in both."""
    good = tmp_path / "good.jpg"
    Image.fromarray(_img(8, 8, 0)).save(good)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    for mod in (T, J):
        assert mod.load_image(str(bad)) is None
        assert mod.load_image(str(tmp_path / "missing.jpg")) is None
        assert mod.load_image(str(good)).shape == (8, 8, 3)

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    assert J.load_image(str(good)) is None  # the reference's fault
    with pytest.raises(ImportError, match="PIL"):
        T.load_image(str(good))


def test_nonfinite_embedding_text_matches_jax(tmp_path):
    """NaN, +inf and -inf are written as JAX's native formatter writes
    them (``json.dump``'s spelling), so the dump is JSON and the port's
    ``prepare --with_image`` reads it back, by its spans and by
    ``json.load``."""
    import argparse

    from item_alignment_torch import cli as tcli
    from item_alignment_torch.data import native_loader as TN
    from item_alignment_tpu.data import native_loader as JN

    m = np.array([[np.nan, np.inf, -np.inf, 1.5]], np.float32)
    ours = T.embedding_texts(m)
    assert JN.get_lib() is not None
    assert ours == JN.format_rows(m) == J.embedding_texts(m)
    assert ours == ["NaN,Infinity,-Infinity,1.5"]
    assert TN.format_rows_reference(m) == ours
    path = tmp_path / "image_embedding.json"
    T.write_embedding_json(["a"], ours, str(path))
    loaded = json.loads(path.read_text(encoding="utf-8"))
    assert np.isnan(loaded["a"][0]) and loaded["a"][1:] == [
        float("inf"), float("-inf"), 1.5]
    assert TN.read_embedding_spans(str(path)) == [("a", ours[0])]
    assert T.load_embedding_json(str(path)) == {"a": ours[0]}
    assert tcli._load_image_embedding(argparse.Namespace(
        output_dir=str(tmp_path))) == {"a": ours[0]}
