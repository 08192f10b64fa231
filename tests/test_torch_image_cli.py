"""``ia-torch``'s image commands vs ``ia-tpu``'s on the CPU:
``prepare --only_image`` (the shards), ``--only_image --object_detection``
(the crops), ``--with_image`` (the embedding dump through an NFNet tower)
and ``finetune-image``.

A corpus of 16 items in two whitelisted categories, each a product on a
plain background in a JPEG of 40-70 px a side, with train, valid and test
pairs.  The towers are built small in both packages (``BACKBONES``
patched): an NFNet of one stage for the dump, a ResNetV2 for the finetune.
Shards equal, crops byte for byte, dumped vectors within 1e-4 of max|ref|
and the TSVs' other columns equal; ``finetune-image`` from converted JAX
parameters at dropout 0 with gradient accumulation: each logged loss
within 1e-4 and the prediction file's rows within 1e-5 of max|ref| (the
two-tower head writes the towers' features as the pair's embeddings, in
both packages).
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from item_alignment_torch import cli as tcli
from item_alignment_torch.config import OptimizerConfig, TrainConfig
from item_alignment_torch.convert import state_dict_from_flax
from item_alignment_torch.data.datasets import ArrayDataset
from item_alignment_torch.data.prepare import read_tsv
from item_alignment_torch.engine.checkpoint import save_params
from item_alignment_torch.engine.train import Trainer
from item_alignment_torch.models import image as timg

pytest.importorskip("jieba")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from item_alignment_tpu import cli as jcli  # noqa: E402
from item_alignment_tpu.config import ModelConfig as JConfig  # noqa: E402
from item_alignment_tpu.data import native_loader  # noqa: E402
from item_alignment_tpu.models import image as jimg  # noqa: E402
from test_timm_import import TNFNet, _randomize  # noqa: E402

torch.set_num_threads(1)
NFNET = dict(depths=(1,), channels=(16,), group_size=8, stem_chs=16,
             feat_mult=1.0)
RESNET = dict(depths=(1,), width=8)
CATES = ("手机", "笔记本电脑")


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    """Leave torch's global generator as this module found it."""
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


@pytest.fixture(scope="module", autouse=True)
def tiny_towers():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jimg.BACKBONES, "nfnet", lambda c: jimg.NFNet(**NFNET))
        mp.setitem(timg.BACKBONES, "nfnet", lambda c: timg.NFNet(**NFNET))
        mp.setitem(jimg.BACKBONES, "resnet",
                   lambda c: jimg.ResNetV2(**RESNET))
        mp.setitem(timg.BACKBONES, "resnet",
                   lambda c: timg.ResNetV2(**RESNET))
        # JAX's --with_image reads image_embedding.json through its native
        # span scanner where it builds; the json.load path is the one the
        # port's text is equal to
        mp.setattr(native_loader, "read_embedding_spans", lambda path: None)
        yield


def _quiet(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0, argv
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_image_cli")
    raw = root / "raw"
    (raw / "item_images").mkdir(parents=True)
    rs = np.random.RandomState(0)
    with open(raw / "item_info.jsonl", "w", encoding="utf-8") as w:
        for i in range(16):
            h, wd = rs.randint(40, 71, 2)
            img = np.full((h, wd, 3), rs.randint(200, 256), np.uint8)
            y, x = rs.randint(0, h // 3), rs.randint(0, wd // 3)
            img[y:y + h // 2, x:x + wd // 2] = rs.randint(
                0, 120, (h // 2, wd // 2, 3))
            Image.fromarray(img).save(raw / "item_images" / f"i{i}.jpg")
            w.write(json.dumps({
                "item_id": f"i{i}", "cate_name": CATES[i % 2],
                "cate_id": f"c{i % 2}", "industry_name": "ind",
                "title": f"商品{i}", "item_pvs": "品牌#:#a#;#容量#:#b",
                "sku_pvs": "", "item_image_name": f"i{i}.jpg"},
                ensure_ascii=False) + "\n")
    for name, pairs in (("train", [(i, i + 1) for i in range(12)]),
                        ("valid", [(i, i + 3) for i in range(4)]),
                        ("test", [(i, i + 2) for i in range(10, 14)])):
        with open(raw / f"item_{name}_pair.jsonl", "w") as w:
            for k, (a, b) in enumerate(pairs):
                w.write(json.dumps({"src_item_id": f"i{a}",
                                    "tgt_item_id": f"i{b}",
                                    "item_label": str(k % 2)}) + "\n")
    (root / "tiny.json").write_text(json.dumps({"hidden_dropout_prob": 0.0}))
    return root


def _shards(main, corpus, out, *extra):
    return _quiet(main, ["prepare", "--data_dir", str(corpus / "raw"),
                         "--output_dir", str(out), "--only_image",
                         "--dtypes", "train,valid,test", "--image_size", "32",
                         "--shard_size", "5", "--seed", "3", *extra])[-1]


@pytest.fixture(scope="module")
def shards(corpus):
    return {"torch": _shards(tcli.main, corpus, corpus / "shards_t",
                             "--device", "cpu"),
            "jax": _shards(jcli.main, corpus, corpus / "shards_j")}


def test_prepare_only_image_shards_equal_jax(shards):
    ours, theirs = shards["torch"], shards["jax"]
    assert {k: len(v) for k, v in ours.items()} == {"train": 3, "valid": 1,
                                                    "test": 1}
    for split in ours:
        assert [Path(p).name for p in ours[split]] == \
            [Path(p).name for p in theirs[split]]
        for a, b in zip(ours[split], theirs[split]):
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files
                for k in x.files:
                    assert x[k].dtype == y[k].dtype
                    np.testing.assert_array_equal(x[k], y[k])
                assert x["images_1"].dtype == np.uint8 and x["transformed"]


class _FixedYolo(torch.nn.Module):
    """A stand-in for YOLOv5 weights: fixed [1, 2, 85] predictions, a
    cell phone and a laptop in letterboxed coordinates."""

    def __init__(self):
        super().__init__()
        pred = torch.zeros(1, 2, 85)
        pred[0, 0, :5] = torch.tensor([24.0, 26.0, 30.0, 28.0, 0.9])
        pred[0, 0, 5 + 67] = 0.9  # COCO80 "cell phone"
        pred[0, 1, :5] = torch.tensor([30.0, 30.0, 40.0, 44.0, 0.8])
        pred[0, 1, 5 + 63] = 0.9  # "laptop"
        self.pred = torch.nn.Parameter(pred, requires_grad=False)

    def forward(self, x):
        return self.pred


@pytest.mark.parametrize("source", ["boxes", "saliency", "none", "yolo"])
def test_object_detection_crops_equal_jax(corpus, tmp_path, source):
    extra = []
    if source == "yolo":
        torch.jit.script(_FixedYolo()).save(str(tmp_path / "yolo.pt"))
        extra = ["--yolo_weights", str(tmp_path / "yolo.pt"),
                 "--yolo_imgsz", "64"]
    elif source == "boxes":
        boxes = tmp_path / "boxes.jsonl"
        boxes.write_text("\n".join(json.dumps(
            {"item_id": f"i{i}", "boxes": [[2, 3, 30, 35, "cell phone", 0.9],
                                           [0, 0, 5, 5, "laptop", 0.8]]})
            for i in range(0, 16, 3)))
        extra = ["--boxes_file", str(boxes)]
    elif source == "none":
        extra = ["--detector", "none"]
    stats = {}
    for name, main in (("t", tcli.main), ("j", jcli.main)):
        argv = ["prepare", "--data_dir", str(corpus / "raw"), "--output_dir",
                str(tmp_path / name), "--only_image", "--object_detection",
                "--min_crop_ratio", "0.1", *extra]
        stats[name] = _quiet(main, argv + ["--device", "cpu"] if name == "t"
                             else argv)[-1]
        stats[name].pop("output_dir")
    assert stats["t"] == stats["j"]
    assert stats["t"]["cropped"] > 0 or source == "none"
    for i in range(16):
        a = tmp_path / "t" / "item_images_cropped" / f"i{i}.jpg"
        b = tmp_path / "j" / "item_images_cropped" / f"i{i}.jpg"
        assert a.read_bytes() == b.read_bytes()


def _with_image(main, corpus, out, *extra):
    return _quiet(main, ["prepare", "--data_dir", str(corpus / "raw"),
                         "--output_dir", str(out), "--with_image",
                         "--images_dir", str(corpus / "raw" / "item_images"),
                         "--cv_model_name", "eca_nfnet_l0", "--image_size",
                         "32", "--batch_size", "5", "--valid_proportion",
                         "0.25", *extra])[-1]


def _vectors(out):
    with open(out / "image_embedding.json", encoding="utf-8") as r:
        return {k: np.asarray(v, np.float32) for k, v in json.load(r).items()}


def _tsv_rows_close(ours, theirs):
    """The TSVs' text columns equal, their image columns within 1e-4."""
    for split in ("train", "valid", "test"):
        a, b = read_tsv(ours[split]), read_tsv(theirs[split])
        assert len(a) == len(b) > 0 and {len(r) for r in a} == {9}
        for ra, rb in zip(a, b):
            assert ra[:4] + ra[5:8] == rb[:4] + rb[5:8]
            for col in (4, 8):
                x = np.asarray(ra[col].split(","), np.float32)
                y = np.asarray(rb[col].split(","), np.float32)
                assert np.abs(x - y).max() <= 1e-4 * np.abs(y).max()


def test_with_image_dumps_through_a_timm_nfnet_as_jax_does(corpus, tmp_path):
    tm = TNFNet(NFNET["depths"], NFNET["channels"], 8, 16, 1.0)
    _randomize(tm, seed=3)
    torch.save(tm.state_dict(), tmp_path / "eca_nfnet_l0.bin")
    flags = ["--pretrained_model_path", str(tmp_path / "eca_nfnet_l0.bin")]
    ours = _with_image(tcli.main, corpus, tmp_path / "t", *flags,
                       "--device", "cpu")
    theirs = _with_image(jcli.main, corpus, tmp_path / "j", *flags)
    a, b = _vectors(tmp_path / "t"), _vectors(tmp_path / "j")
    assert a.keys() == b.keys() and len(a) == 16
    for k in a:
        assert a[k].shape == (16,)
        assert np.abs(a[k] - b[k]).max() <= 1e-4 * np.abs(b[k]).max()
    _tsv_rows_close(ours, theirs)
    # the file exists now: a second run reads it and dumps nothing
    again = _with_image(tcli.main, corpus, tmp_path / "t")
    assert read_tsv(again["train"]) == read_tsv(ours["train"])


def test_with_image_through_a_finetuned_tower_and_the_refusals(corpus,
                                                               tmp_path):
    kw = dict(model_name="eca_nfnet_l0", image_model_name="eca_nfnet_l0",
              interaction_type="two_tower")
    jm = jimg.ImageTwoTower(JConfig(**kw))
    x = jnp.zeros((1, 32, 32, 3))
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), x, x))
    (tmp_path / "img.msgpack").write_bytes(
        serialization.msgpack_serialize(tree["params"]))
    save_params(str(tmp_path / "best_f1.pt"), state_dict_from_flax(tree))
    _with_image(tcli.main, corpus, tmp_path / "t", "--finetuned",
                "--file_state_dict", str(tmp_path / "best_f1.pt"),
                "--device", "cpu")
    _with_image(jcli.main, corpus, tmp_path / "j", "--finetuned",
                "--file_state_dict", str(tmp_path / "img.msgpack"))
    a, b = _vectors(tmp_path / "t"), _vectors(tmp_path / "j")
    assert a.keys() == b.keys()
    for k in a:
        assert np.abs(a[k] - b[k]).max() <= 1e-4 * np.abs(b[k]).max()

    base = ["prepare", "--data_dir", str(corpus / "raw"), "--output_dir",
            str(tmp_path / "none"), "--with_image", "--device", "cpu"]
    with pytest.raises(SystemExit):  # random weights would poison the TSVs
        tcli.main(base)
    with pytest.raises(SystemExit):
        tcli.main(base + ["--finetuned"])
    # the JAX CLI's msgpack gives its vectors too; a malformed one raises
    _with_image(tcli.main, corpus, tmp_path / "tm", "--finetuned",
                "--file_state_dict", str(tmp_path / "img.msgpack"),
                "--device", "cpu")
    c = _vectors(tmp_path / "tm")
    assert c.keys() == b.keys()
    for k in c:
        assert np.abs(c[k] - b[k]).max() <= 1e-4 * np.abs(b[k]).max()
    (tmp_path / "bad.msgpack").write_bytes(b"\xc1")
    with pytest.raises(ValueError, match="bad.msgpack"):
        tcli.main(base + ["--finetuned", "--file_state_dict",
                          str(tmp_path / "bad.msgpack")])


def _finetune(main, corpus, shards, out, init, *extra):
    return _quiet(main, [
        "finetune-image", "--data_dir", str(corpus), "--output_dir", str(out),
        "--model_name", "resnet_tiny", "--config_file",
        str(corpus / "tiny.json"), "--shards", *shards["train"],
        "--valid_shards", *shards["valid"], "--image_size", "32",
        "--train_batch_size", "2", "--gradient_accumulation_steps", "2",
        "--learning_rate", "1e-3", "--warmup_proportion", "0", "--epochs",
        "2", "--log_steps", "1", "--scan_steps", "1", "--mesh", "1,1,1",
        "--file_state_dict", str(init), "--log_dir", str(out / "logs"),
        "--threshold", "0.4", *extra])


def _losses(log_dir):
    return [json.loads(line)["value"] for line in open(log_dir / "scalars.jsonl")
            if json.loads(line)["tag"] == "train/loss"]


def _embeds(path):
    """A prediction file's rows: the two towers' features, which the
    two-tower head hands on as the pair's embeddings, as [n, 2, F]."""
    rows = [json.loads(line) for line in open(path)]
    return np.array([[np.asarray(r[k].strip("[]").split(","), np.float32)
                      for k in ("src_item_emb", "tgt_item_emb")]
                     for r in rows])


def _close(ours, theirs, tol=1e-5):
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= tol * np.abs(theirs).max()


def test_finetune_image_matches_jax(corpus, shards, tmp_path):
    """Train (2 epochs, batches of 2, 2 batches an update), evaluate and
    predict from the same converted parameters, then p5's prediction alone
    from each package's best_f1 file."""
    kw = dict(model_name="resnet_tiny", image_model_name="resnet_tiny",
              interaction_type="two_tower")
    jm = jimg.ImageTwoTower(JConfig(**kw))
    x = jnp.zeros((1, 32, 32, 3))
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(2), x, x))
    (tmp_path / "init.msgpack").write_bytes(
        serialization.msgpack_serialize(tree["params"]))
    save_params(str(tmp_path / "init.pt"), state_dict_from_flax(tree))
    run = "resnet_tiny-v1-two_tower-cls-NA-ce"
    ours = _finetune(tcli.main, corpus, shards["torch"], tmp_path / "t",
                     tmp_path / "init.pt", "--do_train", "--do_eval",
                     "--do_pred", "--device", "cpu")
    theirs = _finetune(jcli.main, corpus, shards["jax"], tmp_path / "j",
                       tmp_path / "init.msgpack", "--do_train", "--do_eval",
                       "--do_pred")
    la, lb = _losses(tmp_path / "t" / "logs"), _losses(tmp_path / "j" / "logs")
    assert len(la) == len(lb) == 12  # 6 batches of 2 an epoch, 2 epochs
    np.testing.assert_allclose(la, lb, atol=1e-4)
    assert ours[0]["best"]["epoch"] == theirs[0]["best"]["epoch"]
    pa, pb = (_embeds(o[-1]["prediction_file"]) for o in (ours, theirs))
    assert Path(ours[-1]["prediction_file"]).name == \
        "deepAI_result_threshold=0.4.jsonl"
    assert pa.shape == (12, 2, 32)
    _close(pa, pb)
    for name in ("best_f1.pt", "image_finetune_epoch-2.pt"):
        assert (tmp_path / "t" / run / name).is_file()

    # predict.sh p5: --do_pred alone on the test shards from best_f1
    pred = {}
    for key, main, best, dev in (
            ("t", tcli.main, "best_f1.pt", ["--device", "cpu"]),
            ("j", jcli.main, "best_f1.msgpack", [])):
        out = tmp_path / f"p5{key}"
        out.mkdir()
        pred[key] = _embeds(_quiet(main, [
            "finetune-image", "--data_dir", str(corpus), "--output_dir",
            str(out), "--model_name", "resnet_tiny", "--shards",
            *shards["torch" if key == "t" else "jax"]["test"],
            "--image_size", "32", "--train_batch_size", "3",
            "--interaction_type", "two_tower", "--threshold", "0.4",
            "--do_pred", "--mesh", "1,1,1", "--file_state_dict",
            str(tmp_path / key / run / best), *dev])[-1]["prediction_file"])
    assert len(pred["t"]) == 4
    _close(pred["t"], pred["j"])


def test_trainer_hands_the_model_uint8_images():
    """Fault 3 of the first port: the Trainer cast every non-float array
    with ``.long()``, so uint8 images reached the model as int64 (8x the
    bytes) and skipped the towers' uint8 normalisation."""
    seen = []

    class Spy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.head = torch.nn.Linear(1, 1)

        def forward(self, images_1, images_2, labels, deterministic=True,
                    dropout_seed=None):
            seen.append((images_1.dtype, images_2.dtype, labels.dtype))
            x = images_1.float().mean().reshape(1, 1)
            return {"loss": self.head(x).sum()}

    ds = ArrayDataset({
        "images_1": np.zeros((4, 8, 8, 3), np.uint8),
        "images_2": np.zeros((4, 8, 8, 3), np.uint8),
        "labels": np.array([0, 1, 0, 1], np.int32)})
    trainer = Trainer(Spy(), TrainConfig(
        train_batch_size=2, num_epochs=1, log_steps=100,
        optimizer=OptimizerConfig(total_steps=2)), device="cpu")
    trainer.fit(ds)
    assert seen == [(torch.uint8, torch.uint8, torch.int64)] * 2
