"""Rules of the port: it imports no JAX, no transformers and nothing of
the JAX package, calls jieba only inside its two segmenters, points every
part not yet ported at an open ROADMAP item, and its entry points run on
cuda unless asked for the CPU."""

import ast
import json
import pathlib
import re

import pytest
import torch

from item_alignment_torch.aggregate.soup import load_state_dicts
from item_alignment_torch.config import ModelConfig, TrainConfig
from item_alignment_torch.engine.inference import TwoTowerInference
from item_alignment_torch.engine.train import Trainer
from item_alignment_torch.kge import KGETrainer, KnowledgeGraph, make_kge_model
from item_alignment_torch.models.bert_legacy import (
    BertAlignModel,
    BertForPretraining,
)
from item_alignment_torch.models.graph import GCNTwoTower
from item_alignment_torch.models.image import ImageTwoTower
from item_alignment_torch.models.multimodal import (
    CoCaForItemAlignment,
    CoCaForPretraining,
    RobertaImageOneTower,
    RobertaImageTwoTower,
)
from item_alignment_torch.models.text import (
    PKGMOneTower,
    PKGMTwoTower,
    RobertaBackbone,
    RobertaOneTower,
    RobertaTwoTower,
    TextCNNTwoTower,
)
from item_alignment_torch.ops.sparse import Adjacency

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "transformers", "item_alignment_tpu")
SEGMENTERS = {"item_alignment_torch/data/tokenization.py": "segment_pvs",
              "item_alignment_torch/data/prepare.py": "segment_title",
              # the smoke run's stand-in where the card has no jieba
              "chip_smoke.py": "segmenter"}
TINY = ModelConfig(vocab_size=50, hidden_size=32, num_hidden_layers=1,
                   num_attention_heads=1, intermediate_size=32,
                   max_position_embeddings=32)
IMAGE_TINY = TINY.replace(model_name="roberta_image", ensemble="begin",
                          image_hidden_size=8)
COCA_TINY = TINY.replace(model_name="coca", num_attention_heads=4,
                         image_size=32, patch_size=16, multimodal_depth=1,
                         coca_heads=4)
PKGM_TINY = TINY.replace(model_name="pkgm", max_seq_len=4, max_seq_len_pv=None,
                         max_pvs=2, num_entities=8, num_relations=3,
                         kg_embedding_dim=16)


@pytest.fixture(scope="module", autouse=True)
def _keep_torch_rng():
    """Leave torch's global generator as this module found it: building a
    model draws from it (``nn.Embedding``'s own init), and a later test
    file in the same worker may draw weights from it."""
    state = torch.random.get_rng_state()
    yield
    torch.random.set_rng_state(state)


def _port_sources():
    files = sorted((ROOT / "item_alignment_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"item_alignment_torch/ops/cuda_attention_blockwise.py",
            "item_alignment_torch/utils/hf_import.py",
            "item_alignment_torch/engine/checkpoint.py",
            "item_alignment_torch/cli.py",
            "item_alignment_torch/data/wordpiece.py",
            "item_alignment_torch/kge/train.py",
            "item_alignment_torch/models/multimodal.py",
            "item_alignment_torch/data/images.py",
            "item_alignment_torch/aggregate/ensemble.py",
            "item_alignment_torch/aggregate/soup.py",
            "item_alignment_torch/aggregate/submit.py",
            "item_alignment_torch/models/bert_legacy.py",
            "item_alignment_torch/engine/adversarial.py",
            "item_alignment_torch/data/bert_data.py",
            "item_alignment_torch/models/image.py",
            "item_alignment_torch/utils/timm_import.py",
            "item_alignment_torch/data/yolo.py",
            "item_alignment_torch/ops/sparse.py",
            "item_alignment_torch/models/graph.py",
            "item_alignment_torch/utils/flax_msgpack.py",
            "item_alignment_torch/data/native_loader.py",
            "item_alignment_torch/utils/flops.py",
            "item_alignment_torch/pipeline/synth_corpus.py"} <= names
    bad = {f"{p.relative_to(ROOT)}: {name}" for p in files
           for name in _imported_roots(p) if name in FORBIDDEN}
    assert not bad, sorted(bad)


def test_pipeline_scripts_name_no_jax():
    """The port's pipeline scripts name neither the JAX package nor JAX nor
    a ``.msgpack`` path, p8 packages through the port's submit module, and
    the scripts ship as package data."""
    import tomllib

    scripts = sorted((ROOT / "item_alignment_torch" / "pipeline").glob(
        "*.sh"))
    assert [p.name for p in scripts] == ["predict.sh", "rehearsal.sh",
                                         "train.sh"]
    for path in scripts:
        text = path.read_text()
        for word in ("item_alignment_tpu", "jax", ".msgpack"):
            assert word not in text.lower(), (path.name, word)
    assert "from item_alignment_torch.aggregate.submit import" in (
        scripts[0].read_text())
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert "pipeline/*.sh" in data["tool"]["setuptools"]["package-data"][
        "item_alignment_torch"]


def test_jieba_only_inside_the_segmenters():
    """jieba is imported at call time, inside ``segment_pvs`` and
    ``segment_title`` alone in the package (the card may not have it)."""
    found = {}

    def visit(node, where, path):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in child.names] + [
                    getattr(child, "module", None) or ""]
                if any(n.split(".")[0] == "jieba" for n in names):
                    found.setdefault(path, set()).add(where)
            inner = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.ClassDef)) else where
            visit(child, inner, path)

    for path in _port_sources():
        visit(ast.parse(path.read_text(), str(path)), "<module>",
              str(path.relative_to(ROOT)))
    assert found == {k: {v} for k, v in SEGMENTERS.items()}


def _roadmap_items():
    """{(queue, number): bold title} of the open items of ROADMAP.md."""
    text = (ROOT / "ROADMAP.md").read_text()
    items, queue = {}, None
    for line in text.splitlines():
        m = re.match(r"### Queue (\d+)", line)
        if m:
            queue = int(m.group(1))
        m = re.match(r"(\d+)\. \*\*(.+?)\*\*", line)
        if m and queue and not m.group(2).startswith("Done"):
            items[(queue, int(m.group(1)))] = m.group(2).rstrip(".")
    return items


ITEM_REF = re.compile(r"ROADMAP Queue (\d+) #(\d+): ([^)]+?)(?:\)|$)")


def _strings(tree):
    """Every string constant of a module (implicit concatenations joined by
    the parser, f-strings by their literal parts), whitespace collapsed."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield " ".join(node.value.split())
        elif isinstance(node, ast.JoinedStr):
            yield " ".join("".join(
                v.value for v in node.values
                if isinstance(v, ast.Constant)).split())


def _check_item(queue, number, title, items):
    key = (int(queue), int(number))
    assert key in items, f"ROADMAP Queue {queue} #{number} is not open"
    assert items[key].lower().startswith(title.strip().rstrip(".").lower()), \
        (title, items[key])


def test_every_not_ported_raise_names_an_open_roadmap_item():
    """Each ``raise NotImplementedError`` of the port names a ROADMAP item
    as "ROADMAP Queue N #M: Title", and each such item is still listed, with
    that title, and not done.  Parallelism (Queue 1 #4) is ported: it is
    done and nothing cites it."""
    items = _roadmap_items()
    assert (1, 4) not in items
    cited = set()
    for path in _port_sources():
        text = path.read_text()
        tree = ast.parse(text, str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and isinstance(node.exc, ast.Call) \
                    and getattr(node.exc.func, "id", "") == "NotImplementedError":
                seg = ast.get_source_segment(text, node)
                assert "ROADMAP" in seg or "_ITEM" in seg or "item" in seg, \
                    f"{path.name}: {seg}"
        for string in _strings(tree):
            for m in ITEM_REF.finditer(string):
                _check_item(*m.groups(), items)
                cited.add((int(m.group(1)), int(m.group(2))))
    assert (1, 4) not in cited


def test_cli_raises_name_open_roadmap_items(tmp_path):
    """Every ``ia-torch`` command is ported (a ``cmd_*`` function of
    ``cli.py``).  ``--distributed`` is too: in a process group of one
    (gloo), each of the four command lines below gets past the group and
    fails only on its missing input file, with no ``NotImplementedError``."""
    import torch.distributed as dist

    from item_alignment_torch import cli
    from item_alignment_torch.parallel.dryrun import free_port

    items = _roadmap_items()
    assert all(fn.__module__ == cli.__name__ and fn.__name__.startswith(
        "cmd_") for fn in cli.COMMANDS.values()), cli.COMMANDS
    assert {"build-graph", "finetune-graph", "coca-pretrain"} <= set(
        cli.COMMANDS)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]",
                                 "[MASK]"]))
    (tmp_path / "tiny.json").write_text(json.dumps(
        {"hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 1,
         "intermediate_size": 8, "max_position_embeddings": 16}))
    calls = [["finetune-text", "--data_dir", str(tmp_path), "--vocab_path",
              str(tmp_path), "--device", "cpu", "--output_dir",
              str(tmp_path / "out"), "--config_file",
              str(tmp_path / "tiny.json"), "--do_train", "--distributed"]]
    # the legacy member's and CoCa's trainers on a mesh
    calls += [["finetune-bert", "--train_file", str(tmp_path / "t.jsonl"),
               "--vocab_path", str(tmp_path), "--device", "cpu",
               "--distributed"],
              ["bert-pretrain", "--item_info", str(tmp_path / "i.jsonl"),
               "--vocab_path", str(tmp_path), "--output_dir",
               str(tmp_path / "pre"), "--device", "cpu", "--distributed"],
              ["coca-pretrain", "--shards", str(tmp_path / "s.npz"),
               "--output_dir", str(tmp_path / "coca"), "--device", "cpu",
               "--distributed"]]
    assert len(calls) == 1 + 3
    group = ["--coordinator_address", f"127.0.0.1:{free_port()}",
             "--num_processes", "1", "--process_id", "0"]
    try:
        for argv in calls:
            with pytest.raises(FileNotFoundError) as e:
                cli.main(argv + group)
            assert dist.is_initialized() and dist.get_world_size() == 1
            assert str(tmp_path) in str(e.value), (argv, str(e.value))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not any(ITEM_REF.search(s) for s in _strings(ast.parse(
        pathlib.Path(cli.__file__).read_text())))
    # an image two-tower is finetune-image's, not finetune-text's
    with pytest.raises(ValueError, match="finetune-image"):
        cli.main(["finetune-text", "--data_dir", str(tmp_path),
                  "--vocab_path", str(tmp_path), "--device", "cpu",
                  "--model_name", "nfnet_l0"])


def test_msgpack_parameter_file_raises_with_the_roadmap_item(tmp_path):
    """The port reads the JAX CLI's Flax msgpack files; a malformed one
    raises a ValueError that names the file instead of loading garbage."""
    from item_alignment_torch import cli

    (tmp_path / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "<S>"]))
    (tmp_path / "info.jsonl").write_text("\n".join(json.dumps(
        {"item_id": i, "cate_name": "c", "title": "a", "item_pvs": ""})
        for i in ("x", "y")) + "\n")
    (tmp_path / "pairs.jsonl").write_text(json.dumps(
        {"src_item_id": "x", "tgt_item_id": "y"}) + "\n")
    (tmp_path / "tiny.json").write_text(json.dumps(
        {"hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 1,
         "intermediate_size": 8, "max_position_embeddings": 16}))
    path = tmp_path / "best_f1.msgpack"
    path.write_bytes(b"\x81\xa6params\xc1")
    with pytest.raises(ValueError, match=re.escape(str(path))) as e:
        cli.main(["mine", "--item_info", str(tmp_path / "info.jsonl"),
                  "--pairs", str(tmp_path / "pairs.jsonl"), "--output",
                  str(tmp_path / "out.jsonl"), "--vocab_path", str(tmp_path),
                  "--config_file", str(tmp_path / "tiny.json"),
                  "--max_seq_len", "2", "--max_seq_len_pv", "2",
                  "--num_workers", "0", "--device", "cpu",
                  "--file_state_dict", str(path)])
    assert "not a Flax msgpack file" in str(e.value)
    assert not (tmp_path / "out.jsonl").exists()


def test_kernel_source_ships_with_the_package():
    from item_alignment_torch.ops import _build

    for source in ("fused_attention.cu", "flash_blockwise_fwd.cu",
                   "flash_blockwise_bwd.cu", "layer_norm.cu", "adamw.cu",
                   "attention_common.cuh", "attention_f32.cuh",
                   "hopper_common.cuh"):
        assert (ROOT / "item_alignment_torch" / "csrc" / source).is_file()
    # kernel #2's contract runs on the forward of flash_blockwise_fwd.cu and
    # #3's on the dQ and dK/dV kernels of flash_blockwise_bwd.cu; their own
    # sources are gone
    for gone in ("attention_dropout_fwd.cu", "attention_dropout_bwd.cu"):
        assert not (ROOT / "item_alignment_torch" / "csrc" / gone).exists()
    # ops/_build.py names exactly the five sources
    assert sorted(_build.SOURCES) == ["adamw", "flash_blockwise_bwd",
                                      "flash_blockwise_fwd", "fused_attention",
                                      "layer_norm"]
    assert {f"{name}.cu" for name in _build.SOURCES} == {
        p.name for p in _build.CSRC.glob("*.cu")}


def test_native_loader_source_ships_with_the_package():
    """``csrc/ia_data.cpp`` is the port's own copy of the JAX loader's four
    C functions, shipped as package data (the root ``native/`` directory is
    not installed), and host code, not a kernel: ``_build`` does not build
    it."""
    import tomllib

    from item_alignment_torch.data import native_loader
    from item_alignment_torch.ops import _build

    source = ROOT / "item_alignment_torch" / "csrc" / "ia_data.cpp"
    assert native_loader.SOURCE == source and source.is_file()
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())
    assert "csrc/*.cpp" in data["tool"]["setuptools"]["package-data"][
        "item_alignment_torch"]
    text = source.read_text()
    for fn in ("tsv_index", "format_float_rows", "emb_json_spans",
               "count_char"):
        assert f"int64_t {fn}(" in text
    assert "ia_data" not in _build.SOURCES
    assert native_loader.BUILD_DIR == ROOT / "build" / "native"


def test_kernels_are_built_at_first_use_not_at_import(monkeypatch, tmp_path):
    """Importing the port builds nothing and needs no nvcc; a launch where
    there is no nvcc raises instead of falling back."""
    from item_alignment_torch.ops import _build, adamw
    from item_alignment_torch.ops import cuda_attention_blockwise as cab
    from item_alignment_torch.ops import layer_norm

    assert not _build._LIBS
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    q = torch.zeros(1, 520, 1, 32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cab._launch_fwd(0.0, 0, q, q, q, None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cab._launch_dq(0.0, 0, q, q, q, None, q, q, q)
    x = torch.zeros(4, 32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        layer_norm.launch_fwd(x, x[0], None, 1e-5, torch.float32, True)
    assert layer_norm.FWD_LAUNCHES == 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        adamw.launch([x], [x], [x], [x], [False], [True], 1e-3, 0.9, 0.98,
                     1e-8, 0.0, 1)
    assert (adamw.LAUNCHES, adamw.TENSORS) == (0, 0)


def _kge_npz(tmp: pathlib.Path) -> str:
    """A ``kge_final.npz`` of a tiny PKGM model, written on the CPU."""
    path = str(tmp / "kge_final.npz")
    KGETrainer(make_kge_model("pkgm", 8, 3, 4), KnowledgeGraph(
        [1, 2], [0, 1], [3, 4], 8, 3), batch_size=2, n_epochs=1,
        device="cpu").save(path)
    return path


def _cli(argv):
    from item_alignment_torch import cli

    return cli.main(argv)


@pytest.mark.parametrize("build", [
    lambda tmp: RobertaOneTower(TINY),
    lambda tmp: RobertaTwoTower(TINY),
    lambda tmp: RobertaBackbone(TINY),
    lambda tmp: TwoTowerInference(lambda b: b, lambda s, t: s),
    lambda tmp: Trainer(torch.nn.Linear(2, 2), TrainConfig()),
    lambda tmp: PKGMOneTower(PKGM_TINY),
    lambda tmp: PKGMTwoTower(PKGM_TINY.replace(interaction_type="two_tower")),
    lambda tmp: KGETrainer(make_kge_model("pkgm", 8, 3, 4), KnowledgeGraph(
        [1, 2], [0, 1], [3, 4], 8, 3), batch_size=2, n_epochs=1),
    lambda tmp: KGETrainer.load(_kge_npz(tmp)),
    lambda tmp: RobertaImageOneTower(IMAGE_TINY),
    lambda tmp: RobertaImageTwoTower(IMAGE_TINY.replace(
        interaction_type="two_tower")),
    lambda tmp: load_state_dicts([]),
    lambda tmp: BertAlignModel(TINY.replace(model_name="bert_legacy")),
    lambda tmp: BertForPretraining(TINY.replace(model_name="bert_legacy",
                                                type_vocab_size=5)),
    lambda tmp: TextCNNTwoTower(TINY.replace(model_name="textcnn",
                                             num_filters=4)),
    lambda tmp: ImageTwoTower(TINY.replace(model_name="vit_tiny",
                                           image_model_name="vit_tiny",
                                           image_size=32, patch_size=16)),
    lambda tmp: _cli(["prepare", "--data_dir", str(tmp), "--output_dir",
                      str(tmp / "o"), "--only_image"]),
    lambda tmp: _cli(["finetune-image", "--data_dir", str(tmp),
                      "--model_name", "eca_nfnet_l0", "--shards", "x.npz"]),
    lambda tmp: GCNTwoTower(TINY.replace(model_name="gcn", gcn_hidden=8,
                                         gcn_feature_dim=4)),
    lambda tmp: CoCaForPretraining(COCA_TINY),
    lambda tmp: CoCaForItemAlignment(COCA_TINY.replace(ensemble="sum")),
    lambda tmp: _cli(["finetune-graph", "--feature_matrix", "f.npy",
                      "--edges", "e.npz", "--train_pairs", "p.jsonl"]),
    lambda tmp: _cli(["coca-pretrain", "--shards", "s.npz",
                      "--output_dir", str(tmp)]),
    lambda tmp: Adjacency([[0], [0]], [1.0], 1),
])
def test_entry_points_default_to_cuda(build, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(tmp_path)


def test_entry_points_run_on_cpu_when_asked():
    model = RobertaOneTower(TINY, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
