"""Command-line interface of the port, ``ia-torch``.

    ia-torch <command> [flags]        (or python -m item_alignment_torch.cli)

Port of ``item_alignment_tpu/cli.py`` for the main path:

- ``prepare``        item_info / pair jsonl -> KG files and finetune TSVs;
  with ``--with_image``, the 9-column TSVs from ``<output_dir>/
  image_embedding.json``, dumped first through an image tower when it does
  not exist; ``--only_image`` writes image-pair shards, and with
  ``--object_detection`` the detection-guided crops instead;
- ``finetune-text``  RoBERTa and PKGM, one-tower and two-tower: train,
  eval, predict (PKGM takes ``--entity2id``/``--relation2id`` and merges
  ``pkgm_model.bin`` beside ``pytorch_model.bin``);
- ``finetune-multimodal``  RobertaImage one-tower and two-tower on the
  9-column TSVs (``--ensemble begin|end|sum``), or CoCa (``--model_name
  coca_*`` with ``--images_dir``, ``--ensemble sum|cross_attn``, from a
  ``coca-pretrain`` file): train, eval, predict;
- ``finetune-image`` the image two-tower (ViT, ResNetV2, NFNet) on the
  image-pair shards, from a timm state dict (``--pretrained_model_path``):
  train, eval, predict;
- ``mine``           encode each item once, score a candidate-pair list
  against the cache (``--quant int8``, ``--cache_quant int8``);
- ``pred-text``      the pooled entity-feature matrix for the GCN;
- ``pkgm-pretrain``  KGE pretraining on the KG files (``kge/``), writing
  ``kge_final.npz``;
- ``build-graph``    the GCN's inputs on the host: the normalised,
  dst-sorted item/attribute edge list and its transpose (``edges.npz``)
  and the two pair files;
- ``finetune-graph`` GCNII (``models/graph.py``) over the whole graph,
  Adam, one step a pair batch: ``gcn_params.pt``;
- ``coca-pretrain``  CoCa caption + contrastive pretraining on ``.npz``
  shards of text and images: ``coca_pretrain.pt``;
- ``ensemble``       fuse the members' prediction files (threshold or f1
  strategy, optional category split) into ``deepAI_result.jsonl``;
- ``model-soup``     average ``.pt`` parameter files (``aggregate/soup.py``).
- ``finetune-bert``  the legacy 5-field ``BertAlignModel`` from jsonl pair
  rows, with FREE/PGD/MIX embedding noise (``--adversarial``), from
  ``bert_pretrain.pt`` (``--pretrained_model_path``): writes
  ``bert_align.pt``, ``sim_eval_weight.npz`` and ``best_f1.pt``;
- ``bert-pretrain``  the structure-aware MLM + NSP pretrain of
  ``BertForPretraining`` on ``item_info.jsonl``: writes
  ``bert_pretrain.pt``;
- ``pred-bert``      ``BertAlignModel``'s P(same) for jsonl pair rows, in
  the submission format (no fallback: a failed kernel raises).

``finetune-text --model_name textcnn`` trains the TextCNN two-tower on the
two-tower layout.

Flags are the JAX CLI's, so the same command lines run, with one more:
``--device {cuda,cpu}`` (default ``cuda``; without a GPU the default
raises).  The port writes ``.pt`` state
dicts (``best_f1.pt``, ``text_finetune_epoch-N.pt``,
``multimodal_finetune_epoch-N.pt``, ``image_finetune_epoch-N.pt``,
``bert_align.pt``, ``bert_pretrain.pt``, ``gcn_params.pt``,
``coca_pretrain.pt``) and reads them or the JAX CLI's Flax ``.msgpack``
files wherever the JAX CLI reads one (``engine/checkpoint.load_params``).
``--scan_steps K`` groups training into chunks of K steps, one batch
transfer a chunk, with the loss logged and evaluations run at chunk ends,
as in the JAX CLI; ``pred-text --scan_chunks K`` encodes K batches a host
transfer, and ``--xfer_guard`` makes a synchronizing host-to-device copy
inside its encode loop an error.

Parallelism runs one process per device (``parallel/``): launch the
command in each process with ``torchrun --nproc_per_node N`` or with
``--distributed --coordinator_address host:port --num_processes N
--process_id i``, and give ``--mesh data,fsdp,tensor`` (the finetune and
engine commands, and ``pkgm-pretrain``, whose ``--mesh`` shards the triple
batches over ``data``).  The processes join over NCCL on ``--device cuda``
and gloo on ``--device cpu``; every rank evaluates and predicts, and rank 0
writes the files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from item_alignment_torch.config import (
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    TrainConfig,
)
from item_alignment_torch.device import resolve_device, transfer_guard
from item_alignment_torch.parallel.mesh import (
    maybe_initialize_distributed_from_args,
)
from item_alignment_torch.utils import logger
from item_alignment_torch.utils.retry import retry_transient

SCAN_STEPS = ("train steps a chunk: its batches go to the device in one "
              "transfer, and its last loss is logged when it crosses a "
              "multiple of --log_steps; 1 = per step")


def run_dir_name(args) -> str:
    """Reference run-dir naming (finetune_text.py:373): the reference's
    ``classification_method`` string embeds the cls-layer selection (e.g.
    ``cls_1,2,3,4_cat``), which this CLI splits into --cls_layers/--cls_pool,
    so it is recomposed here."""
    sim = args.similarity_measure or "NA"
    if getattr(args, "ensemble", None):
        sim = args.ensemble
    cls = args.classification_method
    layers = getattr(args, "cls_layers", "1")
    if cls == "cls" and layers and layers != "1":
        cls = f"cls_{layers}_{getattr(args, 'cls_pool', 'cat')}"
    return (f"{args.model_name}-{args.data_version}-{args.interaction_type}-"
            f"{cls}-{sim}-{args.loss_type}")


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (the CPU runs the kernels' "
                        "plain versions)")


def _common_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default="output")
    p.add_argument("--model_name", default="roberta_base")
    p.add_argument("--data_version", default="v1")
    p.add_argument("--config_file", default=None,
                   help="reference-style JSON model config")
    p.add_argument("--pretrained_model_path", default=None,
                   help="HF dir with pytorch_model.bin")
    p.add_argument("--file_state_dict", default=None,
                   help="parameters to evaluate or predict with (.pt or "
                        ".msgpack)")
    p.add_argument("--interaction_type", default="one_tower",
                   choices=["one_tower", "two_tower"])
    p.add_argument("--classification_method", default="cls",
                   choices=["cls", "vec_sim"])
    p.add_argument("--similarity_measure", default=None)
    p.add_argument("--loss_type", default="ce",
                   choices=["ce", "bce", "cosine", "hinge", "euclidean"])
    p.add_argument("--loss_margin", type=float, default=0.0)
    p.add_argument("--cls_layers", default="1")
    p.add_argument("--cls_pool", default="cat", choices=["cat", "avg"])
    p.add_argument("--auxiliary_task", action="store_true")
    p.add_argument("--max_seq_len", type=int, default=50)
    p.add_argument("--max_seq_len_pv", type=int, default=205)
    p.add_argument("--max_pvs", type=int, default=30)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--total_steps", type=int, default=None,
                   help="LR-schedule horizon in optimizer updates (default: "
                        "steps_per_epoch*epochs/grad_accum)")
    p.add_argument("--log_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=2345)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--eval_every_steps", type=int, default=None,
                   help="step-based mid-epoch eval cadence")
    p.add_argument("--scan_steps", type=int, default=8, help=SCAN_STEPS)
    p.add_argument("--early_stopping_patience", type=int, default=None,
                   help="stop after N evals without best-F1 improvement")
    p.add_argument("--checkpoint_dir", default=None,
                   help="dir for full train-state checkpoints "
                        "(params+optimizer+step); saved per epoch")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest full train state from "
                        "--checkpoint_dir before training")
    p.add_argument("--parameters_to_freeze", default=None,
                   help="JSON file (or inline JSON list) of parameter-path "
                        "patterns to freeze, matched as substrings of the "
                        "'/'-joined Flax parameter path")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="int8 path for the encoder's dense projections "
                        "(an inference knob for --do_eval/--do_pred runs)")
    p.add_argument("--fuse_qkv", action="store_true",
                   help="one [3H, H] q/k/v projection per encoder layer "
                        "instead of three; the same parameters")
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder layers in the backward")
    p.add_argument("--remat_policy", default="dots",
                   choices=["dots", "full", "mlp"])
    p.add_argument("--opt_state_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="AdamW moment storage dtype (fp32 arithmetic)")
    _distributed_flags(p)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--mesh", default="-1,1,1",
                   help="data,fsdp,tensor axis sizes (-1 = rest), one "
                        "process per device")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_pred", action="store_true")
    p.add_argument("--log_dir", default=None,
                   help="write JSONL scalars + CSV eval results here")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of training here")
    p.add_argument("--pred_with_best", action="store_true",
                   help="predict with the best-F1 epoch's parameters")
    _device_flag(p)


def _distributed_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--distributed", action="store_true",
                   help="join a process group (one process per device) "
                        "before training; without the three flags below, "
                        "torchrun's environment")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def _engine_flags(p: argparse.ArgumentParser) -> None:
    """The engine flags of the commands without the finetune flag surface
    (``finetune-bert``, ``bert-pretrain``), as the JAX CLI's."""
    p.add_argument("--mesh", default="-1,1,1",
                   help="data,fsdp,tensor axis sizes (-1 = rest), one "
                        "process per device")
    _distributed_flags(p)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--log_steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=2345)
    p.add_argument("--eval_every_steps", type=int, default=None)
    p.add_argument("--scan_steps", type=int, default=8, help=SCAN_STEPS)
    p.add_argument("--early_stopping_patience", type=int, default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--total_steps", type=int, default=None,
                   help="LR-schedule horizon in optimizer updates")
    _device_flag(p)


def _legacy_config(args, **kw) -> ModelConfig:
    """The legacy member's config: ``--config_file`` with ``kw`` over it,
    else the defaults (roberta_base's widths)."""
    kw = dict(model_name="bert_legacy", **kw)
    if args.config_file:
        return ModelConfig.from_json(args.config_file, **kw)
    return ModelConfig(**kw)


def _read_jsonl(path: str) -> list:
    with open(path, encoding="utf-8") as r:
        return [json.loads(line) for line in r if line.strip()]


def _model_config(args, **extra) -> ModelConfig:
    if getattr(args, "quant", None) and getattr(args, "do_train", False):
        raise SystemExit(
            "--quant int8 is an inference knob (quantize AFTER finetuning): "
            "round() has zero gradient almost everywhere, so training would "
            "silently stop learning. Drop --quant for --do_train runs.")
    kw = dict(
        model_name=args.model_name,
        interaction_type=args.interaction_type,
        classification_method=args.classification_method,
        similarity_measure=args.similarity_measure or "softmax",
        loss_type=args.loss_type, loss_margin=args.loss_margin,
        cls_layers=tuple(int(i) for i in args.cls_layers.split(",")),
        cls_pool=args.cls_pool, auxiliary_task=args.auxiliary_task,
        max_seq_len=args.max_seq_len, max_seq_len_pv=args.max_seq_len_pv,
        max_pvs=args.max_pvs, dtype="bfloat16" if args.bf16 else "float32",
        remat=args.remat, remat_policy=args.remat_policy,
        quant=getattr(args, "quant", None),
        fuse_qkv=getattr(args, "fuse_qkv", False),
    )
    kw.update(extra)
    return _config_for(args, **kw)


def _config_for(args, **kw) -> ModelConfig:
    """``--config_file`` with ``kw`` over it, else the named preset."""
    if args.config_file:
        return ModelConfig.from_json(args.config_file, **kw)
    if "large" in args.model_name:
        return ModelConfig.roberta_large().replace(**kw)
    return ModelConfig(**kw)


def _freeze_patterns(args) -> tuple:
    spec = getattr(args, "parameters_to_freeze", None)
    if not spec:
        return ()
    if os.path.exists(spec):
        with open(spec, encoding="utf-8") as r:
            return tuple(json.load(r))
    return tuple(json.loads(spec))


def _train_config(args, steps_per_epoch: int,
                  batch_size: Optional[int] = None) -> TrainConfig:
    """The finetune flags' TrainConfig; with ``batch_size`` (the commands
    of ``_engine_flags``, which have no batch-size, freeze or moment-dtype
    flags of their own) that batch for training and evaluation, as in the
    JAX CLI."""
    data, fsdp, tensor = (int(x) for x in args.mesh.split(","))
    return TrainConfig(
        seed=args.seed,
        train_batch_size=batch_size or args.train_batch_size,
        eval_batch_size=batch_size or args.eval_batch_size,
        num_epochs=args.epochs, log_steps=args.log_steps,
        output_dir=args.output_dir, threshold=getattr(args, "threshold", 0.5),
        eval_every_steps=args.eval_every_steps,
        scan_steps=args.scan_steps,
        early_stopping_patience=args.early_stopping_patience,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
        mesh=MeshConfig(data=data, fsdp=fsdp, tensor=tensor),
        optimizer=OptimizerConfig(
            learning_rate=args.learning_rate,
            weight_decay=args.weight_decay,
            warmup_proportion=args.warmup_proportion,
            # the schedule counts optimizer updates, one per
            # gradient_accumulation_steps batches
            total_steps=args.total_steps
            or max(steps_per_epoch * args.epochs
                   // max(args.gradient_accumulation_steps, 1), 1),
            grad_accumulation_steps=args.gradient_accumulation_steps,
            freeze_patterns=_freeze_patterns(args),
            state_dtype=getattr(args, "opt_state_dtype", "float32")),
    )


def _dump_hyperparameters(args, out_dir: str) -> None:
    """hyperparamter.txt dump (finetune_text.py:380-383), by rank 0."""
    from item_alignment_torch.engine.checkpoint import is_writer

    if not is_writer():
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hyperparamter.txt"), "w") as w:
        for k, v in sorted(vars(args).items()):
            w.write(f"{k}={v}\n")


def _check_param_file(path: str) -> None:
    if not os.path.exists(path):
        # predicting with random weights would hand garbage scores on
        raise FileNotFoundError(f"parameter file {path} does not exist")


def _load_param_file(path: str):
    """The state dict of a ``.pt`` file or of a JAX CLI ``.msgpack`` (a
    malformed one raises a ``ValueError`` that names it)."""
    from item_alignment_torch.engine.checkpoint import load_params

    _check_param_file(path)
    return load_params(path)


def _param_file_in(path: str, name: str) -> str:
    """``path`` itself, or in a directory ``<name>.pt``, else the JAX CLI's
    ``<name>.msgpack``."""
    if not os.path.isdir(path):
        return path
    pt = os.path.join(path, name + ".pt")
    return pt if os.path.exists(pt) else os.path.join(path, name + ".msgpack")


# ------------------------------------------------------------- commands
def cmd_prepare(argv: List[str]) -> int:
    """Offline preprocessing: the KG files, ``cate2id.json`` and the
    finetune TSVs (``data/prepare.py:prepare_all``); with ``--with_image``,
    the 9-column TSVs carry the vectors of ``<output_dir>/
    image_embedding.json``, dumped through an image tower first when the
    file does not exist.  ``--only_image`` writes the image-pair shards, and
    ``--only_image --object_detection`` the detection-guided crops."""
    p = argparse.ArgumentParser(prog="ia-torch prepare")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--valid_proportion", type=float, default=0.1)
    p.add_argument("--num_train_augment", type=int, default=0)
    p.add_argument("--num_neg", type=int, default=5)
    p.add_argument("--prev_valid", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with_image", action="store_true",
                   help="thread <output_dir>/image_embedding.json into the "
                        "finetune TSVs (dumped through --cv_model_name when "
                        "it does not exist)")
    p.add_argument("--only_image", action="store_true",
                   help="write image-pair shards of --dtypes")
    p.add_argument("--object_detection", action="store_true",
                   help="with --only_image: the detection-guided crops")
    p.add_argument("--dtypes", default="train,valid")
    p.add_argument("--image_size", type=int, default=288)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--cv_model_name", default="eca_nfnet_l0")
    p.add_argument("--pretrained_model_path", default=None,
                   help="torch-saved timm state dict for the embedding dump")
    p.add_argument("--finetuned", action="store_true",
                   help="encode with a finetuned two-tower "
                        "(--file_state_dict)")
    p.add_argument("--file_state_dict", default=None,
                   help="finetune-image best_f1.pt or .msgpack (with "
                        "--finetuned)")
    p.add_argument("--boxes_file", default=None,
                   help="precomputed detector boxes for --object_detection "
                        "(item_id -> [x1,y1,x2,y2,cls,conf] rows)")
    p.add_argument("--min_crop_ratio", type=float, default=0.1)
    p.add_argument("--detector", default="saliency",
                   choices=["saliency", "none"],
                   help="box source without --boxes_file/--yolo_weights: "
                        "'saliency' finds a product on a plain background "
                        "(data/images.py:propose_box_saliency); 'none' "
                        "copies the images uncropped")
    p.add_argument("--yolo_weights", default=None,
                   help="a locally exported YOLOv5 TorchScript file, run on "
                        "CPU torch for --object_detection (data/yolo.py)")
    p.add_argument("--yolo_imgsz", type=int, default=640)
    p.add_argument("--yolo_conf_thres", type=float, default=0.25)
    p.add_argument("--images_dir", default=None,
                   help="defaults to <data_dir>/item_images[_cropped]")
    p.add_argument("--shard_size", type=int, default=1024)
    _device_flag(p)
    args = p.parse_args(argv)
    if args.only_image:
        # the shards and crops are host work; the command still takes the
        # card by default, as every image entry point does
        resolve_device(args.device)
        if args.object_detection:
            return _prepare_object_detection(args)
        return _prepare_image_shards(args)

    from item_alignment_torch.data.prepare import prepare_all

    img_emb = _load_image_embedding(args) if args.with_image else None
    files = prepare_all(args.data_dir, args.output_dir,
                        valid_proportion=args.valid_proportion,
                        seed=args.seed,
                        num_train_augment=args.num_train_augment,
                        num_neg=args.num_neg, prev_valid=args.prev_valid,
                        img_emb=img_emb)
    print(json.dumps(files))
    return 0


def _iter_item_info(path: str):
    with open(path, encoding="utf-8") as r:
        for line in r:
            if line.strip():
                yield json.loads(line)


def _load_image_embedding(args):
    """``<output_dir>/image_embedding.json`` as {item id: embedding text};
    when it does not exist, it is dumped first: every item's image
    ``<images_dir>/<item_id>.jpg`` (default ``<data_dir>/
    item_images_cropped``) through ``--cv_model_name``'s tower in fp32, with
    a timm state dict (``--pretrained_model_path``) or the tower of a
    ``finetune-image`` ``best_f1.pt`` (``--finetuned --file_state_dict``).
    An image that does not load gets a zero vector."""
    from item_alignment_torch.data.images import (
        dump_image_embeddings,
        load_embedding_json,
    )
    from item_alignment_torch.data.native_loader import read_embedding_spans
    from item_alignment_torch.models.image import (
        backbone_for,
        init_image_weights,
    )

    out_path = os.path.join(args.output_dir, "image_embedding.json")
    if os.path.isfile(out_path):
        # the ids and the arrays' own text, sliced by the native scan; a
        # file it refuses is read with json.load and reformatted
        spans = read_embedding_spans(out_path)
        emb = (dict(spans) if spans is not None
               else load_embedding_json(out_path))
        logger.info(f"loaded image embeddings for {len(emb)} items")
        return emb
    if not (args.finetuned or args.pretrained_model_path):
        # random weights would poison every TSV downstream
        raise SystemExit("--with_image needs --pretrained_model_path (a timm "
                         "state dict) or --finetuned --file_state_dict")
    device = resolve_device(args.device)
    cfg = ModelConfig(model_name=args.cv_model_name,
                      image_model_name=args.cv_model_name,
                      image_size=args.image_size)
    with torch.device(device):
        tower = backbone_for(args.cv_model_name, cfg)
    init_image_weights(tower, torch.Generator(device=device).manual_seed(0))
    if args.finetuned:
        if not args.file_state_dict:
            raise SystemExit("--finetuned needs --file_state_dict "
                             "(a finetune-image best_f1.pt)")
        state = _load_param_file(args.file_state_dict)
        prefix = f"{type(tower).__name__}_0."
        sub = {k[len(prefix):]: v for k, v in state.items()
               if k.startswith(prefix)}
        tower.load_state_dict(sub or state)
    else:
        from item_alignment_torch.utils.hf_import import load_torch_state_dict
        from item_alignment_torch.utils.timm_import import load_timm_backbone

        sd = load_torch_state_dict(_timm_checkpoint(args.pretrained_model_path,
                                                    args.cv_model_name))
        tower.load_state_dict(load_timm_backbone(tower.state_dict(), sd,
                                                 args.cv_model_name))
    tower.eval()

    def encode(imgs: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            out = tower(torch.from_numpy(imgs).to(device))
            if isinstance(out, tuple):  # ViT returns (cls, tokens)
                out = out[0]
            return out.float().cpu().numpy()

    images_dir = args.images_dir or os.path.join(args.data_dir,
                                                 "item_images_cropped")
    ids = [d["item_id"] for d in _iter_item_info(
        os.path.join(args.data_dir, "item_info.jsonl"))]
    paths = [os.path.join(images_dir, f"{iid}.jpg") for iid in ids]
    emb = dump_image_embeddings(ids, paths, encode, out_path,
                                image_size=args.image_size,
                                batch_size=args.batch_size,
                                missing_dim=tower.num_features)
    logger.info(f"dumped {len(emb)} image embeddings "
                f"(dim {tower.num_features})")
    return emb


def _prepare_image_shards(args) -> int:
    """The image pairs of each of ``--dtypes``' pair files, transformed to
    ``--image_size`` (train: random resized crop and flip from
    ``--seed``; valid and test: the eval crop) and stored as post-transform
    uint8 in ``.npz`` shards; a pair with an image that does not load is
    dropped."""
    from item_alignment_torch.data.images import (
        eval_transform,
        load_image,
        train_transform,
        write_image_shards,
    )

    id2name = {d["item_id"]: d.get("item_image_name", f"{d['item_id']}.jpg")
               for d in _iter_item_info(
                   os.path.join(args.data_dir, "item_info.jsonl"))}
    images_dir = args.images_dir or os.path.join(args.data_dir, "item_images")
    rng = np.random.RandomState(args.seed)
    written = {}
    for dtype in args.dtypes.split(","):
        pair_file = {"train": "item_train_pair.jsonl",
                     "valid": "item_valid_pair.jsonl",
                     "test": "item_test_pair.jsonl"}[dtype]
        path = os.path.join(args.data_dir, pair_file)
        if not os.path.exists(path):
            logger.warning(f"skipping {dtype}: no {pair_file}")
            continue

        def gen():
            skipped = 0
            with open(path, encoding="utf-8") as r:
                for line in r:
                    d = json.loads(line)
                    sid, tid = d["src_item_id"], d["tgt_item_id"]
                    label = int(d.get("item_label", 0))
                    img1 = load_image(os.path.join(images_dir,
                                                   id2name.get(sid, "")))
                    img2 = load_image(os.path.join(images_dir,
                                                   id2name.get(tid, "")))
                    if img1 is None or img2 is None:
                        skipped += 1
                        continue
                    if dtype == "train":
                        t1 = train_transform(img1, args.image_size, rng,
                                             normalized=False)
                        t2 = train_transform(img2, args.image_size, rng,
                                             normalized=False)
                    else:
                        t1 = eval_transform(img1, args.image_size,
                                            normalized=False)
                        t2 = eval_transform(img2, args.image_size,
                                            normalized=False)
                    yield (f"{sid}|{tid}", t1, t2, label)
            if skipped:
                logger.warning(f"[{dtype}] skipped {skipped} broken pairs")

        written[dtype] = write_image_shards(
            gen(), args.output_dir, shard_size=args.shard_size,
            prefix=f"{dtype}_feat", transformed=True)
    print(json.dumps(written))
    return 0


def _prepare_object_detection(args) -> int:
    """Each item's image cropped to its largest detection that the
    category's whitelist allows and that covers more than
    ``--min_crop_ratio`` of it, else copied, into ``<output_dir>/
    item_images_cropped/<item_id>.jpg``.  The boxes come from
    ``--boxes_file``, a YOLOv5 TorchScript file (``--yolo_weights``) or the
    saliency detector (``--detector saliency``); ``--detector none`` copies
    every image."""
    from item_alignment_torch.data.images import (
        crop_images_with_boxes,
        propose_box_saliency,
    )

    boxes = {}
    detector = None
    if args.boxes_file:
        with open(args.boxes_file, encoding="utf-8") as r:
            text = r.read()
        try:  # one JSON object {item_id: [boxes]}
            boxes = json.loads(text)
        except json.JSONDecodeError:  # jsonl rows {"item_id", "boxes"}
            for line in text.splitlines():
                if line.strip():
                    d = json.loads(line)
                    boxes[d["item_id"]] = d["boxes"]
    elif args.yolo_weights:
        from item_alignment_torch.data.yolo import YoloTorchscriptDetector

        detector = YoloTorchscriptDetector(
            args.yolo_weights, imgsz=args.yolo_imgsz,
            conf_thres=args.yolo_conf_thres)
        logger.info("YOLOv5 TorchScript detector: %s", args.yolo_weights)
    elif args.detector == "saliency":
        detector = propose_box_saliency
        logger.info("no --boxes_file: the saliency detector")
    else:
        logger.warning("no --boxes_file: every image is copied uncropped")
    images_dir = args.images_dir or os.path.join(args.data_dir, "item_images")
    out_dir = os.path.join(args.output_dir, "item_images_cropped")
    stats = crop_images_with_boxes(
        os.path.join(args.data_dir, "item_info.jsonl"), images_dir, out_dir,
        boxes, args.min_crop_ratio, detector=detector)
    print(json.dumps({"output_dir": out_dir, **stats}))
    return 0


def _load_tsv_rows(args, split: str):
    from item_alignment_torch.data.prepare import read_finetune_tsv

    path = os.path.join(args.data_dir, split)
    if not os.path.exists(path):
        return None
    return read_finetune_tsv(path)


def cmd_finetune_text(argv: List[str]) -> int:
    p = argparse.ArgumentParser(prog="ia-torch finetune-text")
    _common_train_flags(p)
    p.add_argument("--vocab_path", required=True,
                   help="dir containing vocab.txt")
    p.add_argument("--train_file", default="finetune_train_train.tsv")
    p.add_argument("--valid_file", default="finetune_train_valid.tsv")
    p.add_argument("--test_file", default="finetune_test.tsv",
                   help="--do_pred predicts on this when present "
                        "(submission flow), else on --valid_file")
    p.add_argument("--entity2id", default=None)
    p.add_argument("--relation2id", default=None)
    args = p.parse_args(argv)
    maybe_initialize_distributed_from_args(args)

    from item_alignment_torch.data.tokenization import (
        load_kg_tokenizers,
        load_text_tokenizer,
        rows_to_one_tower_dataset,
        rows_to_pkgm_dataset,
        rows_to_pkgm_two_tower_dataset,
        rows_to_two_tower_dataset,
    )
    from item_alignment_torch.models import build_model, is_image_two_tower

    if is_image_two_tower(args.model_name):
        raise ValueError(f"{args.model_name!r} is an image two-tower: "
                         f"train it with finetune-image on image-pair "
                         f"shards")
    device = resolve_device(args.device)
    tok = load_text_tokenizer(args.vocab_path)
    pkgm = "pkgm" in args.model_name
    extra = {}
    if pkgm:
        if not (args.entity2id and args.relation2id):
            raise ValueError("a pkgm model needs the KG id maps "
                             "--entity2id and --relation2id")
        kg_ent, kg_rel = load_kg_tokenizers(args.entity2id, args.relation2id)
        extra = dict(num_entities=max(kg_ent.values()) + 1,
                     num_relations=max(kg_rel.values()) + 1,
                     max_seq_len_pv=None)
    cfg = _model_config(args, vocab_size=len(tok), **extra)
    model = build_model(cfg, device=device, seed=args.seed)

    def build_ds(rows):
        if rows is None:
            return None
        if pkgm and args.interaction_type == "two_tower":
            return rows_to_pkgm_two_tower_dataset(
                rows, tok, kg_ent, kg_rel, cfg.max_seq_len, cfg.max_pvs)
        if pkgm:
            return rows_to_pkgm_dataset(rows, tok, kg_ent, kg_rel,
                                        cfg.max_seq_len, cfg.max_pvs,
                                        cfg.classification_method)
        if args.interaction_type == "two_tower" or "textcnn" in args.model_name:
            return rows_to_two_tower_dataset(rows, tok, cfg.max_seq_len,
                                             cfg.max_seq_len_pv)
        return rows_to_one_tower_dataset(rows, tok, cfg.max_seq_len,
                                         cfg.max_seq_len_pv,
                                         cfg.classification_method,
                                         cfg.auxiliary_task,
                                         cfg.max_pair_indices)

    return _finetune(args, model, cfg, device, build_ds,
                     lambda split: _load_tsv_rows(args, split))


def _finetune(args, model, cfg, device, build_ds, read_rows,
              kind: str = "text", pred_with_best: bool = True,
              restore_first: bool = False) -> int:
    """The finetune commands' flow: train (from ``--pretrained_model_path``
    when given; with ``restore_first``, ``--file_state_dict`` over it, as
    the JAX CLI's finetune-multimodal does and its finetune-text does not)
    and save ``best_f1.pt`` and ``<kind>_finetune_epoch-N.pt``; evaluate on
    the validation split; predict on the test split when its TSV exists,
    else on the validation split.  Without ``--do_train`` the weights come
    from ``--file_state_dict``."""
    from item_alignment_torch.engine.checkpoint import save_params
    from item_alignment_torch.engine.observability import profile_trace
    from item_alignment_torch.engine.train import Trainer

    train_ds = build_ds(read_rows(args.train_file))
    valid_ds = build_ds(read_rows(args.valid_file))
    if args.do_train and train_ds is None:
        raise FileNotFoundError(f"no training split {args.train_file} in "
                                f"{args.data_dir}")
    out_dir = os.path.join(args.output_dir, run_dir_name(args))
    _dump_hyperparameters(args, out_dir)

    steps = train_ds.num_batches(args.train_batch_size) if train_ds else 1
    trainer = Trainer(model, _train_config(args, steps), device=device,
                      log_dir=args.log_dir)
    ready = False  # whether the model holds the weights to evaluate
    if args.do_train:
        if args.pretrained_model_path:
            _load_pretrained(model, cfg, args)
        if restore_first:
            _maybe_restore(trainer, args)
        with profile_trace(args.profile_dir):
            result = trainer.fit(train_ds, valid_ds)
        _save_epoch_params(trainer, out_dir, args.epochs, kind)
        best = trainer.best_params if trainer.best_params is not None \
            else trainer._host_params()
        save_params(os.path.join(out_dir, "best_f1.pt"), best)
        print(json.dumps({"best": result["best"]}))
        ready = True
    if args.do_eval and valid_ds is not None and len(valid_ds) > 0:
        if not ready:
            _maybe_restore(trainer, args)
            ready = True
        ev = trainer.evaluate(valid_ds)
        print(json.dumps({"sweep": ev.get("sweep", []),
                          "best_f1": ev.get("best_f1"),
                          "best_threshold": ev.get("best_threshold")}))
    if args.do_pred:
        # the reference's submission flow: predict on the test pairs when
        # the prepared test TSV exists, otherwise on the validation split
        test_rows = read_rows(args.test_file)
        pred_ds = build_ds(test_rows) if test_rows else valid_ds
        if pred_ds is not None and len(pred_ds) > 0:
            if not ready:
                _maybe_restore(trainer, args)
            if (pred_with_best and args.pred_with_best
                    and trainer.best_params is not None):
                model.load_state_dict(trainer.best_params)
            path = os.path.join(
                out_dir, f"deepAI_result_threshold={args.threshold}.jsonl")
            trainer.predict_jsonl(pred_ds, path, args.threshold)
            print(json.dumps({"prediction_file": path,
                              "prediction_split": "test" if test_rows
                              else "valid"}))
    return 0


def cmd_finetune_multimodal(argv: List[str]) -> int:
    """RobertaImage one-tower or two-tower on the 9-column TSVs that
    ``prepare --with_image`` writes (the reference's
    finetune_multimodal.py)."""
    p = argparse.ArgumentParser(prog="ia-torch finetune-multimodal")
    _common_train_flags(p)
    p.add_argument("--vocab_path", required=True,
                   help="dir containing vocab.txt")
    p.add_argument("--train_file", default="finetune_train_train.tsv")
    p.add_argument("--valid_file", default="finetune_train_valid.tsv")
    p.add_argument("--test_file", default="finetune_test.tsv",
                   help="--do_pred predicts on this when present, else on "
                        "--valid_file")
    p.add_argument("--image_hidden_size", type=int, default=3072)
    p.add_argument("--ensemble", default="begin",
                   choices=["begin", "end", "sum", "cross_attn"])
    p.add_argument("--images_dir", default=None,
                   help="item images dir (<item_id>.jpg/png/jpeg) for coca "
                        "models")
    p.add_argument("--image_size", type=int, default=224)
    args = p.parse_args(argv)
    maybe_initialize_distributed_from_args(args)
    is_coca = "coca" in args.model_name
    if not (is_coca or "roberta_image" in args.model_name):
        raise ValueError(f"finetune-multimodal trains roberta_image* and "
                         f"coca* models, not {args.model_name!r}")
    if is_coca and not args.images_dir:
        raise ValueError("a coca finetune needs --images_dir")

    from item_alignment_torch.data.images import load_image
    from item_alignment_torch.data.prepare import read_finetune_tsv, read_tsv
    from item_alignment_torch.data.tokenization import (
        build_multimodal_pair_dataset,
        load_text_tokenizer,
        rows_to_image_one_tower_dataset,
        rows_to_image_two_tower_dataset,
    )
    from item_alignment_torch.models import build_model

    device = resolve_device(args.device)
    tok = load_text_tokenizer(args.vocab_path)
    cfg = _model_config(args, vocab_size=len(tok), ensemble=args.ensemble,
                        image_hidden_size=args.image_hidden_size,
                        image_size=args.image_size)
    model = build_model(cfg, device=device, seed=args.seed)
    layout = (rows_to_image_two_tower_dataset
              if args.interaction_type == "two_tower"
              else rows_to_image_one_tower_dataset)

    def read_rows(split):
        path = os.path.join(args.data_dir, split)
        if not os.path.exists(path):
            return None
        return read_finetune_tsv(path) if is_coca else read_tsv(path)

    def build_ds(rows):
        if rows is None:
            return None
        if is_coca:
            return build_multimodal_pair_dataset(
                rows, tok, load_image, _image_paths(args.images_dir, rows),
                cfg.max_seq_len, cfg.max_seq_len_pv, cfg.image_size,
                bos=cfg.ensemble == "sum")
        return layout(rows, tok, cfg.max_seq_len, cfg.max_seq_len_pv,
                      args.image_hidden_size, ensemble=cfg.ensemble)

    return _finetune(args, model, cfg, device, build_ds, read_rows,
                     kind="multimodal", pred_with_best=False,
                     restore_first=True)


def _image_paths(images_dir: str, rows) -> dict:
    """{item id: ``<images_dir>/<item id>.jpg``, ``.png`` or ``.jpeg``, the
    first that exists} for the items of the 9-tuple ``rows``."""
    paths = {}
    for iid in sorted({r[1] for r in rows} | {r[5] for r in rows}):
        for ext in (".jpg", ".png", ".jpeg"):
            cand = os.path.join(images_dir, iid + ext)
            if os.path.exists(cand):
                paths[iid] = cand
                break
    return paths


def cmd_finetune_image(argv: List[str]) -> int:
    """The image two-tower (``--model_name`` with vit, resnet or nfnet) on
    the ``.npz`` shards of ``prepare --only_image`` (the reference's
    finetune_image.py): train from a timm state dict
    (``--pretrained_model_path``) and save ``best_f1.pt`` and
    ``image_finetune_epoch-N.pt``, evaluate on ``--valid_shards`` (or the
    train shards) under ``--do_eval``, and predict on ``--shards`` under
    ``--do_pred``, from ``--file_state_dict`` without ``--do_train``."""
    p = argparse.ArgumentParser(prog="ia-torch finetune-image")
    _common_train_flags(p)
    p.add_argument("--shards", nargs="+", required=True,
                   help="npz shards from write_image_shards")
    p.add_argument("--valid_shards", nargs="+", default=None,
                   help="npz shards for the eval split (best-F1 tracking "
                        "under --do_eval)")
    p.add_argument("--image_size", type=int, default=288)
    args = p.parse_args(argv)
    maybe_initialize_distributed_from_args(args)
    if not any(a == "--eval_batch_size" or a.startswith("--eval_batch_size=")
               for a in argv):
        # the train batch's forward and backward fit, so its forward does
        args.eval_batch_size = args.train_batch_size

    from item_alignment_torch.engine.checkpoint import save_params
    from item_alignment_torch.engine.observability import profile_trace
    from item_alignment_torch.engine.train import Trainer
    from item_alignment_torch.models import build_model, is_image_two_tower

    if not is_image_two_tower(args.model_name):
        raise ValueError(f"finetune-image trains the vit/resnet/nfnet "
                         f"two-towers, not {args.model_name!r}")
    device = resolve_device(args.device)
    ds = _load_shard_dataset(args.shards, args.image_size)
    valid_ds = (_load_shard_dataset(args.valid_shards, args.image_size)
                if args.valid_shards else None)
    args.interaction_type = "two_tower"  # the run dir's name says so
    cfg = _model_config(args, image_model_name=args.model_name,
                        image_size=args.image_size,
                        interaction_type="two_tower")
    out_dir = os.path.join(args.output_dir, run_dir_name(args))
    _dump_hyperparameters(args, out_dir)
    model = build_model(cfg, device=device, seed=args.seed)
    trainer = Trainer(model, _train_config(
        args, ds.num_batches(args.train_batch_size)), device=device,
        log_dir=args.log_dir)
    if args.pretrained_model_path:
        _load_timm_pretrained(model, args)
    _maybe_restore(trainer, args)
    if args.do_train:
        with profile_trace(args.profile_dir):
            result = trainer.fit(ds, (valid_ds or ds) if args.do_eval
                                 else None)
        _save_epoch_params(trainer, out_dir, args.epochs, kind="image")
        # predict.sh predicts from best_f1: the best-eval parameters, or the
        # last ones when training ran without eval
        best = trainer.best_params if trainer.best_params is not None \
            else trainer._host_params()
        save_params(os.path.join(out_dir, "best_f1.pt"), best)
        print(json.dumps({"best": result["best"]}))
    if args.do_pred:
        path = os.path.join(out_dir,
                            f"deepAI_result_threshold={args.threshold}.jsonl")
        trainer.predict_jsonl(ds, path, args.threshold)
        print(json.dumps({"prediction_file": path}))
    return 0


def _load_shard_dataset(shard_paths, image_size: int):
    """The image pairs of ``shard_paths`` in one ``ArrayDataset``
    (``images_1``, ``images_2``, ``labels``; meta ``src_item_id`` and
    ``tgt_item_id`` from the ``src|tgt`` pair ids), filled in two passes
    (count, then fill preallocated arrays, so the host never holds the
    data twice).  Post-transform uint8 shards stay uint8; fp32 shards, and
    raw uint8 ones (``transformed`` false or absent: transformed here with
    ``eval_transform``), go into fp32 arrays."""
    from item_alignment_torch.data.datasets import ArrayDataset
    from item_alignment_torch.data.images import (
        eval_transform,
        normalize,
        read_image_shards,
    )

    n = 0
    first_u8 = None
    for sp in shard_paths:  # npz loads lazily: only the metadata is read
        with np.load(sp, allow_pickle=False) as z:
            n += int(len(z["labels"]))
            if first_u8 is None:
                first_u8 = bool(z["images_1"].dtype == np.uint8
                                and "transformed" in z.files
                                and z["transformed"])
    buf_dtype = np.uint8 if first_u8 else np.float32
    imgs1 = np.empty((n, image_size, image_size, 3), buf_dtype)
    imgs2 = np.empty_like(imgs1)
    labels = np.empty((n,), np.int32)
    src_ids, tgt_ids = [], []
    row = 0
    for shard in read_image_shards(shard_paths):
        is_u8 = shard["images_1"].dtype == np.uint8
        is_transformed = bool(shard.get("transformed", np.bool_(not is_u8)))
        if buf_dtype == np.uint8 and not (is_u8 and is_transformed):
            raise SystemExit(
                "mixed image shards: post-transform uint8 shards cannot be "
                "combined with fp32 or raw ones in one run")
        # transformed uint8 rows in an fp32 buffer are normalised here: a
        # bare cast would hand the model 0..255 floats
        norm_here = is_transformed and is_u8 and buf_dtype == np.float32
        for i in range(len(shard["labels"])):
            if norm_here:
                imgs1[row] = normalize(shard["images_1"][i])
                imgs2[row] = normalize(shard["images_2"][i])
            elif is_transformed:
                imgs1[row] = shard["images_1"][i]
                imgs2[row] = shard["images_2"][i]
            else:  # a raw uint8 shard
                imgs1[row] = eval_transform(shard["images_1"][i], image_size)
                imgs2[row] = eval_transform(shard["images_2"][i], image_size)
            labels[row] = int(shard["labels"][i])
            sid, _, tid = str(shard["pair_ids"][i]).partition("|")
            src_ids.append(sid)
            tgt_ids.append(tid or sid)
            row += 1
    return ArrayDataset({"images_1": imgs1, "images_2": imgs2,
                         "labels": labels},
                        meta={"src_item_id": src_ids, "tgt_item_id": tgt_ids})


def _timm_checkpoint(path: str, model_name: str) -> str:
    """The timm state dict at ``path``: the file, or the first of
    ``pytorch_model.bin``, ``model.pth``, ``model.bin`` and
    ``checkpoint.pth`` in the directory; missing, it raises."""
    if os.path.isdir(path):
        for cand in ("pytorch_model.bin", "model.pth", "model.bin",
                     "checkpoint.pth"):
            if os.path.exists(os.path.join(path, cand)):
                path = os.path.join(path, cand)
                break
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"--pretrained_model_path {path}: no checkpoint found (expected "
            f"a torch state dict of the timm model for {model_name})")
    return path


def _load_timm_pretrained(model, args) -> None:
    """The timm backbone weights of ``--pretrained_model_path`` over the
    image two-tower's tower (``utils/timm_import.py``)."""
    from item_alignment_torch.utils.hf_import import load_torch_state_dict
    from item_alignment_torch.utils.timm_import import load_timm_backbone

    path = _timm_checkpoint(args.pretrained_model_path, args.model_name)
    model.load_state_dict(load_timm_backbone(
        model.state_dict(), load_torch_state_dict(path), args.model_name))
    logger.info(f"loaded the timm backbone from {path}")


def _load_coca_pretrained(model, args) -> None:
    """The ``coca`` and ``multimodal`` parameters of a ``coca-pretrain``
    file (``--pretrained_model_path``: ``coca_pretrain.pt`` or the JAX
    CLI's ``coca_pretrain.msgpack``, or their directory) over the
    item-alignment model's (the reference loads with strict=False)."""
    from item_alignment_torch.utils.hf_import import _overlay

    path = _param_file_in(args.pretrained_model_path, "coca_pretrain")
    pre = _load_param_file(path)
    state = model.state_dict()
    tops = {k.split(".")[0] for k in state} & {"coca", "multimodal"}
    sub = {k: v for k, v in pre.items() if k.split(".")[0] in tops}
    if not sub:
        raise ValueError(f"no shared subtrees between {path} and the model")
    _overlay(state, sub)
    model.load_state_dict(state)
    logger.info(f"loaded coca pretrain subtrees "
                f"{sorted({k.split('.')[0] for k in sub})} from {path}")


def _load_pretrained(model, cfg, args) -> None:
    """HF encoder weights from ``pytorch_model.bin`` under
    ``--pretrained_model_path`` (``utils/hf_import.py``); for a pkgm model,
    merged with the PKGM pretrain tables of ``pkgm_model.bin`` beside it
    when there is one.  Without ``pytorch_model.bin`` nothing is loaded.  A
    coca model takes a ``coca-pretrain`` file instead."""
    if "coca" in cfg.model_name:
        return _load_coca_pretrained(model, args)
    from item_alignment_torch.models import PKGMBackbone
    from item_alignment_torch.utils import (
        KG_WEIGHTS_NAME,
        ROBERTA_WEIGHTS_NAME,
    )
    from item_alignment_torch.utils.hf_import import (
        import_hf_roberta,
        load_torch_state_dict,
    )

    if not hasattr(model, "roberta"):
        raise ValueError(f"{cfg.model_name} has no RoBERTa encoder to load "
                         f"{ROBERTA_WEIGHTS_NAME} into")
    rob = os.path.join(args.pretrained_model_path, ROBERTA_WEIGHTS_NAME)
    kg = os.path.join(args.pretrained_model_path, KG_WEIGHTS_NAME)
    if not os.path.exists(rob):
        logger.warning(f"no {ROBERTA_WEIGHTS_NAME} under "
                       f"{args.pretrained_model_path}")
        return
    kg_sd = (load_torch_state_dict(kg) if isinstance(
        model.roberta, PKGMBackbone) and os.path.exists(kg) else None)
    model.load_state_dict(import_hf_roberta(
        model.state_dict(), load_torch_state_dict(rob), cfg, kg_sd))
    logger.info("loaded pretrained encoder weights")


def _save_epoch_params(trainer, out_dir: str, epoch: int,
                       kind: str = "text") -> None:
    """``<kind>_finetune_epoch-N.pt`` (the reference's
    finetune_text.py:587 naming, with the port's extension)."""
    from item_alignment_torch.engine.checkpoint import save_params

    path = os.path.join(out_dir, f"{kind}_finetune_epoch-{epoch}.pt")
    save_params(path, trainer._host_params())
    logger.info(f"saved {path}")


def _maybe_restore(trainer, args) -> None:
    if args.file_state_dict:
        trainer.model.load_state_dict(_load_param_file(args.file_state_dict))


def _item_texts(id_dict, relation_count, item_ids, sep_token):
    """Item text in the training layout: jieba-cut title, then the pvs in
    frequency order (``build_finetune_pairs`` does the same per pair)."""
    from item_alignment_torch.data.prepare import (
        order_pvs_single,
        parse_pvs,
        segment_title,
    )
    from item_alignment_torch.data.tokenization import build_item_text

    texts = []
    for iid in item_ids:
        it = id_dict[iid]
        pvs = order_pvs_single(it.get("pvs") or parse_pvs(it),
                               relation_count, it.get("cate_name", ""))
        texts.append(build_item_text(segment_title(it.get("title", "")), pvs,
                                     sep_token))
    return texts


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_mine(argv: List[str]) -> int:
    """Embedding-cache mining: encode each unique item once with a
    finetuned two-tower text model, then score a candidate-pair list
    against the cache (``engine/inference.py``).  ``--cache_quant int8``
    stores the cache as int8 rows; ``--quant int8`` also runs the encoder's
    dense projections on the int8 path."""
    p = argparse.ArgumentParser(prog="ia-torch mine")
    p.add_argument("--item_info", required=True,
                   help="raw item_info.jsonl (item_id/title/item_pvs)")
    p.add_argument("--pairs", required=True,
                   help="candidate pairs jsonl (src_item_id/tgt_item_id)")
    p.add_argument("--output", required=True)
    p.add_argument("--vocab_path", required=True)
    p.add_argument("--config_file", default=None)
    p.add_argument("--model_name", default="roberta_large")
    p.add_argument("--file_state_dict", default=None,
                   help="finetune-text two_tower parameters (.pt or "
                        ".msgpack)")
    p.add_argument("--allow_random_weights", action="store_true")
    p.add_argument("--max_seq_len", type=int, default=50)
    p.add_argument("--max_seq_len_pv", type=int, default=205)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--quant", default=None, choices=["int8"])
    p.add_argument("--cache_quant", default=None, choices=["int8"])
    p.add_argument("--num_workers", type=int, default=8,
                   help="tokenizer processes (0 = serial)")
    _device_flag(p)
    args = p.parse_args(argv)

    from item_alignment_torch.data.prepare import load_item_info
    from item_alignment_torch.data.tokenization import (
        encode_texts,
        load_text_tokenizer,
    )
    from item_alignment_torch.engine.inference import (
        TwoTowerInference,
        two_tower_encode_fn,
        two_tower_head_fn,
    )
    from item_alignment_torch.models.text import RobertaTwoTower

    if not (args.file_state_dict or args.allow_random_weights):
        raise SystemExit("mine needs --file_state_dict (trained two-tower "
                         "params); pass --allow_random_weights to override")
    device = resolve_device(args.device)
    tok = load_text_tokenizer(args.vocab_path)
    id_dict, _, relation_count = load_item_info(args.item_info)

    pairs = []
    with open(args.pairs, encoding="utf-8") as r:
        for line in r:
            if line.strip():
                d = json.loads(line)
                pairs.append((d["src_item_id"], d["tgt_item_id"]))
    item_ids = sorted({i for pr in pairs for i in pr})
    missing = [i for i in item_ids if i not in id_dict]
    if missing:
        raise SystemExit(f"{len(missing)} pair items missing from "
                         f"--item_info (first: {missing[:3]})")

    texts = _item_texts(id_dict, relation_count, item_ids, tok.sep_token)
    S = args.max_seq_len + args.max_seq_len_pv
    ids_all, mask_all = encode_texts(args.vocab_path, texts, S,
                                     args.num_workers)

    cfg = _config_for(args, vocab_size=len(tok), interaction_type="two_tower",
                      max_seq_len=args.max_seq_len,
                      max_seq_len_pv=args.max_seq_len_pv,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, quant=args.quant)
    model = RobertaTwoTower(cfg, device=device).eval()
    if args.file_state_dict:
        model.load_state_dict(_load_param_file(args.file_state_dict))
    inf = TwoTowerInference(two_tower_encode_fn(model),
                            two_tower_head_fn(model), batch_size=256,
                            cache_quant=args.cache_quant, device=device)

    B = min(args.batch_size, len(item_ids))

    def batches():
        for s in range(0, len(item_ids), B):
            ids_b, mask_b = ids_all[s: s + B], mask_all[s: s + B]
            if len(ids_b) < B:  # the tail padded to the batch shape
                pad = B - len(ids_b)
                ids_b = np.pad(ids_b, ((0, pad), (0, 0)))
                mask_b = np.pad(mask_b, ((0, pad), (0, 0)))
            yield {"input_ids": torch.from_numpy(ids_b).long().to(device),
                   "attention_mask": torch.from_numpy(mask_b).long().to(device)}

    t0 = time.time()
    inf.build_cache(item_ids, batches())
    _synchronize(device)
    t_encode = time.time() - t0
    t0 = time.time()
    probs = inf.score_pairs_by_id(pairs)
    t_score = time.time() - t0

    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    with open(args.output, "w", encoding="utf-8") as w:
        for (src, tgt), prob in zip(pairs, probs):
            w.write(json.dumps({
                "src_item_id": src, "src_item_emb": "[0]",
                "tgt_item_id": tgt, "tgt_item_emb": f"[{float(prob)}]",
                "threshold": args.threshold}) + "\n")
    print(json.dumps({
        "output": args.output, "items": len(item_ids), "pairs": len(pairs),
        "encode_s": round(t_encode, 2), "score_s": round(t_score, 2),
        "pairs_per_sec": round(len(pairs) / max(t_encode + t_score, 1e-9), 1),
    }))
    return 0


def cmd_pred_text(argv: List[str]) -> int:
    """Encode every KG entity's text with the (pre)trained RoBERTa -> the
    pooled feature matrix for the GCN (pred_text.py:65-192: jieba-cut item
    titles and value strings, pooler rows in entity-id order).

    Weights are required: ``--pretrained_model_path`` (HF dir) and/or
    ``--file_state_dict`` (finetune-text parameters over the encoder); a
    random encoder would hand the GCN noise."""
    p = argparse.ArgumentParser(prog="ia-torch pred-text")
    p.add_argument("--entity2id", required=True)
    p.add_argument("--item_info", required=True)
    p.add_argument("--vocab_path", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--config_file", default=None)
    p.add_argument("--model_name", default="roberta_large")
    p.add_argument("--pretrained_model_path", default=None,
                   help="HF dir with pytorch_model.bin")
    p.add_argument("--file_state_dict", default=None,
                   help="finetune-text parameters (.pt or .msgpack) over "
                        "the encoder")
    p.add_argument("--max_seq_len", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--scan_chunks", type=int, default=8,
                   help="batches encoded per host-to-device transfer (the "
                        "rows are padded to full groups)")
    p.add_argument("--num_workers", type=int, default=8,
                   help="tokenizer processes (0 = serial)")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="escape hatch for tests and smoke runs")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="int8 path for the encoder's dense projections")
    p.add_argument("--xfer_guard", action="store_true",
                   help="fail on any synchronizing host->device copy in the "
                        "encode loop (each group goes over in one explicit "
                        "non-blocking copy from pinned memory); on --device "
                        "cpu there is no transfer to guard")
    _device_flag(p)
    args = p.parse_args(argv)

    from item_alignment_torch.data.prepare import segment_title
    from item_alignment_torch.data.tokenization import (
        encode_texts,
        load_kg_tokenizers,
        load_text_tokenizer,
    )
    from item_alignment_torch.models.encoder import Pooler
    from item_alignment_torch.models.layers import init_weights
    from item_alignment_torch.models.text import RobertaBackbone
    from item_alignment_torch.utils.hf_import import (
        _overlay,
        convert_encoder_state_dict,
        load_torch_state_dict,
    )

    if not (args.pretrained_model_path or args.file_state_dict
            or args.allow_random_weights):
        raise SystemExit(
            "pred-text needs --pretrained_model_path and/or "
            "--file_state_dict; refusing to build the GCN feature matrix "
            "from random weights (pass --allow_random_weights to override)")
    device = resolve_device(args.device)
    tok = load_text_tokenizer(args.vocab_path)
    ents, _ = load_kg_tokenizers(args.entity2id, args.entity2id)
    id_dict = {}
    with open(args.item_info, encoding="utf-8") as r:
        for line in r:
            d = json.loads(line)
            id_dict[d["item_id"]] = d

    def entity_text(name: str) -> str:
        # item titles are jieba-cut (pred_text.py:88-92); value strings
        # pass through unchanged
        if name.startswith("/item/"):
            return segment_title(
                id_dict.get(name[len("/item/"):], {}).get("title", ""))
        return name.split("/value/")[-1]

    names = sorted(ents, key=lambda n: ents[n])
    ids_all, mask_all = encode_texts(
        args.vocab_path, [entity_text(n) for n in names], args.max_seq_len,
        args.num_workers)

    cfg = _config_for(args, vocab_size=len(tok), hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0, quant=args.quant)
    backbone = RobertaBackbone(cfg, device=device).eval()
    with torch.device(device):
        pooler = Pooler(cfg).eval()
    init_weights(pooler, cfg.initializer_range,
                 torch.Generator(device=device).manual_seed(1))

    hf_bin = (os.path.join(args.pretrained_model_path, "pytorch_model.bin")
              if args.pretrained_model_path else None)
    if hf_bin and not os.path.exists(hf_bin):
        # acceptable only when finetuned weights are supplied instead
        if not args.file_state_dict:
            raise SystemExit(f"{hf_bin} not found and no --file_state_dict")
        logger.warning(f"no {hf_bin}; relying on --file_state_dict weights")
        hf_bin = None
    if hf_bin:
        sd = load_torch_state_dict(hf_bin)
        state = backbone.state_dict()
        _overlay(state, convert_encoder_state_dict(
            sd, cfg.type_vocab_size, cfg.max_position_embeddings))
        backbone.load_state_dict(state)
        # HF RobertaModel ships pooler weights ([out, in], the port's
        # layout); use them when present
        pkey = [k for k in sd if k.endswith("pooler.dense.weight")]
        if pkey:
            prefix = pkey[0][: -len(".weight")]
            pooler.load_state_dict({
                "dense.weight": torch.as_tensor(sd[prefix + ".weight"]).float(),
                "dense.bias": torch.as_tensor(sd[prefix + ".bias"]).float()})
        logger.info("loaded pretrained encoder (+pooler) weights")
    if args.file_state_dict:
        # finetuned one- or two-tower parameters: the encoder is under
        # "roberta."
        ft = _load_param_file(args.file_state_dict)
        if any(k.startswith("roberta.") for k in ft):
            ft = {k[len("roberta."):]: v for k, v in ft.items()
                  if k.startswith("roberta.")}
        state = backbone.state_dict()
        for part in ("embeddings", "encoder"):
            sub = {k: v for k, v in ft.items() if k.startswith(part + ".")}
            if not sub:
                raise ValueError(f"no '{part}' parameters in "
                                 f"{args.file_state_dict}")
            _overlay(state, sub)
        backbone.load_state_dict(state)
        logger.info(f"overlaid finetuned encoder from {args.file_state_dict}")

    B, K = args.batch_size, max(int(args.scan_chunks), 1)
    (n, S), per = ids_all.shape, B * K
    n_groups = -(-n // per)
    if n_groups * per > n:
        # pad the tail to a full [K, B] group, as the JAX CLI does: every
        # encode takes B rows at the same offsets whatever K is, so the
        # features do not depend on K; the padded rows are sliced off below
        pad = ((0, n_groups * per - n), (0, 0))
        ids_all, mask_all = np.pad(ids_all, pad), np.pad(mask_all, pad)
    pin = device.type == "cuda"

    def encode_group(g: int) -> np.ndarray:
        rows = slice(g * per, (g + 1) * per)
        host = [torch.empty((K, B, S), dtype=torch.long, pin_memory=pin)
                .copy_(torch.from_numpy(a[rows].reshape(K, B, S)))
                for a in (ids_all, mask_all)]
        with transfer_guard(device, args.xfer_guard):
            ids, mask = (h.to(device, non_blocking=True) for h in host)
            out = torch.cat([pooler(backbone(ids[k], mask[k])[-1])
                             for k in range(K)])
        return out.float().cpu().numpy()

    feats = []
    with torch.inference_mode():
        for g in range(n_groups):
            feats.append(retry_transient(lambda: encode_group(g)))
            if (g + 1) % 10 == 0 or g + 1 == n_groups:
                logger.info(f"pred-text: {min((g + 1) * per, n)}/{n} encoded")
    matrix = np.concatenate(feats)[:n] if feats else \
        np.zeros((0, cfg.hidden_size), np.float32)
    np.save(args.output, matrix)
    print(json.dumps({"output": args.output, "shape": list(matrix.shape)}))
    return 0


def cmd_pkgm_pretrain(argv: List[str]) -> int:
    """KGE pretraining on ``entity2id/relation2id/train2id.txt`` (and, with
    ``--do_eval``, filtered link prediction on ``valid2id.txt``); writes
    ``kge_final.npz`` and prints ``{"final_loss"[, "hit10", "mrr"]}``."""
    p = argparse.ArgumentParser(prog="ia-torch pkgm-pretrain")
    p.add_argument("--data_dir", required=True,
                   help="dir with entity2id/relation2id/train2id.txt")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_name", default="pkgm",
                   help="kge model: transe|pkgm|transh|...")
    p.add_argument("--embedding_dim", type=int, default=768)
    p.add_argument("--batch_size", type=int, default=32768)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--margin", type=float, default=1.0)
    p.add_argument("--n_neg", type=int, default=3)
    p.add_argument("--sampling_type", default="bernoulli")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--save_epochs", type=int, default=50)
    p.add_argument("--mesh", default=None,
                   help="data,fsdp,tensor axis sizes: shard the triple "
                        "batches over the data axis (e.g. '-1,1,1'), one "
                        "process per device (torchrun)")
    _device_flag(p)
    args = p.parse_args(argv)
    maybe_initialize_distributed_from_args(args)

    from item_alignment_torch.kge import (
        KGETrainer,
        LinkPredictionEvaluator,
        load_ccks,
        make_kge_model,
    )

    mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    kgs = load_ccks(args.data_dir, do_eval=args.do_eval)
    kg_train = kgs[0]
    model = make_kge_model(args.model_name, kg_train.n_ent, kg_train.n_rel,
                           args.embedding_dim)
    trainer = KGETrainer(model, kg_train, margin=args.margin,
                         n_neg=args.n_neg, sampling_type=args.sampling_type,
                         learning_rate=args.learning_rate,
                         batch_size=args.batch_size, n_epochs=args.epochs,
                         save_dir=args.output_dir,
                         save_epochs=args.save_epochs, mesh=mesh,
                         device=args.device)
    result = trainer.run()
    trainer.save(os.path.join(args.output_dir, "kge_final.npz"))
    out = {"final_loss": result["history"][-1]["loss"]}
    if args.do_eval and len(kgs) > 1:
        ev = LinkPredictionEvaluator(model, result["params"], kgs[1],
                                     kg_filter=kgs).evaluate()
        out.update(hit10=ev.hit_at_k(10)[1], mrr=ev.mrr()[1])
    print(json.dumps(out))
    return 0


def cmd_ensemble(argv: List[str]) -> int:
    """Fuse the members' prediction files (``aggregate/ensemble.py``)
    into ``<data_dir>/output/ensemble/deepAI_result.jsonl``."""
    p = argparse.ArgumentParser(prog="ia-torch ensemble")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--ensemble_strategy", required=True,
                   choices=["threshold", "f1"])
    p.add_argument("--models", required=True,
                   help="JSON list of [model_dir, threshold, f1] triples")
    p.add_argument("--models_unseen", default=None,
                   help="JSON triples for unseen-category pairs")
    p.add_argument("--item_info", default=None,
                   help="item_info.jsonl for the category split")
    p.add_argument("--input_file", default="deepAI_result_threshold=0.4.jsonl")
    p.add_argument("--output_dir", default=None)
    args = p.parse_args(argv)

    from item_alignment_torch.aggregate.ensemble import (
        ensemble_predictions,
        make_unseen_checker,
        read_prediction_file,
        write_prediction_file,
    )

    def load(spec_json):
        out = []
        for model_dir, thr, f1 in json.loads(spec_json):
            base = os.path.join(args.data_dir, "output", model_dir)
            path = os.path.join(base, args.input_file)
            if not os.path.exists(path):
                # a member predicted at another --threshold wrote another
                # file name; only the one of this member's own threshold is
                # taken (any other could be a stale prediction)
                cand = os.path.join(
                    base, f"deepAI_result_threshold={float(thr)}.jsonl")
                if not os.path.exists(cand):
                    raise FileNotFoundError(
                        f"neither {path} nor {cand} exists in {base}")
                path = cand
            out.append((read_prediction_file(path), float(thr), float(f1)))
        return out

    preds = load(args.models)
    unseen_preds = load(args.models_unseen) if args.models_unseen else None
    checker = None
    if unseen_preds is not None:
        if not args.item_info:
            raise ValueError("--models_unseen needs --item_info for the "
                             "category split")
        id_dict = {}
        with open(args.item_info, encoding="utf-8") as r:
            for line in r:
                d = json.loads(line)
                id_dict[d["item_id"]] = d
        checker = make_unseen_checker(id_dict)
    fused = ensemble_predictions(preds, args.ensemble_strategy,
                                 unseen_preds, checker)
    out_dir = args.output_dir or os.path.join(args.data_dir, "output",
                                              "ensemble")
    path = write_prediction_file(fused, os.path.join(out_dir,
                                                     "deepAI_result.jsonl"))
    print(json.dumps({"output": path, "pairs": len(fused)}))
    return 0


def cmd_model_soup(argv: List[str]) -> int:
    """The uniform soup of ``.pt`` or ``.msgpack`` parameter files,
    averaged on ``--device`` and written as a ``.pt`` file."""
    p = argparse.ArgumentParser(prog="ia-torch model-soup")
    p.add_argument("--checkpoints", required=True, nargs="+",
                   help=".pt or .msgpack parameter files to average")
    p.add_argument("--output", required=True)
    _device_flag(p)
    args = p.parse_args(argv)

    from item_alignment_torch.aggregate.soup import (
        load_state_dicts,
        uniform_soup,
    )
    from item_alignment_torch.engine.checkpoint import save_params

    for path in args.checkpoints:
        _check_param_file(path)
    soup = uniform_soup(load_state_dicts(args.checkpoints, args.device))
    save_params(args.output, {k: v.cpu() for k, v in soup.items()})
    print(json.dumps({"output": args.output, "n": len(args.checkpoints)}))
    return 0


def cmd_finetune_bert(argv: List[str]) -> int:
    """The legacy 5-field ``BertAlignModel`` finetune with optional
    adversarial embedding noise on the pvs and title fields (the
    reference's finetune_bert.py)."""
    p = argparse.ArgumentParser(prog="ia-torch finetune-bert")
    p.add_argument("--train_file", required=True,
                   help="jsonl rows with src_/tgt_ fields + item_label")
    p.add_argument("--valid_file", default=None)
    p.add_argument("--vocab_path", required=True)
    p.add_argument("--output_dir", default="output/bert_legacy")
    p.add_argument("--config_file", default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--adversarial", default=None,
                   choices=[None, "FREE", "PGD", "MIX"])
    p.add_argument("--epsilon", type=float, default=1e-2)
    p.add_argument("--alpha", type=float, default=1e-2)
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--pretrained_model_path", default=None,
                   help="bert_pretrain.pt or .msgpack (or their dir): "
                        "the domain-pretrained backbone to start from")
    _engine_flags(p)
    args = p.parse_args(argv)
    maybe_initialize_distributed_from_args(args)

    from item_alignment_torch.data.bert_data import (
        align_kwargs,
        pairs_to_field_dataset,
    )
    from item_alignment_torch.data.tokenization import load_text_tokenizer
    from item_alignment_torch.engine.checkpoint import is_writer, save_params
    from item_alignment_torch.engine.train import Trainer
    from item_alignment_torch.models.bert_legacy import (
        FIELD_MAX_LENS,
        BertAlignModel,
        sim_eval_weight,
    )

    device = resolve_device(args.device)
    tok = load_text_tokenizer(args.vocab_path)
    cfg = _legacy_config(args, vocab_size=len(tok),
                         dtype="bfloat16" if args.bf16 else "float32")
    train_ds = pairs_to_field_dataset(_read_jsonl(args.train_file), tok,
                                      config=cfg)
    valid_ds = (pairs_to_field_dataset(_read_jsonl(args.valid_file), tok,
                                       config=cfg)
                if args.valid_file else None)
    model = BertAlignModel(cfg, device=device, seed=args.seed)

    bs = min(args.batch_size, len(train_ds))
    adversarial = ((args.adversarial, args.epsilon, args.alpha)
                   if args.adversarial else None)
    noise_spec = {
        "pvs_noise": (FIELD_MAX_LENS["pvs"], cfg.hidden_size),
        "title_noise": (FIELD_MAX_LENS["title"], cfg.hidden_size),
    } if args.adversarial else None
    tcfg = _train_config(args, max(len(train_ds) // bs, 1), batch_size=bs)
    trainer = Trainer(model, tcfg, device=device, batch_transform=align_kwargs,
                      adversarial=adversarial, noise_spec=noise_spec,
                      log_dir=args.log_dir)
    if args.pretrained_model_path:
        from item_alignment_torch.utils.hf_import import _overlay_rows

        path = _param_file_in(args.pretrained_model_path, "bert_pretrain")
        pre = {k: v for k, v in _load_param_file(path).items()
               if k.startswith("bert.")}
        if not pre:
            raise ValueError(f"{path} has no 'bert' backbone parameters")
        # row-tolerant: bert-pretrain has 5 token types (one a field), the
        # align model fewer; the overlapping rows are copied
        state = model.state_dict()
        _overlay_rows(state, pre)
        model.load_state_dict(state)
        logger.info(f"loaded pretrained bert backbone from {path}")
    result = trainer.fit(train_ds, valid_ds)

    os.makedirs(args.output_dir, exist_ok=True)
    params = trainer._host_params()
    save_params(os.path.join(args.output_dir, "bert_align.pt"), params)
    w, b = sim_eval_weight(params)
    if is_writer():
        np.savez(os.path.join(args.output_dir, "sim_eval_weight.npz"),
                 weight=w.numpy(), bias=b.numpy())
    if trainer.best_params is not None:
        save_params(os.path.join(args.output_dir, "best_f1.pt"),
                    trainer.best_params)

    out = {"final_loss": result["history"][-1]["loss"] if result["history"]
           else None}
    if valid_ds is not None:
        out.update(best_f1=result["best"]["best_f1"],
                   best_threshold=result["best"].get("threshold"))
    print(json.dumps(out))
    return 0


def cmd_bert_pretrain(argv: List[str]) -> int:
    """The structure-aware MLM + NSP domain pretrain (the reference's
    bert_pretrain.py): whole-field, title-match and per-pv masked examples
    and negative "next" examples from item_info.jsonl, trained on
    ``BertForPretraining`` with one token type a field."""
    p = argparse.ArgumentParser(prog="ia-torch bert-pretrain")
    p.add_argument("--item_info", required=True)
    p.add_argument("--vocab_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--config_file", default=None)
    p.add_argument("--max_seq_len", type=int, default=254)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--n_negatives", type=int, default=1)
    p.add_argument("--max_items", type=int, default=None)
    _engine_flags(p)
    args = p.parse_args(argv)
    maybe_initialize_distributed_from_args(args)

    import random as pyrandom

    from item_alignment_torch.data.bert_data import (
        build_pretrain_examples,
        pretrain_dataset,
    )
    from item_alignment_torch.data.tokenization import load_text_tokenizer
    from item_alignment_torch.engine.checkpoint import save_params
    from item_alignment_torch.engine.train import Trainer
    from item_alignment_torch.models.bert_legacy import BertForPretraining

    device = resolve_device(args.device)
    tok = load_text_tokenizer(args.vocab_path)
    items = []
    with open(args.item_info, encoding="utf-8") as r:
        for line in r:
            d = json.loads(line)
            d.setdefault("cate_name_path", d.get("cate_path", ""))
            items.append(d)
            if args.max_items and len(items) >= args.max_items:
                break
    rng = pyrandom.Random(args.seed)
    examples = []
    for item in items:
        examples.extend(build_pretrain_examples(
            item, tok, args.max_seq_len, items, rng, args.n_negatives))
    logger.info(f"[bert-pretrain] {len(examples)} examples from "
                f"{len(items)} items")
    cfg = _legacy_config(args, vocab_size=len(tok), type_vocab_size=5,
                         dtype="bfloat16" if args.bf16 else "float32")
    ds = pretrain_dataset(examples, cfg)
    model = BertForPretraining(cfg, device=device, seed=args.seed)
    bs = min(args.batch_size, len(ds))
    tcfg = _train_config(args, max(len(ds) // bs, 1), batch_size=bs)
    trainer = Trainer(model, tcfg, device=device, log_dir=args.log_dir)
    result = trainer.fit(ds)

    os.makedirs(args.output_dir, exist_ok=True)
    save_params(os.path.join(args.output_dir, "bert_pretrain.pt"),
                trainer._host_params())
    print(json.dumps({"final_loss": result["history"][-1]["loss"],
                      "examples": len(examples)}))
    return 0


def cmd_pred_bert(argv: List[str]) -> int:
    """The legacy member's scores for jsonl pair rows: P(same) =
    softmax(logits)[:, 1] of ``BertAlignModel``, written in the submission
    format (the JAX CLI's code; its docstring's sigmoid of the sim-eval
    weight is not what it computes).  A failed kernel build or launch
    raises: there is no fallback to plain attention."""
    p = argparse.ArgumentParser(prog="ia-torch pred-bert")
    p.add_argument("--test_file", required=True)
    p.add_argument("--vocab_path", required=True)
    p.add_argument("--params", required=True,
                   help="bert_align.pt or bert_align.msgpack")
    p.add_argument("--config_file", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--threshold", type=float, default=0.4)
    p.add_argument("--batch_size", type=int, default=8)
    _device_flag(p)
    args = p.parse_args(argv)

    from item_alignment_torch.data.bert_data import (
        align_kwargs,
        pairs_to_field_dataset,
    )
    from item_alignment_torch.data.tokenization import load_text_tokenizer
    from item_alignment_torch.models.bert_legacy import BertAlignModel

    device = resolve_device(args.device)
    tok = load_text_tokenizer(args.vocab_path)
    cfg = _legacy_config(args, vocab_size=len(tok))
    model = BertAlignModel(cfg, device=device, seed=None).eval()
    model.load_state_dict(_load_param_file(args.params))

    rows = _read_jsonl(args.test_file)
    for r in rows:
        r.setdefault("item_label", 0)
    ds = pairs_to_field_dataset(rows, tok, config=cfg)
    bs = min(args.batch_size, len(ds))
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    i = 0
    with open(args.output, "w", encoding="utf-8") as w, \
            torch.inference_mode():
        for batch, meta in ds.batches(bs):
            batch.pop("labels")
            feed = align_kwargs({k: torch.from_numpy(v).long().to(device)
                                 for k, v in batch.items()})
            probs = retry_transient(
                lambda f=feed: model(**f).probs.float().cpu().numpy())
            for prob in probs[: meta["n_valid"]]:
                row = rows[i]
                w.write(json.dumps({
                    "src_item_id": row.get("src_item_id", ""),
                    "src_item_emb": "[0]",
                    "tgt_item_id": row.get("tgt_item_id", ""),
                    "tgt_item_emb": f"[{float(prob)}]",
                    "threshold": args.threshold}) + "\n")
                i += 1
    print(json.dumps({"output": args.output, "pairs": i}))
    return 0


def cmd_build_graph(argv: List[str]) -> int:
    """The GCN's inputs, on the host (the JAX CLI's ``build-graph``): the
    item/attribute adjacency (item <-> its category value, industry value
    and each pv value, both ways; the reference's data_prepare.py:655-731),
    deduplicated, normalised with self loops, sorted by destination, with
    its transpose (``edges.npz``), and the labelled pairs with their node
    ids split into ``item_train_valid_pair.jsonl`` and
    ``item_train_train_pair.jsonl``."""
    p = argparse.ArgumentParser(prog="ia-torch build-graph")
    p.add_argument("--item_info", required=True)
    p.add_argument("--entity2id", required=True)
    p.add_argument("--train_pairs", required=True,
                   help="item_train_pair.jsonl")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--valid_proportion", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pad_to", type=int, default=None,
                   help="pad the edge list to a static size")
    args = p.parse_args(argv)

    import random as pyrandom

    from item_alignment_torch.data.prepare import load_item_info
    from item_alignment_torch.data.tokenization import load_kg_tokenizers
    from item_alignment_torch.ops.sparse import (
        normalize_adjacency,
        pad_edges,
        sort_edges_by_dst,
        transpose_edges,
    )

    ents, _ = load_kg_tokenizers(args.entity2id, args.entity2id)
    n_nodes = max(ents.values()) + 1
    src, dst = [], []

    def connect(i: int, tail_key: str) -> None:
        j = ents.get(tail_key)
        if j is not None:
            src.extend((i, j))
            dst.extend((j, i))

    n_items = 0
    id_dict, _, _ = load_item_info(args.item_info)
    for item_id, d in id_dict.items():
        head = f"/item/{item_id}"
        if head not in ents:
            continue
        n_items += 1
        i = ents[head]
        connect(i, f"/value/{d['cate_name']}-{d['cate_id']}")
        connect(i, f"/value/{d['industry_name']}")
        for vals in (d.get("pvs") or {}).values():
            for v in vals:
                connect(i, f"/value/{v}")
    edge_index = np.stack([np.asarray(src, np.int64),
                           np.asarray(dst, np.int64)])
    # shared pv values repeat across an item's skus
    edge_index = np.unique(edge_index, axis=1)
    ei, ew = normalize_adjacency(edge_index, n_nodes)
    ti, tw = transpose_edges(ei, ew)
    ei, ew = sort_edges_by_dst(ei, ew)
    if args.pad_to:
        ei, ew = pad_edges(ei, ew, args.pad_to, pad_dst=n_nodes - 1)
        ti, tw = pad_edges(ti, tw, args.pad_to, pad_dst=n_nodes - 1)
    os.makedirs(args.output_dir, exist_ok=True)
    edges_path = os.path.join(args.output_dir, "edges.npz")
    np.savez_compressed(edges_path, edge_index=ei, edge_weight=ew,
                        edge_index_t=ti, edge_weight_t=tw,
                        sorted_by_dst=np.bool_(True),
                        n_nodes=np.int64(n_nodes))

    e2idx = {k[len("/item/"):]: v for k, v in ents.items()
             if k.startswith("/item/")}
    rows = []
    for d in _read_jsonl(args.train_pairs):
        d["src_idx"] = e2idx[d["src_item_id"]]
        d["tgt_idx"] = e2idx[d["tgt_item_id"]]
        rows.append(d)
    pyrandom.Random(args.seed).shuffle(rows)
    n_valid = int(len(rows) * args.valid_proportion)
    out_files = {}
    for name, chunk in (("item_train_valid_pair.jsonl", rows[:n_valid]),
                        ("item_train_train_pair.jsonl", rows[n_valid:])):
        with open(os.path.join(args.output_dir, name), "w",
                  encoding="utf-8") as w:
            for d in chunk:
                w.write(json.dumps(d, ensure_ascii=False) + "\n")
        out_files[name] = len(chunk)
    print(json.dumps({"edges": edges_path, "n_nodes": n_nodes,
                      "n_items": n_items,
                      "n_edges": int(edge_index.shape[1]), **out_files}))
    return 0


def _graph_pairs(path: str):
    """(src_idx, tgt_idx, item_label) int arrays of a pair jsonl."""
    rows = _read_jsonl(path)
    return (np.asarray([int(d["src_idx"]) for d in rows], np.int64),
            np.asarray([int(d["tgt_idx"]) for d in rows], np.int64),
            np.asarray([int(d.get("item_label", 0)) for d in rows], np.int64))


def load_graph(edges_path: str, n_nodes: int, edge_chunk: Optional[int],
               device):
    """``edges.npz`` as an ``ops/sparse.Adjacency`` on ``device``: its
    transpose list when it has one, both padded to a multiple of
    ``edge_chunk`` with zero-weight edges (into the last node for a
    dst-sorted list, node 0 otherwise), as the JAX CLI pads them."""
    from item_alignment_torch.ops.sparse import Adjacency, pad_edges

    with np.load(edges_path) as z:
        ez = {k: z[k] for k in z.files}
    ei, ew = ez["edge_index"], ez["edge_weight"]
    sorted_edges = bool(ez.get("sorted_by_dst", False))
    trans = ((ez["edge_index_t"], ez["edge_weight_t"])
             if "edge_index_t" in ez else None)
    if edge_chunk and ei.shape[1] % edge_chunk:
        target = -(-ei.shape[1] // edge_chunk) * edge_chunk
        pad_dst = n_nodes - 1 if sorted_edges else 0
        ei, ew = pad_edges(ei, ew, target, pad_dst=pad_dst)
        if trans is not None:
            trans = pad_edges(*trans, target, pad_dst=pad_dst)
    return Adjacency(ei, ew, n_nodes, edge_chunk, trans, device)


def graph_adam(model, learning_rate: float):
    """optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8, no weight decay, a
    constant rate) over ``model``'s parameters."""
    from item_alignment_torch.engine.optim import FusedAdamW

    return FusedAdamW(dict(model.named_parameters()),
                      lambda _: learning_rate, 0.9, 0.999, 1e-8, 0.0, {})


def gcn_train_step(model, adam, features, adj, src, tgt, labels,
                   dropout_seed) -> torch.Tensor:
    """One ``finetune-graph`` step over the whole graph: forward on the
    pair batch, backward, the Adam update; returns the loss."""
    model.zero_grad(set_to_none=True)
    out = model(features, adj, src, tgt, labels=labels, deterministic=False,
                dropout_seed=dropout_seed)
    out.loss.backward()
    params = adam.params
    upd = adam.update({n: torch.zeros_like(q) if q.grad is None else q.grad
                       for n, q in params.items()})
    with torch.no_grad():
        torch._foreach_add_(list(params.values()), [upd[n] for n in params])
    return out.loss.detach()


def cmd_finetune_graph(argv: List[str]) -> int:
    """GCNII over the whole graph (the reference's finetune_graph.py): the
    node features (``pred-text``'s matrix) and ``build-graph``'s edges and
    pairs; Adam (optax's ``adam``: no weight decay), each epoch in
    ``RandomState(epoch)``'s order with the last partial batch dropped;
    best-F1 on ``--valid_pairs``.  Prints ``{final_loss, best_f1,
    best_threshold}`` and writes ``gcn_params.pt``."""
    p = argparse.ArgumentParser(prog="ia-torch finetune-graph")
    p.add_argument("--feature_matrix", required=True, help=".npy [N, F]")
    p.add_argument("--edges", required=True,
                   help=".npz with edge_index [2,E] and edge_weight [E]")
    p.add_argument("--train_pairs", required=True,
                   help="jsonl rows {src_idx, tgt_idx, item_label}")
    p.add_argument("--valid_pairs", default=None)
    p.add_argument("--output_dir", default="output/gcn")
    p.add_argument("--gcn_hidden", type=int, default=128)
    p.add_argument("--gcn_layers", type=int, default=4)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--learning_rate", type=float, default=1e-2)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--edge_chunk", type=int, default=None,
                   help="sum the edge list in chunks of this size (bounds "
                        "the [chunk, hidden] message buffer)")
    p.add_argument("--scan_layers", action="store_true",
                   help="the JAX CLI's flag, accepted as train.sh step 9 "
                        "passes it: the port always stacks the layers' "
                        "kernels in one parameter")
    _device_flag(p)
    args = p.parse_args(argv)

    from item_alignment_torch.engine import metrics as M
    from item_alignment_torch.engine.checkpoint import save_params
    from item_alignment_torch.engine.train import step_seed
    from item_alignment_torch.models.graph import GCNTwoTower

    device = resolve_device(args.device)
    feats = np.load(args.feature_matrix)
    adj = load_graph(args.edges, feats.shape[0], args.edge_chunk, device)
    features = torch.from_numpy(feats.astype(np.float32, copy=False)).to(
        device)
    tr_src, tr_tgt, tr_lab = _graph_pairs(args.train_pairs)
    cfg = ModelConfig(model_name="gcn", gcn_hidden=args.gcn_hidden,
                      gcn_layers=args.gcn_layers,
                      gcn_feature_dim=feats.shape[1])
    # the JAX CLI's seeds: PRNGKey(0) for the weights, 1 for the dropout
    model = GCNTwoTower(cfg, device=device, seed=0)
    adam = graph_adam(model, args.learning_rate)
    bs = min(args.batch_size, len(tr_src))

    def on_device(a):
        return torch.from_numpy(a).to(device)

    loss, step = None, 0
    for epoch in range(args.epochs):
        order = np.random.RandomState(epoch).permutation(len(tr_src))
        for s0 in range(0, len(order) - bs + 1, bs):
            idx = order[s0:s0 + bs]
            loss = gcn_train_step(model, adam, features, adj,
                                  on_device(tr_src[idx]),
                                  on_device(tr_tgt[idx]),
                                  on_device(tr_lab[idx]),
                                  step_seed(1, step))
            step += 1
        if epoch % 10 == 0 and loss is not None:
            logger.info(f"[gcn] epoch {epoch} loss {float(loss):.4f}")

    result = {"final_loss": None if loss is None else float(loss)}
    if args.valid_pairs:
        v_src, v_tgt, v_lab = _graph_pairs(args.valid_pairs)
        pad = (-len(v_src)) % bs
        vs = np.concatenate([v_src, np.zeros(pad, np.int64)])
        vt = np.concatenate([v_tgt, np.zeros(pad, np.int64)])
        probs = []
        with torch.inference_mode():
            for s0 in range(0, len(vs), bs):
                probs.append(model(features, adj, on_device(vs[s0:s0 + bs]),
                                   on_device(vt[s0:s0 + bs])).probs.cpu())
        probs = torch.cat(probs).numpy()[:len(v_src)]
        f1, _, _, thr = M.find_best_f1_and_threshold(v_lab, probs)
        result.update(best_f1=f1, best_threshold=thr)
    save_params(os.path.join(args.output_dir, "gcn_params.pt"),
                model.state_dict())
    print(json.dumps(result))
    return 0


def cmd_coca_pretrain(argv: List[str]) -> int:
    """CoCa caption + contrastive pretraining (the reference's
    coca_pretrain.py) on ``.npz`` shards of ``input_ids``,
    ``attention_mask`` and ``images`` (uint8 images stay uint8 and are
    normalised on the device); writes ``coca_pretrain.pt``."""
    p = argparse.ArgumentParser(prog="ia-torch coca-pretrain")
    p.add_argument("--shards", nargs="+", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--config_file", default=None)
    p.add_argument("--vocab_size", type=int, default=21128)
    p.add_argument("--hidden_size", type=int, default=768)
    p.add_argument("--num_hidden_layers", type=int, default=12)
    p.add_argument("--num_attention_heads", type=int, default=12)
    p.add_argument("--intermediate_size", type=int, default=3072)
    p.add_argument("--multimodal_depth", type=int, default=12)
    p.add_argument("--coca_heads", type=int, default=8)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    _engine_flags(p)
    args = p.parse_args(argv)
    maybe_initialize_distributed_from_args(args)

    from item_alignment_torch.data.datasets import ArrayDataset
    from item_alignment_torch.engine.checkpoint import save_params
    from item_alignment_torch.engine.train import Trainer
    from item_alignment_torch.models.multimodal import CoCaForPretraining

    device = resolve_device(args.device)
    kw = dict(model_name="coca", vocab_size=args.vocab_size,
              hidden_size=args.hidden_size,
              num_hidden_layers=args.num_hidden_layers,
              num_attention_heads=args.num_attention_heads,
              intermediate_size=args.intermediate_size,
              multimodal_depth=args.multimodal_depth,
              coca_heads=args.coca_heads, image_size=args.image_size,
              dtype="bfloat16" if args.bf16 else "float32")
    cfg = (ModelConfig.from_json(args.config_file, **kw)
           if args.config_file else ModelConfig(**kw))
    arrays = {}
    for key in ("input_ids", "attention_mask", "images"):
        parts = []
        for path in args.shards:
            with np.load(path) as z:
                parts.append(z[key])
        arrays[key] = np.concatenate(parts)
    for key in ("input_ids", "attention_mask"):
        arrays[key] = arrays[key].astype(np.int32)
    if arrays["images"].dtype != np.uint8:
        # float shards arrive normalised; uint8 ones stay uint8
        arrays["images"] = arrays["images"].astype(np.float32)
    ds = ArrayDataset(arrays)
    model = CoCaForPretraining(cfg, device=device, seed=args.seed)
    bs = min(args.batch_size, len(ds))
    trainer = Trainer(model, _train_config(args, max(len(ds) // bs, 1),
                                           batch_size=bs),
                      device=device, log_dir=args.log_dir)
    result = trainer.fit(ds)
    save_params(os.path.join(args.output_dir, "coca_pretrain.pt"),
                trainer._host_params())
    print(json.dumps({"final_loss": result["history"][-1]["loss"]}))
    return 0


COMMANDS = {
    "prepare": cmd_prepare,
    "build-graph": cmd_build_graph,
    "finetune-text": cmd_finetune_text,
    "finetune-image": cmd_finetune_image,
    "finetune-multimodal": cmd_finetune_multimodal,
    "finetune-graph": cmd_finetune_graph,
    "finetune-bert": cmd_finetune_bert,
    "bert-pretrain": cmd_bert_pretrain,
    "coca-pretrain": cmd_coca_pretrain,
    "pkgm-pretrain": cmd_pkgm_pretrain,
    "pred-text": cmd_pred_text,
    "pred-bert": cmd_pred_bert,
    "mine": cmd_mine,
    "model-soup": cmd_model_soup,
    "ensemble": cmd_ensemble,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: ia-torch <command> [flags]\ncommands: "
              + ", ".join(sorted(COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd}\ncommands: "
              + ", ".join(sorted(COMMANDS)), file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
