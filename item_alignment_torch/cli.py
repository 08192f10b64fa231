"""Command-line interface of the port, ``ia-torch``.

    ia-torch <command> [flags]        (or python -m item_alignment_torch.cli)

Port of ``item_alignment_tpu/cli.py`` for the main path:

- ``prepare``        item_info / pair jsonl -> KG files and finetune TSVs
  (text only);
- ``finetune-text``  RoBERTa and PKGM, one-tower and two-tower: train,
  eval, predict (PKGM takes ``--entity2id``/``--relation2id`` and merges
  ``pkgm_model.bin`` beside ``pytorch_model.bin``);
- ``mine``           encode each item once, score a candidate-pair list
  against the cache (``--quant int8``, ``--cache_quant int8``);
- ``pred-text``      the pooled entity-feature matrix for the GCN;
- ``pkgm-pretrain``  KGE pretraining on the KG files (``kge/``), writing
  ``kge_final.npz``.

Flags are the JAX CLI's, so the same command lines run, with one more:
``--device {cuda,cpu}`` (default ``cuda``; without a GPU the default
raises).  The port writes and reads its own parameter files, ``.pt``
state dicts (``best_f1.pt``, ``text_finetune_epoch-N.pt``); a ``.msgpack``
file raises, pointing at ROADMAP Queue 1 #14.  ``--scan_steps`` and
``pred-text --scan_chunks/--xfer_guard`` steer XLA's dispatch and do nothing
here.  The other commands and the model families not yet ported raise with
their ROADMAP item.
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
from item_alignment_torch.device import resolve_device
from item_alignment_torch.utils import logger
from item_alignment_torch.utils.retry import retry_transient

MSGPACK_ITEM = "ROADMAP Queue 1 #14: Reading Flax msgpack files"
PARALLEL_ITEM = "ROADMAP Queue 1 #4: Parallelism"
IMAGE_ITEM = "ROADMAP Queue 1 #6: The multimodal RobertaImage one/two-tower"
INERT = "accepted for the JAX CLI's command lines; no effect in the port"


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
                   help="parameters to evaluate or predict with (.pt)")
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
    p.add_argument("--scan_steps", type=int, default=8, help=INERT)
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
                   help="data,fsdp,tensor axis sizes (-1 = rest); the port "
                        "runs on one device")
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
                   help=f"multi-host training; not ported ({PARALLEL_ITEM})")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


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


def _train_config(args, steps_per_epoch: int) -> TrainConfig:
    if args.distributed:
        raise NotImplementedError(
            f"--distributed is not ported yet ({PARALLEL_ITEM})")
    data, fsdp, tensor = (int(x) for x in args.mesh.split(","))
    return TrainConfig(
        seed=args.seed, train_batch_size=args.train_batch_size,
        eval_batch_size=args.eval_batch_size, num_epochs=args.epochs,
        log_steps=args.log_steps, output_dir=args.output_dir,
        threshold=args.threshold,
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
            state_dtype=args.opt_state_dtype),
    )


def _dump_hyperparameters(args, out_dir: str) -> None:
    """hyperparamter.txt dump (finetune_text.py:380-383)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hyperparamter.txt"), "w") as w:
        for k, v in sorted(vars(args).items()):
            w.write(f"{k}={v}\n")


def _load_param_file(path: str):
    """A ``.pt`` state dict written by ``engine/checkpoint.py:save_params``;
    a missing file or a Flax msgpack file raises."""
    from item_alignment_torch.engine.checkpoint import load_params

    if path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: the port reads .pt parameter files; Flax msgpack files "
            f"are not read yet ({MSGPACK_ITEM}). Convert it with "
            "item_alignment_torch.convert.state_dict_from_flax where flax "
            "is installed and save the result with engine.checkpoint."
            "save_params")
    if not os.path.exists(path):
        # predicting with random weights would hand garbage scores on
        raise FileNotFoundError(f"--file_state_dict {path} does not exist")
    return load_params(path)


# ------------------------------------------------------------- commands
def cmd_prepare(argv: List[str]) -> int:
    """Offline preprocessing, text only: the KG files, ``cate2id.json`` and
    the finetune TSVs (``data/prepare.py:prepare_all``)."""
    p = argparse.ArgumentParser(prog="ia-torch prepare")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--valid_proportion", type=float, default=0.1)
    p.add_argument("--num_train_augment", type=int, default=0)
    p.add_argument("--num_neg", type=int, default=5)
    p.add_argument("--prev_valid", default=None)
    p.add_argument("--seed", type=int, default=0)
    for flag in ("--with_image", "--only_image", "--object_detection"):
        p.add_argument(flag, action="store_true",
                       help=f"image pipeline; not ported ({IMAGE_ITEM})")
    args, _ = p.parse_known_args(argv)
    if args.with_image or args.only_image or args.object_detection:
        raise NotImplementedError(
            f"prepare's image pipeline is not ported yet ({IMAGE_ITEM})")
    p.parse_args(argv)  # the image pipeline's flags are the only extras

    from item_alignment_torch.data.prepare import prepare_all

    files = prepare_all(args.data_dir, args.output_dir,
                        valid_proportion=args.valid_proportion,
                        seed=args.seed,
                        num_train_augment=args.num_train_augment,
                        num_neg=args.num_neg, prev_valid=args.prev_valid)
    print(json.dumps(files))
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

    from item_alignment_torch.data.tokenization import (
        load_kg_tokenizers,
        load_text_tokenizer,
        rows_to_one_tower_dataset,
        rows_to_pkgm_dataset,
        rows_to_pkgm_two_tower_dataset,
        rows_to_two_tower_dataset,
    )
    from item_alignment_torch.engine.checkpoint import save_params
    from item_alignment_torch.engine.observability import profile_trace
    from item_alignment_torch.engine.train import Trainer
    from item_alignment_torch.models import build_model

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
    train_rows = _load_tsv_rows(args, args.train_file)
    valid_rows = _load_tsv_rows(args, args.valid_file)

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
        if args.interaction_type == "two_tower":
            return rows_to_two_tower_dataset(rows, tok, cfg.max_seq_len,
                                             cfg.max_seq_len_pv)
        return rows_to_one_tower_dataset(rows, tok, cfg.max_seq_len,
                                         cfg.max_seq_len_pv,
                                         cfg.classification_method,
                                         cfg.auxiliary_task,
                                         cfg.max_pair_indices)

    train_ds = build_ds(train_rows)
    valid_ds = build_ds(valid_rows)
    out_dir = os.path.join(args.output_dir, run_dir_name(args))
    _dump_hyperparameters(args, out_dir)

    steps = train_ds.num_batches(args.train_batch_size) if train_ds else 1
    trainer = Trainer(model, _train_config(args, steps), device=device,
                      log_dir=args.log_dir)
    ready = False  # whether the model holds the weights to evaluate
    if args.do_train:
        if args.pretrained_model_path:
            _load_pretrained(model, cfg, args)
        with profile_trace(args.profile_dir):
            result = trainer.fit(train_ds, valid_ds)
        _save_epoch_params(trainer, out_dir, args.epochs)
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
        test_rows = _load_tsv_rows(args, args.test_file)
        pred_ds = build_ds(test_rows) if test_rows else valid_ds
        if pred_ds is not None and len(pred_ds) > 0:
            if not ready:
                _maybe_restore(trainer, args)
            if args.pred_with_best and trainer.best_params is not None:
                model.load_state_dict(trainer.best_params)
            path = os.path.join(
                out_dir, f"deepAI_result_threshold={args.threshold}.jsonl")
            trainer.predict_jsonl(pred_ds, path, args.threshold)
            print(json.dumps({"prediction_file": path,
                              "prediction_split": "test" if test_rows
                              else "valid"}))
    return 0


def _load_pretrained(model, cfg, args) -> None:
    """HF encoder weights from ``pytorch_model.bin`` under
    ``--pretrained_model_path`` (``utils/hf_import.py``); for a pkgm model,
    merged with the PKGM pretrain tables of ``pkgm_model.bin`` beside it
    when there is one.  Without ``pytorch_model.bin`` nothing is loaded."""
    from item_alignment_torch.models import PKGMBackbone
    from item_alignment_torch.utils import (
        KG_WEIGHTS_NAME,
        ROBERTA_WEIGHTS_NAME,
    )
    from item_alignment_torch.utils.hf_import import (
        import_hf_roberta,
        load_torch_state_dict,
    )

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
                   help="finetune-text two_tower parameters (.pt)")
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
                   help="finetune-text parameters (.pt) over the encoder")
    p.add_argument("--max_seq_len", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--scan_chunks", type=int, default=8, help=INERT)
    p.add_argument("--num_workers", type=int, default=8,
                   help="tokenizer processes (0 = serial)")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="escape hatch for tests and smoke runs")
    p.add_argument("--quant", default=None, choices=["int8"],
                   help="int8 path for the encoder's dense projections")
    p.add_argument("--xfer_guard", action="store_true", help=INERT)
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

    B, n = args.batch_size, len(ids_all)
    feats = []
    with torch.inference_mode():
        for g, s in enumerate(range(0, n, B)):
            ids = torch.from_numpy(ids_all[s: s + B]).long().to(device)
            mask = torch.from_numpy(mask_all[s: s + B]).long().to(device)
            feats.append(retry_transient(
                lambda: pooler(backbone(ids, mask)[-1]).float().cpu().numpy()))
            if (g + 1) % 10 == 0 or s + B >= n:
                logger.info(f"pred-text: {min(s + B, n)}/{n} encoded")
    matrix = np.concatenate(feats) if feats else \
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
                   help="data,fsdp,tensor axis sizes; the port runs on one "
                        f"device, others raise ({PARALLEL_ITEM})")
    _device_flag(p)
    args = p.parse_args(argv)

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


def _not_ported(name: str, item: str):
    def cmd(argv: List[str]) -> int:
        raise NotImplementedError(f"ia-torch {name} is not ported yet ({item})")

    return cmd


REST_OF_CLI = "ROADMAP Queue 1 #13: The rest of the CLI"
COMMANDS = {
    "prepare": cmd_prepare,
    "build-graph": _not_ported("build-graph", REST_OF_CLI),
    "finetune-text": cmd_finetune_text,
    "finetune-image": _not_ported("finetune-image", REST_OF_CLI),
    "finetune-multimodal": _not_ported("finetune-multimodal", REST_OF_CLI),
    "finetune-graph": _not_ported("finetune-graph", REST_OF_CLI),
    "finetune-bert": _not_ported("finetune-bert",
                                 "ROADMAP Queue 1 #7: The legacy BERT model"),
    "bert-pretrain": _not_ported("bert-pretrain", REST_OF_CLI),
    "coca-pretrain": _not_ported("coca-pretrain", REST_OF_CLI),
    "pkgm-pretrain": cmd_pkgm_pretrain,
    "pred-text": cmd_pred_text,
    "pred-bert": _not_ported("pred-bert", REST_OF_CLI),
    "mine": cmd_mine,
    "model-soup": _not_ported("model-soup", REST_OF_CLI),
    "ensemble": _not_ported("ensemble", REST_OF_CLI),
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
