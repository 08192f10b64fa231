"""Train / eval / predict engine.

Port of ``item_alignment_tpu/engine/train.py:Trainer``.  A train step is the
model's forward with ``deterministic=False``, ``loss.backward()`` and the
optimizer chain of ``engine/optim.py``; PyTorch runs it eagerly on one
device (``"cuda"`` unless the caller asks for the CPU).  The step's dropout
seed is a pure function of ``(config.seed, step)``, so a run is reproduced
from its config, and ``step`` stands in for the JAX train state's
``dropout_rng`` in a checkpoint.

With ``config.checkpoint_dir``, ``fit`` saves the full train state every
``checkpoint_every_epochs`` epochs through ``engine/checkpoint.py``
(parameters, optimizer moments and step count, ``step``, and the loop's
bookkeeping), keeps the best-F1 parameters in ``best_f1.pt`` beside them,
and with ``config.resume`` continues from the latest checkpoint.

Not ported yet, and raising: a mesh of more than one device (ROADMAP Queue
1 #17) and adversarial training (Queue 1 #10).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from item_alignment_torch.config import TrainConfig
from item_alignment_torch.data.datasets import ArrayDataset
from item_alignment_torch.device import resolve_device
from item_alignment_torch.engine import metrics as M
from item_alignment_torch.engine.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from item_alignment_torch.engine.optim import Optimizer, make_optimizer
from item_alignment_torch.ops.dropout import fold_seed

logger = logging.getLogger("item_alignment_torch")


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of training step ``step``."""
    return fold_seed(seed, step)


def _loss_of(out) -> torch.Tensor:
    """Module outputs: PairClassifierOutput / dict / bare scalar."""
    if hasattr(out, "loss"):
        return out.loss
    if isinstance(out, dict):
        return out["loss"]
    return out


class Trainer:
    """Drives a model over an ``ArrayDataset``.

    The model's ``forward`` takes the batch's array keys as keyword
    arguments plus ``deterministic=`` and ``dropout_seed=`` and returns a
    ``PairClassifierOutput`` (or a {"loss": ...} dict, or a bare loss);
    ``batch_transform`` adapts batches (a dict of tensors on the device) for
    other signatures."""

    def __init__(self, model: nn.Module, config: TrainConfig, device=None,
                 batch_transform: Optional[Callable] = None,
                 adversarial=None):
        mesh = config.mesh
        if mesh.data not in (-1, 1) or mesh.fsdp > 1 or mesh.tensor > 1:
            raise NotImplementedError(
                "the port's Trainer runs on one device; data/fsdp/tensor "
                "meshes are ROADMAP Queue 1 #17")
        if adversarial:
            raise NotImplementedError(
                "adversarial training needs the port of engine/adversarial.py "
                "(ROADMAP Queue 1 #10)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.batch_transform = batch_transform or (lambda b: b)
        self.optimizer: Optional[Optimizer] = None
        self.step = 0
        self.best_params: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------- setup
    def setup(self) -> "Trainer":
        self.optimizer = make_optimizer(self.config.optimizer,
                                        dict(self.model.named_parameters()))
        return self

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v))
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(self.device, non_blocking=True)
        return self.batch_transform(out)

    def train_step(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One step on a host batch; returns the loss (still on the
        device, so the host does not wait)."""
        if self.optimizer is None:
            self.setup()
        out = self.model(**self._device_batch(batch), deterministic=False,
                         dropout_seed=step_seed(self.config.seed, self.step))
        loss = _loss_of(out)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
        return loss.detach()

    # ------------------------------------------------------------- loops
    def train_epoch(self, dataset: ArrayDataset, epoch: int = 0,
                    valid_ds: Optional[ArrayDataset] = None
                    ) -> Dict[str, Any]:
        cfg = self.config
        losses, t0 = [], time.time()
        steps = 0
        mid_evals = []
        loss = None
        # drop_last: the padded partial batch would duplicate rows into the
        # gradient; shuffling re-covers the dropped tail across epochs
        for batch, _ in dataset.batches(cfg.train_batch_size, shuffle=True,
                                        seed=cfg.seed + epoch, drop_last=True):
            loss = self.train_step(batch)
            steps += 1
            if steps % cfg.log_steps == 0:
                losses.append(float(loss))
                logger.info(f"epoch {epoch} step {steps} loss {losses[-1]:.4f} "
                            f"({(time.time() - t0) / steps:.3f}s/step)")
            if (cfg.eval_every_steps and valid_ds is not None
                    and steps % cfg.eval_every_steps == 0):
                ev = self.evaluate(valid_ds)
                mid_evals.append({"step": steps, "best_f1": ev.get("best_f1")})
                logger.info(f"epoch {epoch} step {steps} "
                            f"eval f1 {ev.get('best_f1', float('nan')):.4f}")
        out = {"epoch": epoch, "steps": steps,
               "loss": float(loss) if steps else float("nan"),
               "wall_s": time.time() - t0}
        if mid_evals:
            out["mid_evals"] = mid_evals
        return out

    @torch.no_grad()
    def _eval_outputs(self, batch: Dict[str, np.ndarray]):
        out = self.model(**self._device_batch(batch), deterministic=True)
        return tuple(x.float().cpu().numpy()
                     for x in (out.probs, out.src_embeds, out.tgt_embeds))

    def evaluate(self, dataset: ArrayDataset) -> Dict[str, Any]:
        cfg = self.config
        probs_all, labels_all = [], []
        for batch, meta in dataset.batches(cfg.eval_batch_size):
            labels = batch.pop("labels", None)
            probs = self._eval_outputs(batch)[0]
            n = meta["n_valid"]
            probs_all.append(probs[:n])
            if labels is not None:
                labels_all.append(np.asarray(labels)[:n])
        probs = np.concatenate(probs_all) if probs_all else np.zeros(0)
        result: Dict[str, Any] = {"probs": probs}
        if labels_all:
            labels = np.concatenate(labels_all)
            sweep = M.threshold_sweep(labels, probs, cfg.eval_thresholds)
            best_f1, best_p, best_r, best_thr = M.find_best_f1_and_threshold(
                labels, probs)
            result.update(labels=labels, sweep=sweep, best_f1=best_f1,
                          best_precision=best_p, best_recall=best_r,
                          best_threshold=best_thr)
        return result

    def predict_jsonl(self, dataset: ArrayDataset, path: str,
                      threshold: Optional[float] = None) -> str:
        """Predictions in the reference submission format: probabilities
        written as 1-d "embeddings"; the scorer reads ``tgt_item_emb[0]``."""
        cfg = self.config
        threshold = cfg.threshold if threshold is None else threshold
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as w:
            for batch, meta in dataset.batches(cfg.eval_batch_size):
                batch.pop("labels", None)
                _, src_emb, tgt_emb = self._eval_outputs(batch)
                n = meta["n_valid"]
                src_ids = meta.get("src_item_id", [""] * n)
                tgt_ids = meta.get("tgt_item_id", [""] * n)
                for i in range(n):
                    se = ",".join(str(x) for x in np.atleast_1d(src_emb[i]))
                    te = ",".join(str(x) for x in np.atleast_1d(tgt_emb[i]))
                    row = {"src_item_id": src_ids[i], "src_item_emb": f"[{se}]",
                           "tgt_item_id": tgt_ids[i], "tgt_item_emb": f"[{te}]",
                           "threshold": threshold}
                    w.write(json.dumps(row) + "\n")
        return path

    # -------------------------------------------------- checkpoint/resume
    def _host_params(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().cpu().clone()
                for k, v in self.model.state_dict().items()}

    def save_checkpoint(self, manager: CheckpointManager, epoch: int,
                        best_f1: float = 0.0, best_epoch: int = -1,
                        best_threshold: float = 0.5,
                        stale_evals: int = 0) -> None:
        """Full train-state checkpoint: parameters, optimizer moments (in
        their storage dtype) and step count, ``step`` (which fixes every
        later dropout seed) and the loop's bookkeeping."""
        if self.optimizer is None:
            self.setup()
        manager.save(self.step, {
            "params": self.model.state_dict(),
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
            "meta": {"epoch": int(epoch), "best_f1": float(best_f1),
                     "best_epoch": int(best_epoch),
                     "best_threshold": float(best_threshold),
                     "stale_evals": int(stale_evals)},
        })

    def restore_checkpoint(self, manager: CheckpointManager,
                           step: Optional[int] = None) -> Dict[str, Any]:
        """Restore the full train state in place; returns the loop's
        bookkeeping."""
        if self.optimizer is None:
            self.setup()
        tree = manager.restore(step)
        self.model.load_state_dict(tree["params"])
        self.optimizer.load_state_dict(tree["opt_state"])
        self.step = int(tree["step"])
        meta = tree["meta"]
        logger.info(f"[resume] restored step {self.step} (epoch "
                    f"{meta['epoch']}, best_f1 {meta['best_f1']:.4f})")
        return meta

    def fit(self, train_ds: ArrayDataset,
            valid_ds: Optional[ArrayDataset] = None) -> Dict[str, Any]:
        """Epoch loop with threshold-sweep eval, best-F1 tracking (the best
        parameters land in ``best_params``), optional early stopping, and
        full-state checkpoint/resume when ``config.checkpoint_dir`` is
        set."""
        cfg = self.config
        history = []
        best: Dict[str, Any] = {"best_f1": 0.0, "epoch": -1, "params": None}
        stale_evals = 0
        start_epoch = 0
        manager = None
        if cfg.checkpoint_dir:
            manager = CheckpointManager(cfg.checkpoint_dir,
                                        keep=cfg.keep_checkpoints)
            best_path = os.path.join(cfg.checkpoint_dir, "best_f1.pt")
            if cfg.resume and manager.latest_step() is not None:
                meta = self.restore_checkpoint(manager)
                start_epoch = int(meta["epoch"]) + 1
                stale_evals = int(meta["stale_evals"])
                best = {"best_f1": float(meta["best_f1"]),
                        "epoch": int(meta["best_epoch"]),
                        "threshold": float(meta["best_threshold"]),
                        "params": None}
                if best["epoch"] >= 0 and os.path.exists(best_path):
                    best["params"] = load_params(best_path)
        for epoch in range(start_epoch, cfg.num_epochs):
            stats = self.train_epoch(train_ds, epoch, valid_ds)
            stop = False
            if valid_ds is not None:
                ev = self.evaluate(valid_ds)
                stats.update(best_f1=ev.get("best_f1"),
                             best_threshold=ev.get("best_threshold"))
                if ev.get("best_f1", 0.0) > best["best_f1"]:
                    best = {"best_f1": ev["best_f1"], "epoch": epoch,
                            "threshold": ev.get("best_threshold"),
                            "params": self._host_params()}
                    stale_evals = 0
                    if manager is not None:
                        save_params(best_path, best["params"])
                else:
                    stale_evals += 1
                logger.info(f"epoch {epoch}: loss {stats['loss']:.4f} "
                            f"f1 {ev.get('best_f1', float('nan')):.4f}")
                if (cfg.early_stopping_patience is not None
                        and stale_evals >= cfg.early_stopping_patience):
                    logger.info(f"early stopping after {stale_evals} stale evals")
                    stop = True
            history.append(stats)
            if (manager is not None
                    and (epoch + 1) % cfg.checkpoint_every_epochs == 0):
                self.save_checkpoint(
                    manager, epoch, best_f1=best["best_f1"],
                    best_epoch=best["epoch"],
                    best_threshold=best.get("threshold") or 0.5,
                    stale_evals=stale_evals)
            if stop:
                break
        best_params = best.pop("params", None)
        if best_params is not None:
            self.best_params = best_params
        return {"history": history, "best": best}
