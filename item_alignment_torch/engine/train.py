"""Train / eval / predict engine.

Port of ``item_alignment_tpu/engine/train.py:Trainer``.  A train step is the
model's forward with ``deterministic=False``, ``loss.backward()`` and the
optimizer chain of ``engine/optim.py``; PyTorch runs it eagerly on one
device (``"cuda"`` unless the caller asks for the CPU).  The step's dropout
seed is a pure function of ``(config.seed, step)``, so a run is reproduced
from its config, and ``step`` stands in for the JAX train state's
``dropout_rng`` in a checkpoint.

``train_epoch`` runs an epoch in chunks of ``config.scan_steps`` steps,
as the JAX ``Trainer`` runs one ``lax.scan`` a chunk: the chunk size is
lowered until it divides ``eval_every_steps``, full chunks run first and
the remainder one step at a time.  A chunk's batches are stacked to
``[K, B, ...]`` in pinned host memory and go to the device in one
non-blocking copy per key; the host reads a loss only at a chunk end that
crosses a multiple of ``log_steps``, and evaluates at chunk ends.  Each
step is the step ``train_step`` runs, with its own seeds, so any
``scan_steps`` gives the same parameters as ``scan_steps=1``.

With ``config.checkpoint_dir``, ``fit`` saves the full train state every
``checkpoint_every_epochs`` epochs through ``engine/checkpoint.py``
(parameters, optimizer moments and step count, ``step``, and the loop's
bookkeeping), keeps the best-F1 parameters in ``best_f1.pt`` beside them,
and with ``config.resume`` continues from the latest checkpoint.  With
``log_dir``, the train loss logged at chunk ends and each epoch's eval go
to ``scalars.jsonl`` and ``eval_results.csv`` there, as in the JAX
``Trainer``.

``adversarial=(mode, epsilon, alpha)`` with ``noise_spec={kwarg: (L, H)}``
trains with FREE/PGD/MIX embedding noise (``engine/adversarial.py``), as
the JAX ``Trainer`` does: one delta ``[train_batch_size, L, H]`` per
``noise_spec`` entry, zero at the start, is passed to the model as that
keyword argument; it is a leaf tensor whose gradient comes from the step's
one ``backward()``, it is not given to the optimizer, and after the step it
is updated from that gradient with draws seeded from ``(config.seed,
step)``.  The deltas are part of the train-state checkpoint.

Under a process group (``parallel/mesh.py``, one process per device) the
``Trainer`` takes its mesh from ``config.mesh`` and, before it builds the
optimizer, shards the model by the rules of ``parallel/sharding.py``
(tensor-parallel styles over ``tensor``, FSDP2 over ``data`` and ``fsdp``).
Each rank then takes its data index's rows of every global batch; the
fsdp and tensor ranks of one data index take the same rows, as JAX's
``P("data")``.  The dropout masks are those of the global batch, sliced
(``ops.dropout.batch_rows``), so a sharded step equals one device's step on
the same batch.  The adversarial deltas stay whole on every rank (JAX's
replicated train state): their gradient's rows are all-reduced over
``data``.  The reported loss is the mean over the data ranks, eval outputs
are gathered to every rank, ``best_params`` and checkpoints hold whole
tensors (rank 0 writes them) and a checkpoint restores onto any mesh.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from item_alignment_torch.config import TrainConfig
from item_alignment_torch.data.datasets import ArrayDataset
from item_alignment_torch.device import resolve_device
from item_alignment_torch.engine import metrics as M
from item_alignment_torch.engine.adversarial import MODES, update_deltas
from item_alignment_torch.engine.checkpoint import (
    CheckpointManager,
    is_writer,
    load_params,
    save_params,
)
from item_alignment_torch.engine.observability import (
    EvalWriter,
    ScalarLogger,
    span,
)
from item_alignment_torch.engine.optim import Optimizer, make_optimizer
from item_alignment_torch.ops.dropout import batch_rows, fold_seed
from item_alignment_torch.parallel.mesh import AXIS_DATA, create_mesh
from item_alignment_torch.parallel.sharding import (
    batch_sharding,
    full_state_dict,
    process_slice,
    shard_params,
)
from item_alignment_torch.utils import logger


# the site of the adversarial noise draws under a step's seed, apart from
# the model's dropout sites
NOISE_SITE = 1 << 20


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
                 adversarial: Optional[Tuple[str, float, float]] = None,
                 noise_spec: Optional[Dict[str, Tuple[int, ...]]] = None,
                 log_dir: Optional[str] = None):
        if adversarial:
            if adversarial[0] not in MODES:
                raise ValueError(f"unknown adversarial mode {adversarial[0]}")
            if not noise_spec:
                raise ValueError("adversarial training needs a noise_spec")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.mesh = create_mesh(config.mesh, self.device.type)
        self._sharded = False
        self._rows: Optional[Tuple[int, int, int]] = None
        if self.mesh is not None:
            data = batch_sharding(self.mesh)[1]
            for bs_name in ("train_batch_size", "eval_batch_size"):
                bs = getattr(config, bs_name)
                if bs % data:
                    raise ValueError(
                        f"{bs_name}={bs} must be divisible by the mesh data "
                        f"axis ({data} ranks); adjust the batch size or the "
                        "mesh")
        self.batch_transform = batch_transform or (lambda b: b)
        self.adversarial = adversarial
        self.deltas: Optional[Dict[str, torch.Tensor]] = None
        if adversarial:
            self.deltas = {
                name: torch.zeros((config.train_batch_size,) + tuple(shape),
                                  device=self.device)
                for name, shape in noise_spec.items()}
        self.optimizer: Optional[Optimizer] = None
        self.step = 0
        self.evals = 0  # eval batches answered (the index of their spans)
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        self.scalars = self.eval_writer = None
        if log_dir and is_writer():
            self.scalars = ScalarLogger(os.path.join(log_dir, "scalars.jsonl"))
            self.eval_writer = EvalWriter(
                os.path.join(log_dir, "eval_results.csv"),
                ["epoch", "step", "loss", "best_f1", "best_threshold"])

    # ------------------------------------------------------------- setup
    def shard(self) -> "Trainer":
        """Shard the model on the mesh (once; nothing without a mesh).
        Before it, the model's own ``state_dict`` and ``load_state_dict``
        hold whole tensors as on one device; after it, ``load_state_dict``
        still takes whole tensors and ``_host_params`` gathers them."""
        if self.mesh is not None and not self._sharded:
            shard_params(self.model, self.mesh)
            self._sharded = True
        return self

    def setup(self) -> "Trainer":
        self.shard()
        self.optimizer = make_optimizer(self.config.optimizer,
                                        dict(self.model.named_parameters()))
        return self

    def _stage(self, batches: List[Dict[str, np.ndarray]]
               ) -> Dict[str, torch.Tensor]:
        """K host batches on the device as ``[K, B, ...]`` tensors: ids and
        labels as int64, floats and uint8 images as they are (the image
        towers normalise uint8 on the device; int64 images would move 8x
        the bytes).  On the card each key is stacked in pinned memory and
        copied in one non-blocking transfer; the caching host allocator
        does not hand a pinned block out again before its copy has
        completed.  Under a mesh with a data axis, this rank's rows of each
        batch (``_rows``: their offset, count and the global batch)."""
        with span("stage"):
            self._rows = None
            n = len(next(iter(batches[0].values())))
            rows = slice(0, n)
            if self.mesh is not None and batch_sharding(self.mesh)[1] > 1:
                rows = process_slice(n, mesh=self.mesh)
                self._rows = (rows.start, rows.stop - rows.start, n)
            pin = self.device.type == "cuda"
            out = {}
            for k in batches[0]:
                parts = [torch.as_tensor(np.asarray(b[k])[rows])
                         for b in batches]
                dtype = parts[0].dtype
                if not parts[0].is_floating_point() and dtype != torch.uint8:
                    dtype = torch.long
                host = torch.empty((len(parts),) + parts[0].shape,
                                   dtype=dtype, pin_memory=pin)
                for i, part in enumerate(parts):
                    host[i] = part
                out[k] = host.to(self.device, non_blocking=True)
            return out

    def _device_batch(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """One host batch on the device (``_stage`` of one), through
        ``batch_transform``."""
        return self.batch_transform(
            {k: v[0] for k, v in self._stage([batch]).items()})

    def train_step(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One step on a host batch; returns the loss (still on the
        device, so the host does not wait)."""
        return self._step(self._device_batch(batch))

    def _step(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step on a batch already on the device (its rows under a
        mesh are ``_rows``)."""
        if self.optimizer is None:
            self.setup()
        with span("step", self.step):
            seed = step_seed(self.config.seed, self.step)
            rows = self._rows
            deltas, passed = {}, {}
            if self.deltas is not None:
                deltas = {k: d.detach().requires_grad_()
                          for k, d in self.deltas.items()}
                passed = {k: d if rows is None
                          else d[rows[0]:rows[0] + rows[1]]
                          for k, d in deltas.items()}
            # the backward regenerates the masks, so it runs in the rows too
            with batch_rows(*rows) if rows else contextlib.nullcontext():
                with span("forward"):
                    out = self.model(**inputs, **passed, deterministic=False,
                                     dropout_seed=seed)
                    loss = _loss_of(out)
                with span("backward"):
                    loss.backward()
            if self._sharded and all(
                    p.grad is None for p in self.optimizer.params.values()):
                raise RuntimeError("the sharded model reduced no gradient: "
                                   "FSDP2 found no tensor in the model's "
                                   "output")
            if rows is not None:
                loss = self._data_mean(loss.detach())
                for d in deltas.values():
                    # each data rank holds its rows' share of the mean's
                    # gradient; the sum over the ranks is the whole batch's
                    d.grad = self._data_mean(d.grad)
            with span("optim"):
                self.optimizer.step()
                self.optimizer.zero_grad()
            if deltas:
                mode, epsilon, alpha = self.adversarial
                with torch.no_grad():
                    self.deltas = update_deltas(
                        mode, {k: d.detach() for k, d in deltas.items()},
                        {k: d.grad for k, d in deltas.items()}, epsilon,
                        alpha, seed=fold_seed(seed, NOISE_SITE))
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
        # the chunk divides the eval cadence, so step-based evals fire at
        # the same steps as in the JAX Trainer
        chunk = max(int(cfg.scan_steps), 1)
        if cfg.eval_every_steps:
            while cfg.eval_every_steps % chunk:
                chunk -= 1

        def run_chunk(pending):
            nonlocal steps, loss
            staged = self._stage(pending)
            for i in range(len(pending)):
                loss = self._step(self.batch_transform(
                    {k: v[i] for k, v in staged.items()}))
            prev = steps
            steps += len(pending)
            if steps // cfg.log_steps > prev // cfg.log_steps:
                losses.append(float(loss))
                logger.info(f"epoch {epoch} step {steps} loss {losses[-1]:.4f} "
                            f"({(time.time() - t0) / steps:.3f}s/step)")
                if self.scalars is not None:
                    self.scalars.add_scalar("train/loss", losses[-1],
                                            self.step)
            if (cfg.eval_every_steps and valid_ds is not None
                    and steps % cfg.eval_every_steps == 0):
                ev = self.evaluate(valid_ds)
                mid_evals.append({"step": steps, "best_f1": ev.get("best_f1")})
                logger.info(f"epoch {epoch} step {steps} "
                            f"eval f1 {ev.get('best_f1', float('nan')):.4f}")

        # drop_last: the padded partial batch would duplicate rows into the
        # gradient; shuffling re-covers the dropped tail across epochs
        pending = []
        for batch, _ in dataset.batches(cfg.train_batch_size, shuffle=True,
                                        seed=cfg.seed + epoch, drop_last=True):
            pending.append(batch)
            if len(pending) == chunk:
                run_chunk(pending)
                pending = []
        for batch in pending:  # the remainder, one step a chunk
            run_chunk([batch])
        out = {"epoch": epoch, "steps": steps,
               "loss": float(loss) if steps else float("nan"),
               "wall_s": time.time() - t0}
        if mid_evals:
            out["mid_evals"] = mid_evals
        return out

    def _data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the data ranks (sum, then divide: gloo
        has no average)."""
        t = t.clone()
        dist.all_reduce(t, group=self.mesh[AXIS_DATA].get_group())
        return t / batch_sharding(self.mesh)[1]

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows of ``t`` from every data rank."""
        parts = [torch.empty_like(t)
                 for _ in range(batch_sharding(self.mesh)[1])]
        dist.all_gather(parts, t.contiguous(),
                        group=self.mesh[AXIS_DATA].get_group())
        return torch.cat(parts)

    @torch.no_grad()
    def _eval_outputs(self, batch: Dict[str, np.ndarray]):
        self.shard()
        with span("eval", self.evals):
            self.evals += 1
            out = self.model(**self._device_batch(batch), deterministic=True)
            outs = [x.float()
                    for x in (out.probs, out.src_embeds, out.tgt_embeds)]
            if self._rows is not None:
                outs = [self._gather_rows(x) for x in outs]
            with span("fetch"):
                return tuple(x.cpu().numpy() for x in outs)

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
        writer = is_writer()  # every rank computes; rank 0 writes
        if writer:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with (open(path, "w", encoding="utf-8") if writer
              else contextlib.nullcontext()) as w:
            for batch, meta in dataset.batches(cfg.eval_batch_size):
                batch.pop("labels", None)
                _, src_emb, tgt_emb = self._eval_outputs(batch)
                if not writer:
                    continue
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
        """The model's whole parameters on the CPU (a collective when the
        model is sharded)."""
        return full_state_dict(self.model)

    def save_checkpoint(self, manager: CheckpointManager, epoch: int,
                        best_f1: float = 0.0, best_epoch: int = -1,
                        best_threshold: float = 0.5,
                        stale_evals: int = 0) -> None:
        """Full train-state checkpoint: parameters, optimizer moments (in
        their storage dtype) and step count, ``step`` (which fixes every
        later dropout seed and noise draw), the adversarial deltas when
        there are any, and the loop's bookkeeping."""
        if self.optimizer is None:
            self.setup()
        tree = {
            "params": self._host_params(),
            "opt_state": self.optimizer.state_dict(),
            "step": self.step,
            "meta": {"epoch": int(epoch), "best_f1": float(best_f1),
                     "best_epoch": int(best_epoch),
                     "best_threshold": float(best_threshold),
                     "stale_evals": int(stale_evals)},
        }
        if self.deltas is not None:
            # without them a resumed run restarts from zero noise and leaves
            # the uninterrupted run's path
            tree["deltas"] = self.deltas
        manager.save(self.step, tree)

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
        if self.deltas is not None:
            self.deltas = {k: tree["deltas"][k].to(self.device)
                           for k in self.deltas}
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
                if self.eval_writer is not None:
                    self.eval_writer.write(
                        epoch=epoch, step=self.step, loss=stats["loss"],
                        best_f1=ev.get("best_f1"),
                        best_threshold=ev.get("best_threshold"))
                if self.scalars is not None:
                    self.scalars.add_scalar("eval/best_f1",
                                            ev.get("best_f1", 0.0), self.step)
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
