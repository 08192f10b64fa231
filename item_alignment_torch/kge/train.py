"""KGE training loop.

Port of ``item_alignment_tpu/kge/train.py`` (torchkge's ``Trainer``,
``utils/training.py:112-218``, with the reference's knobs,
``pkgm_pretrain.py:81-135``): whole-KG corruption once an epoch, margin
loss, Adam with a linear warmup then a linear decay, gradient accumulation,
``normalize_parameters`` after each epoch, periodic ``.npz`` checkpoints.

As in the JAX package:

- the parameters stay in fp32 (the step is gathers and elementwise work);
- the learning rate is read at the optimizer's count before its increment
  (optax's ``scale_by_schedule``), so the first update has lr 0;
- with ``grad_accumulation_steps`` k > 1 the gradients are averaged over k
  mini-steps and the parameters move on the k-th (``optax.MultiSteps``);
- the batch order of epoch e is ``np.random.RandomState(e).permutation``,
  a KG smaller than a batch wraps by ``np.resize``, and the negatives of a
  step are ``(bidx + i * n_facts) % len(nh)`` for i < n_neg.

The step runs eagerly on one device (``"cuda"`` unless the caller asks for
the CPU); the corrupted ids and the KG's index arrays stay there.  Adam is
the port's ``FusedAdamW`` with no weight decay.

With ``mesh`` (a ``MeshConfig`` or its three sizes) under a process group,
as in JAX: the tables stay whole on every rank, each rank takes its data
index's rows of every triple batch (the whole KG's corruption is drawn
from one seed on every rank, so a rank's negatives are the global batch's,
sliced), and the gradients are all-reduced over ``data`` (a mean loss
weighs each rank's rows by their share of the batch).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from item_alignment_torch.config import MeshConfig, OptimizerConfig
from item_alignment_torch.device import resolve_device
from item_alignment_torch.engine.optim import FusedAdamW, linear_warmup_decay
from item_alignment_torch.kge.graph import KnowledgeGraph
from item_alignment_torch.kge.losses import kge_loss
from item_alignment_torch.kge.models import (
    KGEModel,
    Params,
    params_from_numpy,
    params_to_numpy,
)
from item_alignment_torch.kge.sampling import (
    BernoulliNegativeSampler,
    UniformNegativeSampler,
)
from item_alignment_torch.parallel.mesh import AXIS_DATA, create_mesh
from item_alignment_torch.parallel.sharding import batch_sharding, process_slice
from item_alignment_torch.utils import logger


def _mesh_config(mesh) -> Optional[MeshConfig]:
    """A ``MeshConfig`` from one or a sequence of its axis sizes."""
    if mesh is None or isinstance(mesh, MeshConfig):
        return mesh
    return MeshConfig(*(int(s) for s in mesh))


class KGETrainer:
    def __init__(self, model: KGEModel, kg: KnowledgeGraph,
                 loss_type: str = "margin", margin: float = 1.0,
                 n_neg: int = 3, sampling_type: str = "bernoulli",
                 learning_rate: float = 1e-4, batch_size: int = 32768,
                 n_epochs: int = 100, warmup_proportion: float = 0.1,
                 grad_accumulation_steps: int = 1, seed: int = 0,
                 save_dir: Optional[str] = None, save_epochs: int = 50,
                 mesh=None, device=None):
        self.device = resolve_device(device)
        self.mesh = create_mesh(_mesh_config(mesh), self.device.type)
        if self.mesh is not None and batch_size % batch_sharding(self.mesh)[1]:
            raise ValueError(
                f"batch_size {batch_size} not divisible by the mesh data "
                f"axis ({batch_sharding(self.mesh)[1]})")
        self.model = model
        self.kg = kg
        self.loss_type = loss_type
        self.margin = margin
        self.n_neg = n_neg
        self.batch_size = batch_size
        self.n_epochs = n_epochs
        self.save_dir = save_dir
        self.save_epochs = save_epochs
        self.accumulate = grad_accumulation_steps
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        sampler_cls = (BernoulliNegativeSampler if sampling_type == "bernoulli"
                       else UniformNegativeSampler)
        self.sampler = sampler_cls(kg, n_neg=n_neg, device=self.device)

        steps_per_epoch = max(kg.n_facts // batch_size, 1)
        schedule = linear_warmup_decay(OptimizerConfig(
            learning_rate=learning_rate, warmup_proportion=warmup_proportion,
            total_steps=steps_per_epoch * n_epochs))
        self.params: Params = model.init_params(self.gen)
        self.adam = FusedAdamW(self.params, schedule, b1=0.9, b2=0.999,
                               eps=1e-8, weight_decay=0.0,
                               decay={k: False for k in self.params})
        self.mini_step = 0
        self.acc: Dict[str, torch.Tensor] = {}

    def _step(self, h, t, r, nh, nt) -> torch.Tensor:
        """One mini-step on a batch of facts and their negatives; returns
        the loss, still on the device."""
        leaves = {k: v.detach().requires_grad_() for k, v in
                  self.params.items()}
        pos, neg = self.model.forward(leaves, h, t, r, nh, nt)
        loss = kge_loss(self.loss_type, pos, neg, self.margin)
        if self.mesh is not None and self.loss_type != "margin":
            # a mean over this rank's rows, weighed by their share
            loss = loss / batch_sharding(self.mesh)[1]
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True,
            materialize_grads=True)))
        if self.mesh is not None:
            group = self.mesh[AXIS_DATA].get_group()
            loss = loss.detach().clone()
            for t_ in (loss, *grads.values()):
                dist.all_reduce(t_, group=group)
        with torch.no_grad():
            if self.accumulate > 1:
                n = self.mini_step
                self.acc = {k: g.clone() if n == 0
                            else self.acc[k] + (g - self.acc[k]) / (n + 1)
                            for k, g in grads.items()}
                self.mini_step = (n + 1) % self.accumulate
                if self.mini_step:
                    return loss.detach()
                grads, self.acc = self.acc, {}
            self.adam.step(grads, params=self.params)
        return loss.detach()

    def run(self) -> Dict[str, Any]:
        kg, bs = self.kg, self.batch_size
        h_all, t_all, r_all = self.sampler.kg_arrays
        history = []
        for epoch in range(self.n_epochs):
            t0 = time.time()
            # whole-KG corruption, one vectorized call (torchkge corrupt_kg)
            nh, nt = self.sampler.corrupt_kg_device(self.gen)
            order = np.random.RandomState(epoch).permutation(kg.n_facts)
            n_steps = max(kg.n_facts // bs, 1)
            if kg.n_facts < bs:
                # a KG smaller than a batch: one step over it, wrapped
                order = np.resize(order, bs)
            idx = torch.as_tensor(order[: n_steps * bs].reshape(n_steps, bs),
                                  device=self.device).long()
            losses = []
            if self.mesh is not None:  # this rank's rows of every batch
                idx = idx[:, process_slice(bs, mesh=self.mesh)]
            for bidx in idx:
                neg = torch.cat([bidx + i * kg.n_facts
                                 for i in range(self.n_neg)]) % nh.shape[0]
                losses.append(self._step(h_all[bidx], t_all[bidx],
                                         r_all[bidx], nh[neg], nt[neg]))
            with torch.no_grad():
                self.params = self.model.normalize_parameters(self.params)
            mean_loss = float(torch.stack(losses).mean()) if losses \
                else float("nan")
            history.append({"epoch": epoch, "loss": mean_loss,
                            "wall_s": time.time() - t0})
            if epoch % 10 == 0 or epoch == self.n_epochs - 1:
                logger.info(f"[kge] epoch {epoch} loss {mean_loss:.4f}")
            if self.save_dir and (epoch + 1) % self.save_epochs == 0:
                self.save(os.path.join(self.save_dir,
                                       f"kge_epoch_{epoch + 1}.npz"))
        return {"history": history, "params": self.params}

    def save(self, path: str) -> None:
        """An ``.npz`` of the parameters under the JAX package's keys
        (rank 0 writes it under a process group)."""
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **params_to_numpy(self.params))

    @staticmethod
    def load(path: str, device=None) -> Params:
        """The parameters of an ``.npz`` written by either package, as fp32
        tensors on ``device`` (``"cuda"`` unless the caller asks for the
        CPU), where the evaluators and the inference classes score them."""
        dev = resolve_device(device)
        with np.load(path) as data:
            return params_from_numpy(data, dev)
