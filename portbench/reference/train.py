"""The reference's training steps: the one-tower loss over a batch in
blocks of rows, its gradients, and AdamW with the linear warmup and decay
schedule, all in fp32.

AdamW: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, the update
``(m / c1) / (sqrt(v / c2) + eps) + wd p`` (weight decay on dense kernels
and embedding tables only) times ``-lr``, with ``lr`` of the step count
before it is advanced: ``lr * step / warmup`` during the warmup
(``total_steps * warmup_proportion`` steps), then falling linearly to 0 at
``total_steps``.  The moments are kept in fp32.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference.dropout import fold_seed
from portbench.reference.layout import decays
from portbench.reference.roberta import Drops, block_loss, one_tower_logits


def learning_rate(opt: Dict, step: int) -> float:
    warmup = max(int(opt["total_steps"] * opt["warmup_proportion"]), 1)
    decay = max(opt["total_steps"] - warmup, 1)
    lr = opt["learning_rate"]
    if step < warmup:
        return lr * max(step, 0) / warmup
    return lr * (1.0 - min(step - warmup, decay) / decay)


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], opt: Dict):
        self.params, self.opt = params, opt
        self.count = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        o = self.opt
        lr = learning_rate(o, self.count)
        self.count += 1
        c1, c2 = 1.0 - o["b1"] ** self.count, 1.0 - o["b2"] ** self.count
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(o["b1"]).add_(g, alpha=1.0 - o["b1"])
            self.v[n].mul_(o["b2"]).addcmul_(g, g, value=1.0 - o["b2"])
            u = (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + o["eps"])
            if decays(n) and o["weight_decay"]:
                u = u + o["weight_decay"] * p
            p.add_(u, alpha=-lr)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in
            tensors.items()}


def run_steps(w0: Dict[str, torch.Tensor], cfg: Dict,
              batches: List[Dict[str, torch.Tensor]], seed: int, opt: Dict,
              rate: float, block_rows: int, precision: str = "fp32"
              ) -> Dict[str, object]:
    """``len(batches)`` training steps from the weights ``w0`` (left
    unchanged); step ``k`` drops under the seed ``fold_seed(seed, k)``.
    Returns each step's loss, the first step's gradient norm of each
    leaf, and the norm of each leaf's change over all the steps."""
    params = {n: t.detach().clone().float().requires_grad_()
              for n, t in w0.items()}
    adamw = AdamW(params, opt)
    losses, first_grad = [], None
    for k, batch in enumerate(batches):
        total = batch["input_ids"].shape[0]
        drops_seed = fold_seed(seed, k)
        loss = 0.0
        for r0 in range(0, total, block_rows):
            rows = slice(r0, min(r0 + block_rows, total))
            block = {key: t[rows] for key, t in batch.items()}
            drops = Drops(rows=rows, total=total, seed=drops_seed, rate=rate)
            logits = one_tower_logits(params, cfg, block, drops, precision)
            part = block_loss(logits, block["labels"], total)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        if k == 0:
            first_grad = leaf_norms(grads)
        adamw.step(grads)
        for p in params.values():
            p.grad = None
    change = leaf_norms({n: p.detach() - w0[n].float()
                         for n, p in params.items()})
    return {"losses": losses, "grad_norms": first_grad,
            "change_norms": change}
