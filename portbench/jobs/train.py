"""Training: the port's ``Trainer.train_step`` on host batches, closed
loop, steps dispatched back to back.

Set-up builds one ``Trainer`` (the model with the seed's weights, the
fused AdamW of the cell's ``optimizer``) and drives it through the check's
first ``check.steps`` steps on distinct batches of the pool, through the
window's own call and feed; these steps also warm up every shape.  It
keeps each step's loss, each leaf's first gradient norm as the optimizer
got it (its first moment after one step over ``1 - b1``) and each leaf's
change over those steps, then hands the same ``Trainer`` to the window.

The window cycles the pool from the next batch on until ``--seconds`` have
passed on the host clock, then synchronises: the rate is all the pairs
stepped over all that time.  The traced run profiles ``trace_steps`` more
steps and times the attention entry at the cell's shapes with its dropout
and backward.  The check runs the reference's steps from the same weights
on the same batches and compares the losses, the gradient norms and the
changes (``compare.py``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from item_alignment_torch.config import OptimizerConfig, TrainConfig
from item_alignment_torch.engine.train import Trainer

from portbench import compare, port, spans, traffic, weights
from portbench.reference.train import leaf_norms


class Job:
    STEP_SPAN = "step"  # the program's span of a train step

    def __init__(self, cell, seed: int, device="cuda",
                 overrides: Optional[Dict] = None):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.work = cell.workload
        self.sizes = dict(cell.model, **(overrides or {}))
        self.kind = self.work["model"]
        self.family = cell.family()
        self.opt = self.work["optimizer"]
        self.attempted = self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        rate = self.work["dropout"]
        model = self.family.build(self.kind, self.sizes,
                                  self.cell.config["dtype"], self.seed,
                                  self.device, hidden_dropout_prob=rate,
                                  attention_probs_dropout_prob=rate)
        opt = OptimizerConfig(fused=True, **self.opt)
        self.trainer = Trainer(model, TrainConfig(
            seed=self.seed, train_batch_size=self.cell.traffic["rows"],
            log_steps=10 ** 9, optimizer=opt), device=self.device).setup()
        self.pool = traffic.make(self.cell.traffic, self.sizes["vocab_size"],
                                 self.seed)
        steps = self.work["check"]["steps"]
        losses = []
        for k in range(steps):
            losses.append(float(self.trainer.train_step(self.pool[k])))
            if k == 0:
                adamw = self.trainer.optimizer.adamw
                grads = {n: m.float() / (1.0 - adamw.b1)
                         for n, m in adamw.mu.items()}
                grad_norms = leaf_norms(grads)
                del grads
        w0 = weights.of(self.family, self.sizes, self.kind, self.seed,
                        self.device)
        change = leaf_norms({n: p.detach() - w0[n] for n, p in
                             self.trainer.model.named_parameters()})
        del w0
        self.readings = {"losses": losses, "grad_norms": grad_norms,
                         "change_norms": change}
        self.next = steps
        port.synchronize(self.device)

    def _steps(self, n: int):
        losses = []
        for _ in range(n):
            losses.append(self.trainer.train_step(
                self.pool[self.next % len(self.pool)]))
            self.next += 1
        return losses

    def unit(self, n: int) -> None:
        """``n`` train steps, as the window runs them."""
        self._steps(n)

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict[str, float]:
        t0 = port.clock(self.device)
        losses = []
        while True:
            losses += self._steps(1)
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = port.clock(self.device)
        self.attempted = len(losses)
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        mix = self.cell.traffic
        self.window_s = t1 - t0
        self.window_flop = self.attempted * self.family.train_flop(
            self.sizes, self.kind, mix["rows"], mix["seq_len"])
        return {self.work["rate"]: self.attempted * mix["rows"]
                / self.window_s}

    def traced(self) -> Dict:
        from portbench.trace import profiled

        n = self.work["trace_steps"]
        _, trace = profiled(lambda: self._steps(n))
        _, labelled = profiled(lambda: self._steps(1), host=True)
        rec = {"trace": trace, "gaps": labelled.idle_gaps(), "steps": n,
               "model_flop": self.window_flop, "window_s": self.window_s,
               **self.family.attention_record(
                   self.sizes, self.pool[0]["attention_mask"],
                   self.work["dropout"], True, self.device)}
        rec["spans"] = spans.passes(self, rec)
        return rec

    # ------------------------------------------------------------- check
    def release(self) -> None:
        self.trainer = None
        port.free(self.device)

    def reference(self, precision: str = "fp32", rows: Optional[int] = None
                  ) -> Dict:
        """The reference's readings of the check's steps; ``rows`` keeps
        only a batch's first rows (a planted fault: the rest left out, the
        mean over these)."""
        fam = self.family
        if self.device.type == "cuda":
            fam.fp32_exact()
        steps = self.work["check"]["steps"]
        batches = []
        for b in self.pool[:steps]:
            t = {k: torch.as_tensor(np.asarray(v)[:rows], device=self.device)
                 for k, v in b.items()}
            batches.append({k: v.long() if not v.is_floating_point() else v
                            for k, v in t.items()})
        w0 = weights.of(fam, self.sizes, self.kind, self.seed, self.device)
        out = fam.run_steps(w0, self.sizes, batches, self.seed, self.opt,
                        self.work["dropout"],
                        self.work["check"]["block_rows"], precision)
        del w0
        port.free(self.device)
        return out

    @staticmethod
    def gaps(ours: Dict, theirs: Dict) -> Dict[str, float]:
        return {"loss_gap": compare.abs_gap(ours["losses"], theirs["losses"]),
                "grad_gap": compare.worst_leaf(ours["grad_norms"],
                                               theirs["grad_norms"],
                                               theirs["grad_norms"]),
                "change_gap": compare.worst_leaf(ours["change_norms"],
                                                 theirs["change_norms"],
                                                 theirs["grad_norms"])}

    def check(self) -> Dict[str, float]:
        self.release()
        return self.gaps(self.readings, self.reference())
