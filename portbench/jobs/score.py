"""Scoring: cross-encoder requests of ``rows`` pairs, one at a time
(closed loop, one client), each through the one-tower eval path that
``Trainer.evaluate`` and ``Trainer.predict_jsonl`` run on every batch
(``Trainer._eval_outputs``): host numpy in, probabilities on the host out.

Set-up builds the model with the seed's weights and the ``Trainer`` around
it and answers two requests.  The window cycles the pool of distinct
requests until ``--seconds`` have passed and times each request on the
host clock from the hand-off to the probabilities on the host: the rate
is all the pairs answered over the window's time, the tail the 95th
percentile of all the requests' latencies.  The check draws
``check.requests`` of the answered requests from the seed and compares
their probabilities with the reference's, by the widest gap and by the
scatter of the gaps in log-odds (``compare.py``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from item_alignment_torch.config import TrainConfig
from item_alignment_torch.engine.train import Trainer

from portbench import compare, port, spans, traffic, weights


class Job:
    STEP_SPAN = "eval"  # the program's span of a request

    def __init__(self, cell, seed: int, device="cuda",
                 overrides: Optional[Dict] = None):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.work = cell.workload
        self.sizes = dict(cell.model, **(overrides or {}))
        self.kind = self.work["model"]
        self.family = cell.family()
        self.attempted = self.failed = 0
        self.answers = []  # (pool index, probabilities)

    def setup(self) -> None:
        model = self.family.build(self.kind, self.sizes,
                                  self.cell.config["dtype"], self.seed,
                                  self.device).eval()
        self.trainer = Trainer(model, TrainConfig(
            seed=self.seed, eval_batch_size=self.cell.traffic["rows"]),
            device=self.device)
        self.pool = traffic.make(self.cell.traffic, self.sizes["vocab_size"],
                                 self.seed)
        for b in self.pool[:2]:
            self._answer(b)
        self.next = 0

    def _answer(self, batch) -> np.ndarray:
        return self.trainer._eval_outputs(batch)[0]

    def _requests(self, n: int) -> None:
        for _ in range(n):
            i = self.next % len(self.pool)
            self.answers.append((i, self._answer(self.pool[i])))
            self.next += 1

    def unit(self, n: int) -> None:
        """``n`` requests, as the window sends them."""
        self._requests(n)

    def window(self, seconds: float) -> Dict[str, float]:
        latencies = []
        t0 = port.clock(self.device)
        while True:
            t = time.perf_counter()
            self._requests(1)
            now = time.perf_counter()
            latencies.append(now - t)
            if now - t0 >= seconds:
                break
        t1 = port.clock(self.device)
        self.attempted = len(latencies)
        self.failed = sum(not np.isfinite(p).all() for _, p in self.answers)
        mix = self.cell.traffic
        rows = mix["rows"]
        self.window_s = t1 - t0
        self.window_flop = self.attempted * self.family.forward_flop(
            self.sizes, self.kind, rows, mix["seq_len"])
        return {"score_pairs_per_s": self.attempted * rows / self.window_s,
                "score_batch_p95_ms": float(np.percentile(latencies, 95))
                * 1e3}

    def traced(self) -> Dict:
        from portbench.trace import profiled

        n = self.work["trace_steps"]
        _, trace = profiled(lambda: self._requests(n))
        _, labelled = profiled(lambda: self._requests(1), host=True)
        rec = {"trace": trace, "gaps": labelled.idle_gaps(), "steps": n,
               "model_flop": self.window_flop, "window_s": self.window_s,
               **self.family.attention_record(
                   self.sizes, self.pool[0]["attention_mask"], 0.0, False,
                   self.device)}
        rec["spans"] = spans.passes(self, rec)
        return rec

    def release(self) -> None:
        self.trainer = None
        port.free(self.device)

    def sample(self):
        """The answers the check compares: ``check.requests`` of those
        answered, drawn from the seed."""
        k = min(self.work["check"]["requests"], len(self.answers))
        pick = traffic.rng(self.seed, 3).choice(len(self.answers), k,
                                                replace=False)
        return [self.answers[i] for i in sorted(pick)]

    def ours(self) -> Dict[str, np.ndarray]:
        """The program's probabilities of the sampled requests."""
        self.release()
        self.picked = self.sample()
        return {"probs": np.concatenate([p for _, p in self.picked])}

    def reference(self, precision: str = "fp32") -> Dict[str, np.ndarray]:
        """The reference's logits and probabilities of the same
        requests."""
        fam = self.family
        if self.device.type == "cuda":
            fam.fp32_exact()
        w = weights.of(fam, self.sizes, self.kind, self.seed, self.device)
        block = self.work["check"]["block_rows"]
        out = []
        with torch.no_grad():
            for i, _ in self.picked:
                b = {k: torch.as_tensor(v, device=self.device).long()
                     for k, v in self.pool[i].items()}
                n = b["input_ids"].shape[0]
                for r0 in range(0, n, block):
                    rows = slice(r0, min(r0 + block, n))
                    logits = fam.one_tower_logits(
                        w, self.sizes, {k: v[rows] for k, v in b.items()},
                        rows, n, precision)
                    out.append(logits.float().cpu())
        logits = torch.cat(out)
        return {"logits": logits.numpy(),
                "probs": torch.softmax(logits, dim=-1)[:, 1].numpy()}

    @staticmethod
    def gaps(ours: Dict, theirs: Dict) -> Dict[str, float]:
        return {"prob_gap": compare.abs_gap(ours["probs"], theirs["probs"]),
                "logodds_scatter": compare.logodds_scatter(
                    ours["probs"], theirs["logits"])}

    def check(self) -> Dict[str, float]:
        ours = self.ours()
        return self.gaps(ours, self.reference())
