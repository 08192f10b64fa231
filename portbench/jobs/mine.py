"""Mining: encode-once, score-many, through the port's
``TwoTowerInference``: each round ``build_cache`` encodes the round's new
items in batches of ``encode_rows`` (host numpy, copied to the device a
batch at a time, as ``ia-torch mine`` feeds it), then ``score_pairs``
scores the round's candidate pairs against the cache in batches of
``score_rows``.

Set-up builds the two-tower model with the seed's weights and runs one
whole round of the pool, unrecorded, so that the window's first round
finds every buffer of a round's size already held (a smaller warm-up
left that round 3-5% slower).
The window runs whole rounds of the pool until the first that completes
after ``--seconds``: the rate is all the rounds' pairs over all their time,
encode included.  The check draws ``check.pairs`` of the scored pairs and
``check.rows`` rows of the last round's cache from the seed and compares
the probabilities and the cached [CLS] embeddings with the reference's.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from item_alignment_torch.engine.inference import (
    TwoTowerInference,
    two_tower_encode_fn,
    two_tower_head_fn,
)

from portbench import compare, port, spans, traffic, weights


class Job:
    STEP_SPAN = "build_cache"  # the program's span of a round's encode

    def __init__(self, cell, seed: int, device="cuda",
                 overrides: Optional[Dict] = None):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.work = cell.workload
        self.sizes = dict(cell.model, **(overrides or {}))
        self.kind = self.work["model"]
        self.family = cell.family()
        self.attempted = self.failed = 0
        self.done = []  # (pool index, probabilities) of each round
        self.encode_s = self.score_s = 0.0
        self.notes = {"round_s": []}  # each round's seconds, for stderr

    def setup(self) -> None:
        model = self.family.build(self.kind, self.sizes,
                                  self.cell.config["dtype"], self.seed,
                                  self.device,
                                  interaction_type="two_tower").eval()
        self.inf = TwoTowerInference(
            two_tower_encode_fn(model), two_tower_head_fn(model),
            batch_size=self.work["score_rows"], device=self.device)
        self.pool = traffic.make(self.cell.traffic, self.sizes["vocab_size"],
                                 self.seed)
        self.next = len(self.pool) - 1
        self._round(record=False)
        port.synchronize(self.device)
        self.next = 0

    def _batches(self, r, n: int):
        B = self.work["encode_rows"]
        for s in range(0, n, B):
            yield {key: torch.from_numpy(r[key][s:s + B]).long()
                   .to(self.device)
                   for key in ("input_ids", "attention_mask")}

    def _round(self, record: bool = True) -> None:
        i = self.next % len(self.pool)
        self.next += 1
        r = self.pool[i]
        n = len(r["input_ids"])
        t0 = time.perf_counter()
        self.inf.build_cache([f"{i}:{j}" for j in range(n)],
                             self._batches(r, n))
        t1 = port.clock(self.device)
        probs = self.inf.score_pairs(r["src"], r["tgt"])
        t2 = time.perf_counter()
        if not record:
            return
        self.encode_s += t1 - t0
        self.score_s += t2 - t1
        self.notes["round_s"].append(round(t2 - t0, 4))
        self.done.append((i, probs))

    def unit(self, n: int) -> None:
        """``n`` rounds, as the window runs them."""
        for _ in range(n):
            self._round()

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = port.clock(self.device)
        while True:
            self._round()
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = port.clock(self.device)
        self.rounds = len(self.done)
        self.attempted = sum(len(p) for _, p in self.done)
        self.failed = int(sum((~np.isfinite(p)).sum() for _, p in self.done))
        mix = self.cell.traffic
        self.window_s = t1 - t0
        self.window_flop = self.rounds * self.family.forward_flop(
            self.sizes, self.kind, mix["items"], mix["seq_len"]) \
            + self.family.pair_score_flop(self.sizes, self.attempted)
        return {"mine_pairs_per_s": self.attempted / self.window_s}

    def traced(self) -> Dict:
        from portbench.trace import profiled

        rounds, enc, sco = self.rounds, self.encode_s, self.score_s
        n = self.work["trace_steps"]
        _, trace = profiled(lambda: self.unit(n))
        _, labelled = profiled(self._round, host=True)
        mask = self.pool[0]["attention_mask"][:self.work["encode_rows"]]
        rec = {"trace": trace, "gaps": labelled.idle_gaps(), "steps": n,
               "model_flop": self.window_flop, "window_s": self.window_s,
               "encode_s": enc, "score_s": sco, "rounds": rounds,
               **self.family.attention_record(self.sizes, mask, 0.0, False,
                                              self.device)}
        rec["spans"] = spans.passes(self, rec)
        return rec

    def release(self) -> None:
        """Keep the check's rows of the last round's cache; free the
        rest."""
        k = self.work["check"]["rows"]
        gen = traffic.rng(self.seed, 4)
        last = self.done[-1][0]
        n = self.inf.cache.shape[0]
        self.rows = np.sort(gen.choice(n, min(k, n), replace=False))
        self.cached = (last, self.inf.cache[torch.as_tensor(
            self.rows, device=self.device)].float().cpu())
        self.inf = None
        port.free(self.device)

    def sample(self):
        """``check.pairs`` of the scored pairs: (round's pool index, pair
        index, probability), drawn from the seed."""
        gen = traffic.rng(self.seed, 5)
        out = []
        for _ in range(self.work["check"]["pairs"]):
            i, probs = self.done[gen.integers(len(self.done))]
            j = int(gen.integers(len(probs)))
            out.append((i, j, float(probs[j])))
        return out

    def _embed(self, w, r, items: np.ndarray, precision: str
               ) -> torch.Tensor:
        block = self.work["check"]["block_rows"]
        out = []
        for s in range(0, len(items), block):
            idx = items[s:s + block]
            ids, mask = (torch.as_tensor(r[key][idx], device=self.device)
                         .long() for key in ("input_ids", "attention_mask"))
            out.append(self.family.item_embedding(w, self.sizes, ids, mask,
                                                  precision))
        return torch.cat(out)

    def ours(self) -> Dict:
        """The program's sampled outputs: the cache rows and the pairs'
        probabilities."""
        self.release()
        self.pairs = self.sample()
        return {"emb": self.cached[1],
                "probs": np.array([p for _, _, p in self.pairs])}

    def reference(self, precision: str = "fp32") -> Dict:
        """The reference's outputs for the same rows and pairs."""
        fam = self.family
        if self.device.type == "cuda":
            fam.fp32_exact()
        w = weights.of(fam, self.sizes, self.kind, self.seed, self.device)
        with torch.no_grad():
            emb = self._embed(w, self.pool[self.cached[0]], self.rows,
                              precision)
            probs = []
            for i, j, _ in self.pairs:
                r = self.pool[i]
                e = self._embed(w, r, np.array([r["src"][j], r["tgt"][j]]),
                                precision)
                probs.append(float(fam.two_tower_probs(w, e[:1], e[1:])[0]))
        return {"emb": emb.cpu(), "probs": np.array(probs)}

    @staticmethod
    def gaps(ours: Dict, theirs: Dict) -> Dict[str, float]:
        return {"emb_gap": compare.row_gap(ours["emb"], theirs["emb"]),
                "prob_gap": compare.abs_gap(ours["probs"], theirs["probs"])}

    def check(self) -> Dict[str, float]:
        ours = self.ours()
        return self.gaps(ours, self.reference())
