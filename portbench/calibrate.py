"""The readings that the limits of a cell's check are set from, on the
card, one process for all the seeds:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

For each of ``--seeds``: the cell's set-up and a short window of the
program, then its check's numbers (the lower readings).  For each of
``--control-seeds`` the control's numbers: in a train cell the reference
computed in fp8 (``reference/roberta.py``) put in the program's place,
and the planted fault of a batch half left out (the reference's mean over
the first half of each batch's rows); in a mining or scoring cell the
program with its own int8 path on (``quant="int8"``: int8 dense products)
through the same window and check.  One JSON line a reading; the benchmark's
own runs never run this.  With no ``--seeds``, only the controls.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Dict

import numpy as np
import torch

from portbench import cell as cells
from portbench import compare


def worst(ours, ref):
    """The leaf that sets ``compare.worst_leaf``, its gap, and the median
    leaf's gap."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        gaps = compare.leaf_gaps(ours[key], ref[key], ref["grad_norms"])
        name = max(gaps, key=gaps.get)
        out[key] = [name, gaps[name], statistics.median(gaps.values())]
    return out


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def train_cell(c, seeds, control_seeds, seconds):
    job_cls = cells.job_module("train").Job
    for seed in seeds + [s for s in control_seeds if s not in seeds]:
        t0 = time.perf_counter()
        job = job_cls(c, seed)
        job.setup()
        job.window(seconds)
        job.release()
        ref32 = job.reference("fp32")
        t_ref = time.perf_counter()
        if seed in seeds:
            emit(seed=seed, who="program", gaps=job.gaps(job.readings, ref32),
                 worst=worst(job.readings, ref32), losses=job.readings["losses"],
                 ref_losses=ref32["losses"])
        if seed in control_seeds:
            ref8 = job.reference("fp8")
            emit(seed=seed, who="control_fp8", gaps=job.gaps(ref8, ref32),
                 worst=worst(ref8, ref32))
            half = job.reference("fp32", rows=c.traffic["rows"] // 2)
            emit(seed=seed, who="fault_half_batch", gaps=job.gaps(half, ref32),
                 worst=worst(half, ref32))
        emit(seed=seed, who="timing", total_s=time.perf_counter() - t0,
             reference_s=t_ref - t0)
        del job


def spread(ours, theirs) -> Dict:
    """How the gaps of single answers lie: rows (their share of the
    reference row's norm) and probabilities."""
    out = {}
    if "emb" in ours:
        rows = (torch.linalg.vector_norm((ours["emb"] - theirs["emb"])
                                         .double(), dim=-1)
                / torch.linalg.vector_norm(theirs["emb"].double(), dim=-1))
        out["rows"] = _stats(rows.numpy())
    out["probs"] = _stats(np.abs(np.asarray(ours["probs"])
                                 - np.asarray(theirs["probs"])))
    return out


def _stats(x) -> Dict:
    return {"mean": float(np.mean(x)), "median": float(np.median(x)),
            "p90": float(np.percentile(x, 90)), "max": float(np.max(x))}


def serve_cell(c, seeds, control_seeds, seconds):
    job_cls = cells.job_module(c.workload["job"]).Job
    runs = [(s, None) for s in seeds] + [(s, "int8") for s in control_seeds]
    for seed, quant in runs:
        t0 = time.perf_counter()
        job = job_cls(c, seed, overrides={"quant": quant} if quant else None)
        job.setup()
        job.window(seconds)
        ours = job.ours()
        ref32 = job.reference("fp32")
        emit(seed=seed, who="control_int8" if quant else "program",
             gaps=job.gaps(ours, ref32), spread=spread(ours, ref32),
             attempted=job.attempted, seconds=time.perf_counter() - t0)
        if quant:
            ref8 = job.reference("fp8")
            emit(seed=seed, who="control_fp8", gaps=job.gaps(ref8, ref32),
                 spread=spread(ref8, ref32))
        del job


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    c = cells.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    if c.workload["job"] == "train":
        train_cell(c, seeds, control, args.seconds)
    else:
        serve_cell(c, seeds, control, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
