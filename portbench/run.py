"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cell's cards.  The cell
and everything it is made of are found by name (``cell.py``).  A run:

1. sets the build and kernel caches' directories inside the checkout,
   refuses to run without the cards the cell asks for (exit 2), and
   builds the cell's job (``jobs/<job>.py``), whose set-up makes the
   weights and inputs from ``--seed`` and warms up every shape the window
   uses; ``setup_s`` is the process's age when the window starts;
2. runs the window for ``--seconds`` and reads the device's memory peak;
3. with ``--trace 1``, profiles a few more steps and reads each per-layer
   metric from them (``metrics/<prefix>.py``; a reader that finds nothing
   leaves its metric out);
4. frees the program's state and compares what the timed path produced
   with the plain reference (``reference/``), each number beside its limit
   (the cell's ``check.limits``);
5. refuses its result if JAX or the JAX package is loaded or imported by
   the benchmark (``guard.py``; exit 3), and otherwise prints the result
   as the last line of standard output, the checks last on standard
   error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

CHECKOUT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def number(x: float):
    """A finite float, or None (JSON has no infinity)."""
    x = float(x)
    return x if math.isfinite(x) else None


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict], device: Dict,
                breakdown: Dict = None, checks: List[Dict] = ()) -> Dict:
    """The result's keys, in the contract's order, the checks last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": number(c["value"]),
                                 "limit": c["limit"]} for c in checks}
    return out


def run_cell(c, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: Dict = None) -> Dict:
    """Set-up, window, traced extras and check of one run of cell ``c``;
    the result line.  On a CPU (the tests, at a tiny size) the device's
    name is ``cpu`` and its memory peak 0."""
    import torch

    from portbench import cell as cells
    from portbench import compare, port

    cuda = torch.device(device).type == "cuda"
    job = cells.job_module(c.workload["job"], c.root).Job(c, seed, device,
                                                         overrides)
    job.setup()
    port.synchronize(device)
    setup_s = process_age_s()
    before = port.launches()
    e2e = job.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"{c.name}: set-up {setup_s:.2f} s; window {e2e}; attention "
          f"launches #1/#2/#3 in the window "
          f"{[a - b for a, b in zip(port.launches(), before)]}; "
          f"{getattr(job, 'notes', {})}", file=sys.stderr, flush=True)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": c.entry["chips"], "memory_peak_bytes": int(peak)}
    metrics, breakdown = {}, None
    if trace:
        rec = job.traced()
        for name in c.per_layer:
            value = cells.reader(name, c.root).read(name, rec)
            if value is not None:
                metrics[name] = {"value": value, "unit": c.units[name]}
        tr = rec["trace"]
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": rec["gaps"]}
    else:
        e2e["setup_s"] = setup_s
        for name in c.end_to_end:
            metrics[name] = {"value": e2e[name], "unit": c.units[name]}
    t0 = time.perf_counter()
    checks = compare.verdict(job.check(), c.workload["check"]["limits"])
    print(f"{c.name}: check {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
    correct = job.failed == 0 and all(ch["ok"] for ch in checks)
    return result_line(correct, job.attempted, job.failed, metrics, dev,
                       breakdown, checks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CHECKOUT / "build" / "portbench" / sub)

    import torch

    from portbench import cell as cells
    from portbench import guard

    c = cells.load(args.workload)
    chips = c.entry["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"{c.name} needs {chips} CUDA device(s); this machine has "
              f"{have}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(f"{c.name}: {card_line()}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    line = run_cell(c, args.seed, args.seconds, bool(args.trace))
    refused = guard.problems()
    if refused:
        print("refused: JAX or the JAX package is loaded or imported:\n  "
              + "\n  ".join(refused), file=sys.stderr)
        return 3
    print(json.dumps(line, allow_nan=False), flush=True)
    for name, ch in line["checks"].items():
        print(f"check {name} {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
