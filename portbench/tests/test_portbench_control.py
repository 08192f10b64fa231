"""On the card: each cell's control comes out not correct and the program
passes, at the cells' widths and depth with fewer rows, so that a test
run holds it (``python -m portbench.calibrate`` reads the same at the
cells' own sizes).  The controls: the reference computed in fp8 where the
program computes in bf16, and in mining and scoring the program's own
int8 path (``quant="int8"``: its dense products in int8)."""

import pytest

from portbench import cell as cells
from portbench import compare

SMALL = {"pairs-b40-s510": {"rows": 8, "pool": 4},
         "image-pairs-b32-s510": {"rows": 8, "pool": 4},
         "items-4096x100-s255": {"items": 256, "candidates": 10, "pool": 1},
         "requests-b64-s510": {"rows": 16, "pool": 4}}


def _small(name):
    c = cells.load(name)
    c.traffic = dict(c.traffic, **SMALL[c.entry["traffic"]])
    return c


def _fails(gaps, limits):
    return any(gaps[k] > v for k, v in limits.items())


@pytest.mark.chip
@pytest.mark.parametrize("name", ["large-train-s510",
                                  "image-large-train-s510",
                                  "large-mine-s255", "large-score-s510"])
def test_control_fails_and_program_passes(card, name):
    c = _small(name)
    limits = c.workload["check"]["limits"]
    job_cls = cells.job_module(c.workload["job"]).Job
    job = job_cls(c, 2 ** 31 + 99, card)
    job.setup()
    job.window(1.0)
    if c.workload["job"] == "train":
        job.release()
        ours = job.readings
    else:
        ours = job.ours()
    ref32 = job.reference("fp32")
    assert not _fails(job.gaps(ours, ref32), limits)
    assert _fails(job.gaps(job.reference("fp8"), ref32), limits)


@pytest.mark.chip
@pytest.mark.parametrize("name", ["large-mine-s255", "large-score-s510"])
def test_program_int8_path_is_not_correct(card, name):
    c = _small(name)
    job = cells.job_module(c.workload["job"]).Job(c, 2 ** 31 + 98, card,
                                                  {"quant": "int8"})
    job.setup()
    job.window(1.0)
    checks = compare.verdict(job.gaps(job.ours(), job.reference("fp32")),
                             c.workload["check"]["limits"])
    assert not all(ch["ok"] for ch in checks), checks
