"""The plain reference against the program (``item_alignment_torch``) at a
tiny size on the CPU in fp32: the same dropout bits, the same forward, and
the same steps, gradients and changes through each job's check."""

import numpy as np
import pytest
import torch
from conftest import TINY

from item_alignment_torch.ops.cuda_attention_train import keep_mask_reference
from item_alignment_torch.ops.dropout import fold_seed as port_fold_seed
from portbench import cell as cells
from portbench import traffic, weights
from portbench.reference import dropout as rd
from portbench.reference import roberta as ref


def test_fold_seed_and_attention_keep_bits():
    for seed in (0, 7, 2 ** 31 + 3, 2 ** 40 + 9):
        assert rd.fold_seed(seed, 5) == port_fold_seed(seed, 5)
    like = torch.zeros(1)
    t, _ = rd.dropout_consts(0.1)
    whole = keep_mask_reference(12345, 6, 4, 10, t, like)
    for rows in (slice(0, 6), slice(2, 5)):
        got = rd.attention_keep(12345, rows, 4, 10, 0.1, "cpu")
        assert torch.equal(got, whole[rows])


@pytest.mark.parametrize("name", ["large-train-s510",
                                  "image-large-train-s510"])
def test_one_tower_forward_with_dropout(tiny, name):
    c = tiny(name)
    sizes = dict(c.model, **TINY)
    kind = c.workload["model"]
    family = c.family()
    model = family.build(kind, sizes, "float32", 9, "cpu",
                         hidden_dropout_prob=0.1,
                         attention_probs_dropout_prob=0.1)
    batch = traffic.make(c.traffic, sizes["vocab_size"], 9)[0]
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    t = {k: v if v.is_floating_point() else v.long() for k, v in t.items()}
    seed = 2 ** 33 + 1
    ours = model(**t, deterministic=False, dropout_seed=seed).logits
    w = weights.of(family, sizes, kind, 9, "cpu")
    n = t["input_ids"].shape[0]
    theirs = torch.cat([ref.one_tower_logits(
        w, sizes, {k: v[r0:r0 + 3] for k, v in t.items()},
        ref.Drops(rows=slice(r0, min(r0 + 3, n)), total=n, seed=seed,
                  rate=0.1)) for r0 in range(0, n, 3)])
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-5)
    quiet = model(**t).logits
    assert (quiet - ours).abs().max() > 1e-3  # the masks did something


@pytest.mark.parametrize("name,limits", [
    ("large-train-s510", {"loss_gap": 1e-6, "grad_gap": 1e-5,
                          "change_gap": 1e-4}),
    ("image-large-train-s510", {"loss_gap": 1e-6, "grad_gap": 1e-5,
                                "change_gap": 1e-4}),
    ("large-mine-s255", {"emb_gap": 1e-5, "prob_gap": 1e-6}),
    ("large-score-s510", {"prob_gap": 1e-6})])
def test_each_job_checks_against_the_reference(tiny, name, limits):
    """fp32 program (fp32 AdamW moments) against the fp32 reference."""
    c = tiny(name)
    job = cells.job_module(c.workload["job"]).Job(c, 2 ** 31 + 77, "cpu",
                                                  TINY)
    job.setup()
    job.window(0.2)
    assert job.attempted > 0 and job.failed == 0
    gaps = job.check()
    assert set(c.workload["check"]["limits"]) <= set(gaps)
    for key, limit in limits.items():
        assert np.isfinite(gaps[key]) and gaps[key] <= limit, (key, gaps)
