"""The benchmark's frozen FLOP count against the port's counter
(``utils/flops.py:count_flops``) on a tiny configuration, for each job's
timed call."""

import numpy as np
import pytest
from conftest import TINY

from item_alignment_torch.config import OptimizerConfig, TrainConfig
from item_alignment_torch.engine.inference import (
    TwoTowerInference,
    two_tower_encode_fn,
    two_tower_head_fn,
)
from item_alignment_torch.engine.train import Trainer
from item_alignment_torch.utils.flops import count_flops
from portbench import flops, traffic


def _build(c, **kw):
    sizes = dict(c.model, **TINY)
    return sizes, c.family().build(c.workload["model"], sizes,
                                   c.config["dtype"], 3, "cpu", **kw)


@pytest.mark.parametrize("name", ["large-train-s510",
                                  "image-large-train-s510"])
def test_train_step(tiny, name):
    c = tiny(name)
    sizes, model = _build(c)
    trainer = Trainer(model, TrainConfig(
        train_batch_size=c.traffic["rows"],
        optimizer=OptimizerConfig(**c.workload["optimizer"])),
        device="cpu").setup()
    batch = traffic.make(c.traffic, sizes["vocab_size"], 3)[0]
    got = count_flops(lambda: trainer.train_step(batch))
    want = flops.train_step(sizes, c.traffic["rows"], c.traffic["seq_len"],
                            c.workload["model"] == "image_one_tower")
    assert got == pytest.approx(want, rel=0.01)


def test_score_request(tiny):
    c = tiny("large-score-s510")
    sizes, model = _build(c)
    trainer = Trainer(model.eval(), TrainConfig(), device="cpu")
    batch = traffic.make(c.traffic, sizes["vocab_size"], 3)[0]
    got = count_flops(lambda: trainer._eval_outputs(batch))
    want = flops.one_tower_forward(sizes, c.traffic["rows"],
                                   c.traffic["seq_len"], False)
    assert got == pytest.approx(want, rel=0.01)


def test_mining_round(tiny):
    c = tiny("large-mine-s255")
    sizes, model = _build(c, interaction_type="two_tower")
    inf = TwoTowerInference(two_tower_encode_fn(model.eval()),
                            two_tower_head_fn(model),
                            batch_size=c.workload["score_rows"], device="cpu")
    r = traffic.make(c.traffic, sizes["vocab_size"], 3)[0]
    import torch
    B = c.workload["encode_rows"]
    n = len(r["input_ids"])
    batches = [{k: torch.from_numpy(r[k][s:s + B]).long()
                for k in ("input_ids", "attention_mask")}
               for s in range(0, n, B)]

    def one_round():
        inf.build_cache([str(i) for i in range(n)], batches)
        inf.score_pairs(r["src"], r["tgt"])

    got = count_flops(one_round)
    want = (flops.encoder_forward(sizes, n, c.traffic["seq_len"])
            + flops.two_tower_scores(sizes, len(r["src"])))
    assert len(r["src"]) % c.workload["score_rows"] == 0
    assert got == pytest.approx(want, rel=0.01)


def test_attention_bound():
    # B=40, S=510, N=16, H=64 with the backward: FLOP-bound
    flop = 12 * 40 * 16 * 510 * 510 * 64
    assert flops.attention_bound_s(40, 16, 510, 64, True) == pytest.approx(
        flop / 989e12)
    # the bytes bound where there is little work a byte
    nbytes = 4 * 64 * 8 * 4 * 64 * 2 + 4 * 64 * 8
    assert flops.attention_bound_s(64, 4, 8, 64, False) == pytest.approx(
        nbytes / 3.35e12)
    # the hand counts of the cells' sizes
    large = {"num_hidden_layers": 24, "hidden_size": 1024,
             "intermediate_size": 4096}
    assert flops.encoder_forward(large, 1, 255) == pytest.approx(160.4e9,
                                                                  rel=1e-3)
    assert flops.encoder_forward(large, 1, 510) == pytest.approx(333.6e9,
                                                                  rel=1e-3)
    assert 3 * flops.encoder_forward(large, 40, 510) == pytest.approx(
        40.0321e12, rel=1e-5)
    assert np.isfinite(flops.PEAK_HBM_BYTES)
