"""A run whose timed path is broken underneath comes out not correct:
each fault a cell can have, planted in the program, through the rest of a
run (``run.run_cell``) at a tiny size on the CPU, against the cell's own
limits.  The sound run comes out correct."""

import pytest
from conftest import TINY

from item_alignment_torch.engine import inference, optim
from item_alignment_torch.engine.train import Trainer
from item_alignment_torch.models import text
from portbench import run

SEED = 2 ** 31 + 21


def _run(c):
    return run.run_cell(c, SEED, 0.2, False, "cpu", TINY)


def _still(self):
    """A step that returns its state unchanged."""
    self.zero_grad()
    return True


def _half_batch(device_batch):
    """Half of the batch left out, the mean over the rest."""
    def wrapped(self, batch):
        out = device_batch(self, batch)
        return {k: v[: len(v) // 2] for k, v in out.items()}
    return wrapped


def _altered_answer(forward):
    """One answer of each request altered where it is produced."""
    def wrapped(self, *args, **kw):
        out = forward(self, *args, **kw)
        out.probs[0] = out.probs[0] + 0.05
        return out
    return wrapped


def _altered_embedding(encode_fn):
    def wrapped(model):
        fn = encode_fn(model)

        def encode(batch):
            emb = fn(batch).clone()
            emb[0] = -emb[0]
            return emb
        return encode
    return wrapped


@pytest.mark.parametrize("name", ["large-train-s510",
                                  "image-large-train-s510",
                                  "large-mine-s255", "large-score-s510"])
def test_sound_run_is_correct(tiny, name):
    line = _run(tiny(name))
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["large-train-s510",
                                  "image-large-train-s510"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_train_faults(tiny, monkeypatch, name, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(optim.Optimizer, "step", _still)
    else:
        monkeypatch.setattr(Trainer, "_device_batch",
                            _half_batch(Trainer._device_batch))
    line = _run(tiny(name))
    assert not line["correct"], line["checks"]


def test_score_answer_altered(tiny, monkeypatch):
    monkeypatch.setattr(text._OneTowerHead, "forward",
                        _altered_answer(text._OneTowerHead.forward))
    line = _run(tiny("large-score-s510"))
    assert not line["correct"], line["checks"]


def test_mine_embedding_altered(tiny, monkeypatch):
    import portbench.jobs  # noqa: F401  (the job module is loaded by path)
    monkeypatch.setattr(inference, "two_tower_encode_fn",
                        _altered_embedding(inference.two_tower_encode_fn))
    line = _run(tiny("large-mine-s255"))
    assert not line["correct"], line["checks"]


def test_nonfinite_answers_fail(tiny, monkeypatch):
    def nan_head(forward):
        def wrapped(self, *args, **kw):
            out = forward(self, *args, **kw)
            out.probs[:] = float("nan")
            return out
        return wrapped
    monkeypatch.setattr(text._OneTowerHead, "forward",
                        nan_head(text._OneTowerHead.forward))
    line = _run(tiny("large-score-s510"))
    assert not line["correct"] and line["failed"] > 0
