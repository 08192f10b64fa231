"""Checkpoint and resume of the port, on the CPU.

Counterparts of ``tests/test_resume.py`` (kill-and-resume, resume without a
checkpoint) and of the JAX ``engine/checkpoint.py`` helpers.  The port saves
with ``torch.save``, so a resumed run must equal the uninterrupted one bit
for bit: parameters, optimizer moments, step and the dropout seeds that
follow from it.
"""

import os

import numpy as np
import pytest
import torch

from item_alignment_torch.config import ModelConfig, OptimizerConfig, TrainConfig
from item_alignment_torch.engine import checkpoint as tckpt
from item_alignment_torch.engine.train import Trainer
from item_alignment_torch.models.text import RobertaOneTower

jax = pytest.importorskip("jax")

from item_alignment_tpu.engine import checkpoint as jckpt  # noqa: E402
from test_torch_train import TINY, _learning_data  # noqa: E402

torch.set_num_threads(1)

EPOCHS = 4


def _cfg(tmpdir=None, epochs=EPOCHS, resume=False, **opt):
    return TrainConfig(
        seed=3, train_batch_size=8, eval_batch_size=16, num_epochs=epochs,
        log_steps=100, checkpoint_dir=tmpdir, resume=resume,
        optimizer=OptimizerConfig(learning_rate=2e-3, total_steps=EPOCHS * 4,
                                  warmup_proportion=0.1, **opt))


def _trainer(cfg):
    # dropout on: the resumed run must draw the masks the full run drew
    model = RobertaOneTower(ModelConfig(hidden_dropout_prob=0.1,
                                        attention_probs_dropout_prob=0.1,
                                        **TINY), device="cpu", seed=0)
    return Trainer(model, cfg, device="cpu")


@pytest.mark.parametrize("opt", [
    {}, dict(fused=True, state_dtype="bfloat16", max_grad_norm=1.0)],
    ids=["fp32-moments", "bf16-moments"])
def test_kill_and_resume_reproduces_uninterrupted_run(tmp_path, opt):
    ds = _learning_data(n=32)
    ckpt_dir = str(tmp_path / "ckpt")
    t_full = _trainer(_cfg(**opt))
    full = t_full.fit(ds, ds)

    # interrupted run: 2 epochs with checkpointing, then the process "dies"
    t_a = _trainer(_cfg(ckpt_dir, epochs=2, **opt))
    part_a = t_a.fit(ds, ds)
    del t_a

    # fresh process: a new Trainer resumes from the latest full train state
    t_b = _trainer(_cfg(ckpt_dir, resume=True, **opt))
    part_b = t_b.fit(ds, ds)

    assert [h["epoch"] for h in part_b["history"]] == [2, 3]
    stitched = [h["loss"] for h in part_a["history"] + part_b["history"]]
    assert stitched == [h["loss"] for h in full["history"]]
    for (name, a), b in zip(t_full.model.state_dict().items(),
                            t_b.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = t_full.optimizer.state_dict(), t_b.optimizer.state_dict()
    assert sa["count"] == sb["count"] == t_b.step == t_full.step == EPOCHS * 4
    for kind in ("mu", "nu"):
        for name, m in sa[kind].items():
            assert m.dtype == sb[kind][name].dtype
            assert torch.equal(m, sb[kind][name]), (kind, name)
    # best-F1 bookkeeping survived the restart
    assert part_b["best"]["best_f1"] >= part_a["best"]["best_f1"]
    assert part_b["best"] == full["best"]
    assert t_b.best_params is not None
    assert os.path.exists(os.path.join(ckpt_dir, "best_f1.pt"))


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    ds = _learning_data(n=16)
    t = _trainer(_cfg(str(tmp_path / "empty"), epochs=1, resume=True))
    out = t.fit(ds, ds)
    assert [h["epoch"] for h in out["history"]] == [0]
    assert tckpt.CheckpointManager(str(tmp_path / "empty")).all_steps() == [2]


def test_bf16_moments_survive_the_round_trip(tmp_path):
    ds = _learning_data(n=16)
    t = _trainer(_cfg(fused=True, state_dtype="bfloat16"))
    t.train_epoch(ds, 0)
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    t.save_checkpoint(mgr, epoch=0, best_f1=0.5, best_epoch=0,
                      best_threshold=0.4, stale_evals=1)
    tree = mgr.restore()
    assert tree["step"] == 2 and tree["opt_state"]["count"] == 2
    assert tree["meta"] == {"epoch": 0, "best_f1": 0.5, "best_epoch": 0,
                            "best_threshold": 0.4, "stale_evals": 1}
    for kind in ("mu", "nu"):
        for name, m in tree["opt_state"][kind].items():
            assert m.dtype == torch.bfloat16 and m.device.type == "cpu"
            assert torch.equal(m, getattr(t.optimizer.adamw, kind)[name])
    assert any(m.abs().max() > 0 for m in tree["opt_state"]["mu"].values())
    for name, p in tree["params"].items():
        assert p.dtype == torch.float32
    # fp32 moments do not load into a bf16 optimizer
    other = _trainer(_cfg()).setup()
    with pytest.raises(TypeError, match="bfloat16"):
        other.restore_checkpoint(mgr)


def test_manager_keeps_the_newest(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "m"), keep=3)
    assert mgr.latest_step() is None and mgr.all_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (4, 8, 12, 16, 20):
        mgr.save(step, {"step": step, "x": torch.full((2,), float(step))})
    assert mgr.all_steps() == [12, 16, 20] and mgr.latest_step() == 20
    assert mgr.restore()["step"] == 20
    assert torch.equal(mgr.restore(12)["x"], torch.full((2,), 12.0))
    assert not [f for f in os.listdir(mgr.directory) if f.endswith(".tmp")]
    # a second manager on the same directory sees the same steps
    assert tckpt.CheckpointManager(str(tmp_path / "m")).all_steps() == [12, 16, 20]


def test_save_and_load_params(tmp_path):
    model = RobertaOneTower(ModelConfig(**TINY), device="cpu", seed=1)
    path = str(tmp_path / "sub" / "params.pt")
    tckpt.save_params(path, model.state_dict())
    loaded = tckpt.load_params(path)
    assert loaded.keys() == model.state_dict().keys()
    for name, p in model.state_dict().items():
        assert torch.equal(loaded[name], p)


def test_merge_param_sources_matches_jax():
    rs = np.random.RandomState(0)
    arr = lambda *shape: rs.randn(*shape).astype(np.float32)  # noqa: E731
    base = {"roberta": {"embeddings": {"word": arr(3, 2)},
                        "encoder": {"layer_0": {"kernel": arr(2, 2)}}},
            "head": {"bias": arr(2)}}
    overlays = ({"roberta/embeddings/ent_emb": {"embedding": arr(4, 2)},
                 ("roberta", "encoder", "layer_0", "kernel"): arr(2, 2)},
                {"head/bias": arr(2), "new/leaf": arr(1)})
    ours = tckpt.merge_param_sources(base, *overlays)
    theirs = jckpt.merge_param_sources(base, *overlays)

    def same(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)

    same(ours, theirs)
    # the caller's base tree is not mutated
    assert "ent_emb" not in base["roberta"]["embeddings"]
    assert "new" not in base
