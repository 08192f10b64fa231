"""Dry runs of the parallel layer: one sharded step of each model family.

The port's counterpart of ``__graft_entry__.py:dryrun_multichip`` and
``_dryrun_families``: a sharded text step through the ``Trainer``, then
NFNet, CoCa, GCN and the KGE trainer, and the process-slice maths.  Each
step is a function of its arguments alone (weights and batches from fixed
seeds), so the same call without a process group gives the one-device
result it must equal.

``spawn(fn, world, *args)`` runs ``fn(*args)`` in ``world`` processes joined
by ``parallel/mesh.initialize_distributed`` (gloo on the CPU, NCCL on CUDA;
one process per device) and returns rank 0's result.  Every function runs
on the card unless it is given ``device="cpu"``, as the tests give it;
``python -m item_alignment_torch.parallel.dryrun --world N`` runs
``dryrun_multichip`` in N processes, one card each (``--device cpu``: on
the CPU).

- ``text_step``: one ``Trainer`` step of a tiny ``RobertaOneTower``: the
  loss, the whole gradients handed to the optimizer, the updated
  parameters and AdamW's first moments.
- ``eval_probs``: ``Trainer.evaluate``'s probabilities (fp32 or int8).
- ``resume_steps``: save a train-state checkpoint, restore it into a new
  ``Trainer`` and step on, beside the uninterrupted run.
- ``legacy_adversarial_steps``: the legacy member with adversarial noise,
  whose deltas stay whole on every rank.
- ``family_steps``: one step of each other family (the GCN pair batch over
  ``data`` with the graph whole on every rank, as in JAX).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from item_alignment_torch.config import (
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    TrainConfig,
)
from item_alignment_torch.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]

TINY = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, max_seq_len=4,
            max_seq_len_pv=4, max_position_embeddings=64)
# the dry run's text width: heads of 32, which the CUDA attention kernels
# take (TINY's heads of 8 run on the CPU alone)
DRY_WIDTH = dict(hidden_size=128, intermediate_size=256)
# JAX's test_multichip_scaling.py schedule: warmup 1 of 8 steps
OPT = dict(learning_rate=1e-3, total_steps=8)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn: Callable, world: int, *args, device=None,
          timeout: float = 120.0, backend: Optional[str] = None) -> Any:
    """``fn(*args)`` in ``world`` new processes (``fn`` a module-level
    function of an importable module), one process group over them (on
    ``device``'s backend, or ``backend``); rank 0's result.  Any rank that
    fails or outlives ``timeout`` seconds fails the call, and every process
    is stopped."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.pt")
        torch.save({"fn": (fn.__module__, fn.__qualname__), "args": args,
                    "world": world, "port": free_port(), "device": device,
                    "backend": backend, "out": os.path.join(tmp, "out.pt")},
                   spec)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT), os.environ.get("PYTHONPATH", "")]))
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "item_alignment_torch.parallel.dryrun",
             "--rank", str(r), "--spec", spec], env=env, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            logs[bad[0]].seek(0)
            raise RuntimeError(
                f"rank {bad[0]} of {world} ended with {procs[bad[0]].returncode}"
                f":\n{logs[bad[0]].read()[-4000:]}")
        for f in logs:
            f.close()
        return torch.load(os.path.join(tmp, "out.pt"), weights_only=False)


def run_all(calls, device=None) -> list:
    """Several calls in one process group, each on ``device``: ``calls`` is
    a list of (name of a function of this module, args[, kwargs]); their
    results in order."""
    out = []
    for name, args, *kw in calls:
        kwargs = kw[0] if kw else {}
        out.append(globals()[name](*args, device=device, **kwargs))
    return out


def _worker(rank: int, spec_path: str) -> None:
    import importlib

    from item_alignment_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    module, name = spec["fn"]
    fn = getattr(importlib.import_module(module), name)
    initialize_distributed(f"127.0.0.1:{spec['port']}", spec["world"], rank,
                           spec["device"], spec["backend"])
    try:
        result = fn(*spec["args"])
        if rank == 0:
            torch.save(result, spec["out"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the text step
# ---------------------------------------------------------------------------

def _mesh(mesh) -> MeshConfig:
    return MeshConfig(*mesh) if mesh is not None else MeshConfig(1, 1, 1)


def text_config(dropout: float = 0.0, **kw) -> ModelConfig:
    return ModelConfig(**{**TINY, **kw}, hidden_dropout_prob=dropout,
                       attention_probs_dropout_prob=dropout)


def text_batch(cfg: ModelConfig, B: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Pairs with a ragged pad tail, half of them labelled 1."""
    rs = np.random.RandomState(seed)
    S = cfg.pair_seq_len
    lens = rs.randint(S // 2, S + 1, size=B)
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    ids = rs.randint(5, cfg.vocab_size, (B, S)).astype(np.int32) * mask
    return {"input_ids": ids, "attention_mask": mask,
            "labels": (np.arange(B) % 2).astype(np.int32)}


def _trainer(model, mesh, B: int, device, **kw):
    from item_alignment_torch.engine.train import Trainer

    tcfg = TrainConfig(seed=0, train_batch_size=B, eval_batch_size=B,
                       num_epochs=1, log_steps=10 ** 9, mesh=_mesh(mesh),
                       optimizer=OptimizerConfig(**{**OPT, **kw}))
    return Trainer(model, tcfg, device=device)


def _capture_grads(trainer) -> Dict[str, torch.Tensor]:
    """The whole gradients the optimizer is handed at each step (the last
    step's stay)."""
    from item_alignment_torch.parallel.sharding import full_tensor

    trainer.setup()
    grads: Dict[str, torch.Tensor] = {}
    step = trainer.optimizer.step

    def recording():
        grads.update({n: full_tensor(p.grad).detach().cpu().clone()
                      for n, p in trainer.optimizer.params.items()
                      if p.grad is not None})
        return step()

    trainer.optimizer.step = recording
    return grads


def text_step(mesh=None, dropout: float = 0.0, state=None, B: int = 8,
              steps: int = 1, device=None, dtype: str = "float32",
              width: Optional[dict] = None, **opt) -> Dict[str, Any]:
    """``steps`` Trainer steps of the tiny RobertaOneTower (weights from
    seed 0, or ``state``; ``width`` overrides ``TINY``: the CUDA kernels
    take heads of 32, 64 or 128) on one global batch of ``B`` pairs, on
    ``mesh`` (data, fsdp, tensor sizes; None: one device)."""
    from item_alignment_torch.models.text import RobertaOneTower

    cfg = text_config(dropout, dtype=dtype, **(width or {}))
    model = RobertaOneTower(cfg, device=device,
                            seed=0 if state is None else None)
    if state is not None:
        model.load_state_dict(state)
    trainer = _trainer(model, mesh, B, device, **opt)
    grads = _capture_grads(trainer)
    batch = text_batch(cfg, B)
    losses = [float(trainer.train_step(batch)) for _ in range(steps)]
    return {"losses": losses, "grads": grads,
            "params": trainer._host_params(),
            "mu": {n: t.cpu() for n, t in
                   trainer.optimizer.state_dict()["mu"].items()}}


def held_param_bytes(mesh=None, device=None, layers: int = 4,
                     B: int = 8) -> Dict[str, int]:
    """The parameter bytes this rank holds as each attention block starts,
    at most over one training step of a ``layers``-layer tiny
    RobertaOneTower (``peak``), beside the whole model's bytes (``whole``)
    and one layer's (``layer``).  FSDP2 gathers a block only while it runs,
    so over an fsdp axis of f the peak is the root's parameters, one whole
    layer and 1/f of each other layer."""
    from item_alignment_torch.engine.optim import local
    from item_alignment_torch.models.encoder import SelfAttention
    from item_alignment_torch.models.text import RobertaOneTower

    cfg = text_config(0.0, num_hidden_layers=layers)
    model = RobertaOneTower(cfg, device=device, seed=0)

    def nbytes(params):
        return sum(local(p).numel() * p.element_size() for p in params)

    whole = nbytes(model.parameters())
    layer = nbytes(model.roberta.encoder.layer_0.parameters())
    trainer = _trainer(model, mesh, B, device).setup()
    peak = [0]

    def held(*_):
        peak[0] = max(peak[0], nbytes(model.parameters()))

    for m in model.modules():
        if isinstance(m, SelfAttention):
            m.register_forward_pre_hook(held)
    trainer.train_step(text_batch(cfg, B))
    return {"peak": peak[0], "whole": whole, "layer": layer}


def eval_probs(mesh=None, quant: Optional[str] = None, device=None,
               B: int = 8) -> np.ndarray:
    """``Trainer.evaluate``'s probabilities of a RobertaOneTower at JAX's
    test width (hidden 64, 4 heads, FFN 128) from seed 0."""
    from item_alignment_torch.data.datasets import ArrayDataset
    from item_alignment_torch.models.text import RobertaOneTower

    cfg = text_config(0.0, hidden_size=64, intermediate_size=128, quant=quant)
    trainer = _trainer(RobertaOneTower(cfg, device=device, seed=0), mesh, B,
                       device)
    return trainer.evaluate(ArrayDataset(text_batch(cfg, B, seed=3)))["probs"]


def resume_steps(mesh, directory: str, restore_from: Optional[str] = None,
                 device=None, B: int = 8) -> Dict[str, Any]:
    """Two steps, a train-state checkpoint in ``directory``, one more step;
    then a new ``Trainer`` restores the checkpoint (or the one in
    ``restore_from``, written elsewhere) and takes that step again."""
    from item_alignment_torch.engine.checkpoint import CheckpointManager
    from item_alignment_torch.models.text import RobertaOneTower

    cfg = text_config(0.1)
    batch = text_batch(cfg, B)
    t1 = _trainer(RobertaOneTower(cfg, device=device, seed=0), mesh, B,
                  device, warmup_proportion=0.0)
    for _ in range(2):
        t1.train_step(batch)
    manager = CheckpointManager(directory, keep=2)
    t1.save_checkpoint(manager, epoch=0, best_f1=0.5)
    continued = float(t1.train_step(batch))
    t2 = _trainer(RobertaOneTower(cfg, device=device, seed=1), mesh, B,
                  device, warmup_proportion=0.0)
    meta = t2.restore_checkpoint(CheckpointManager(restore_from or directory))
    resumed = float(t2.train_step(batch))
    return {"continued": continued, "resumed": resumed, "meta": meta,
            "params_continued": t1._host_params(),
            "params_resumed": t2._host_params()}


LEGACY_LENS = {"pvs": 24, "title": 16, "cate": 8, "cate_path": 12,
               "industry_name": 8}


def legacy_adversarial_steps(mesh=None, mode: str = "PGD",
                             device=None, B: int = 8,
                             steps: int = 2) -> Dict[str, Any]:
    """Two steps of the legacy ``BertAlignModel`` (12 heads of 8, dropout
    0.1) with adversarial noise on its pvs and title fields: the deltas
    stay whole on every rank and take the whole batch's gradient."""
    from item_alignment_torch.data.bert_data import align_kwargs
    from item_alignment_torch.engine.train import Trainer
    from item_alignment_torch.models import bert_legacy as bl

    H = 96
    cfg = ModelConfig(model_name="bert_legacy", vocab_size=120, hidden_size=H,
                      num_hidden_layers=2, num_attention_heads=12,
                      intermediate_size=128, max_position_embeddings=64,
                      type_vocab_size=4, hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1)
    rs = np.random.RandomState(20)
    rows = {"labels": (np.arange(B) % 2).astype(np.int32)}
    for name in bl.FIELD_NAMES:
        S = LEGACY_LENS[name]
        lens = rs.randint(S // 2, S + 1, B)
        mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
        rows[f"{name}_input_ids"] = rs.randint(5, 120, (B, S)).astype(
            np.int32) * mask
        rows[f"{name}_attention_mask"] = mask
        rows[f"{name}_token_type_ids"] = (
            (np.arange(S)[None, :] >= lens[:, None] // 2) * mask).astype(
                np.int32)
    tcfg = TrainConfig(seed=5, train_batch_size=B, eval_batch_size=B,
                       log_steps=10 ** 9, mesh=_mesh(mesh),
                       optimizer=OptimizerConfig(learning_rate=2e-3,
                                                 total_steps=16))
    trainer = Trainer(bl.BertAlignModel(cfg, device=device, seed=0), tcfg,
                      device=device, batch_transform=align_kwargs,
                      adversarial=(mode, 0.02, 0.01),
                      noise_spec={k: (LEGACY_LENS[k.split("_")[0]], H)
                                  for k in ("pvs_noise", "title_noise")})
    losses = [float(trainer.train_step(rows)) for _ in range(steps)]
    return {"losses": losses, "params": trainer._host_params(),
            "deltas": {k: d.cpu() for k, d in trainer.deltas.items()}}


# ---------------------------------------------------------------------------
# the other families
# ---------------------------------------------------------------------------

def _step_result(trainer, batch) -> Dict[str, Any]:
    grads = _capture_grads(trainer)
    loss = float(trainer.train_step(batch))
    return {"loss": loss, "grads": grads}


def nfnet_step(mesh=None, device=None, B: int = 8) -> Dict[str, Any]:
    """``ImageTwoTower`` over a one-block NFNet at 32 px, dropout 0.1."""
    from item_alignment_torch.models import image as im

    orig = dict(im.BACKBONES)
    im.BACKBONES["nfnet"] = lambda c: im.NFNet(depths=(1,), channels=(16,))
    try:
        cfg = ModelConfig(model_name="eca_nfnet_l0",
                          image_model_name="eca_nfnet_l0", image_size=32,
                          hidden_dropout_prob=0.1)
        model = im.ImageTwoTower(cfg, device=device, seed=0)
    finally:
        im.BACKBONES.update(orig)
    rs = np.random.RandomState(1)
    batch = {"images_1": rs.rand(B, 32, 32, 3).astype(np.float32),
             "images_2": rs.rand(B, 32, 32, 3).astype(np.float32),
             "labels": (np.arange(B) % 2).astype(np.int32)}
    return _step_result(_trainer(model, mesh, B, device), batch)


def coca_step(mesh=None, device=None, B: int = 8) -> Dict[str, Any]:
    """``CoCaForItemAlignment`` (``sum``) at JAX's dry-run depth, with heads
    of 32 (JAX's are 16 wide, which the CUDA kernels do not take), fp32,
    dropout 0.1 in its text towers."""
    from item_alignment_torch.models.multimodal import CoCaForItemAlignment

    cfg = ModelConfig(model_name="coca", ensemble="sum", hidden_size=128,
                      num_hidden_layers=1, num_attention_heads=4,
                      intermediate_size=256, vocab_size=100,
                      max_position_embeddings=128, image_hidden_size=24,
                      multimodal_depth=1, coca_heads=4, ff_mult=2,
                      image_size=16, patch_size=8, hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1)
    rs = np.random.RandomState(2)
    batch = {"input_ids_1": rs.randint(3, 90, (B, 10)).astype(np.int32),
             "images_1": rs.rand(B, 16, 16, 3).astype(np.float32),
             "input_ids_2": rs.randint(3, 90, (B, 10)).astype(np.int32),
             "images_2": rs.rand(B, 16, 16, 3).astype(np.float32),
             "labels": (np.arange(B) % 2).astype(np.int32)}
    model = CoCaForItemAlignment(cfg, device=device, seed=0)
    return _step_result(_trainer(model, mesh, B, device), batch)


def gcn_step(mesh=None, device=None, B: int = 8) -> Dict[str, Any]:
    """``GCNTwoTower`` at dropout 0.1: the graph and its features whole on
    every rank (each runs the whole spmm and draws the same graph dropout),
    the pair batch over ``data``; loss and whole gradients."""
    from item_alignment_torch.models.graph import GCNTwoTower
    from item_alignment_torch.ops.dropout import batch_rows
    from item_alignment_torch.ops.sparse import Adjacency, normalize_adjacency
    from item_alignment_torch.parallel.mesh import create_mesh
    from item_alignment_torch.parallel.sharding import (
        full_tensor,
        process_slice,
        shard_params,
    )

    device = resolve_device(device)
    rs = np.random.RandomState(0)
    n, f = 24, 8
    feats = torch.as_tensor(rs.randn(n, f).astype(np.float32), device=device)
    ei, ew = normalize_adjacency(
        np.stack([rs.randint(0, n, 60), rs.randint(0, n, 60)]), n)
    adj = Adjacency(ei, ew, n, device=device)
    cfg = ModelConfig(model_name="gcn", gcn_hidden=16, gcn_layers=2,
                      gcn_feature_dim=f, hidden_dropout_prob=0.1)
    model = GCNTwoTower(cfg, device=device, seed=0)
    pairs = {"src": rs.randint(0, n, B), "tgt": rs.randint(0, n, B),
             "labels": np.arange(B) % 2}
    dmesh = create_mesh(_mesh(mesh), device.type)
    rows, ctx = slice(0, B), contextlib.nullcontext()
    if dmesh is not None:
        shard_params(model, dmesh)
        rows = process_slice(B, mesh=dmesh)
        ctx = batch_rows(rows.start, rows.stop - rows.start, B)
    src, tgt, labels = (torch.as_tensor(pairs[k][rows], device=device).long()
                        for k in ("src", "tgt", "labels"))
    with ctx:
        loss = model(feats, adj, src, tgt, labels=labels, deterministic=False,
                     dropout_seed=7).loss
        loss.backward()
    if dmesh is not None:  # FSDP2 averaged the gradients; the loss too
        from item_alignment_torch.parallel.mesh import AXIS_DATA

        loss = loss.detach().clone()
        dist.all_reduce(loss, group=dmesh[AXIS_DATA].get_group())
        loss = loss / dmesh[AXIS_DATA].size()
    return {"loss": float(loss.detach()),
            "grads": {k: full_tensor(p.grad).detach().cpu()
                      for k, p in model.named_parameters()}}


def kge_epoch(mesh=None, device=None) -> Dict[str, Any]:
    """One epoch of the PKGM KGE trainer over a 160-fact KG at batch 16
    (JAX's ``test_kge_family_sharded_epoch_matches_unsharded``)."""
    from item_alignment_torch.kge import KGETrainer, KnowledgeGraph, make_kge_model

    rs = np.random.RandomState(0)
    n_ent, n_rel, n_facts = 50, 5, 160
    kg = KnowledgeGraph(rs.randint(0, n_ent, n_facts),
                        rs.randint(0, n_rel, n_facts),
                        rs.randint(0, n_ent, n_facts), n_ent, n_rel)
    trainer = KGETrainer(make_kge_model("pkgm", n_ent, n_rel, 16), kg,
                         margin=1.0, n_neg=2, batch_size=16, n_epochs=1,
                         learning_rate=1e-2, seed=3, device=device,
                         mesh=mesh)
    out = trainer.run()
    return {"loss": out["history"][0]["loss"],
            "params": {k: v.detach().cpu() for k, v in out["params"].items()}}


def family_steps(mesh=None, device=None, B: int = 8) -> Dict[str, Any]:
    return {"nfnet": nfnet_step(mesh, device, B),
            "coca": coca_step(mesh, device, B),
            "gcn": gcn_step(mesh, device, B),
            "kge": kge_epoch(mesh, device)}


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def mesh_factors(n: int) -> Tuple[int, int, int]:
    """(data, fsdp, tensor) with axes above 1 where n allows (JAX's
    ``_mesh_factors``)."""
    tensor = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % (tensor * 2) == 0 else 1
    return n // (fsdp * tensor), fsdp, tensor


def check_process_slices(B: int, counts=(1, 2, 4, 8)) -> None:
    """Every partition of ``B`` rows into equal process slices is disjoint,
    ordered and complete; a count that does not divide raises."""
    from item_alignment_torch.parallel.sharding import process_slice

    for pc in counts:
        if B % pc:
            continue
        rows = [r for pi in range(pc) for r in range(B)[process_slice(B, pi, pc)]]
        assert rows == list(range(B)), (pc, rows)


def dryrun_multichip(device=None) -> Dict[str, float]:
    """One sharded step of each family on the mesh ``mesh_factors`` picks
    for this process group; the losses (rank 0 prints them)."""
    from item_alignment_torch.parallel.mesh import rank, world_size

    n = world_size()
    mesh = mesh_factors(n)
    B = 2 * mesh[0] * 4
    losses = {"text": text_step(mesh, 0.1, B=B, device=device,
                                width=DRY_WIDTH)["losses"][0]}
    fam = family_steps(mesh, device, B)
    losses.update({k: v["loss"] for k, v in fam.items()})
    check_process_slices(B)
    assert all(np.isfinite(v) for v in losses.values()), losses
    if rank() == 0:
        print(f"dryrun_multichip ok: mesh(data={mesh[0]},fsdp={mesh[1]},"
              f"tensor={mesh[2]}) " + " ".join(
                  f"{k}_loss={v:.4f}" for k, v in losses.items())
              + " process_slices=ok", flush=True)
    return losses


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--spec", default=None)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="cuda (the default, one card a process) or cpu")
    args = p.parse_args(argv)
    if args.spec is not None:
        _worker(args.rank, args.spec)
        return 0
    print(spawn(dryrun_multichip, args.world, args.device, device=args.device,
                timeout=600))
    return 0


if __name__ == "__main__":
    sys.exit(main())
