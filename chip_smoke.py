#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--seed N]

Phases, one line each; any failure exits non-zero:

1. card: name and power limit from nvidia-smi; TF32 off.
2. build: compile the fused attention kernel from ``item_alignment_torch/csrc``.
3. kernel: the kernel against its plain PyTorch version on the card at the
   serving shapes (B=64, S=510 and S=255, N=16, H=64, bf16) and small fp32
   and other-head-dim cases, with ragged masks, a fully masked row and a
   large-norm row; times of the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only: the port never calls
   it) beside the least time the card could take.
4. cross-encoder: RoBERTa-large ``RobertaOneTower`` (24 layers, hidden 1024,
   S=510, bf16, random weights from --seed) answers batches of 8 pair
   requests; probs checked against the same weights on the plain attention.
5. mining: ``RobertaTwoTower`` at 255 tokens under ``TwoTowerInference``
   encodes 512 items once in batches of 64 and scores 100 pairs per item;
   cached probs checked against a direct two-tower forward.

The launch counter of the kernel is zeroed before phase 4 and read after each
serving run: every attention call of those forwards must be a kernel launch.
The line before the last is one JSON object with the kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from item_alignment_torch.config import ModelConfig
from item_alignment_torch.engine.inference import (
    TwoTowerInference,
    two_tower_encode_fn,
    two_tower_head_fn,
)
from item_alignment_torch.models.text import RobertaOneTower, RobertaTwoTower
from item_alignment_torch.ops import cuda_attention
from item_alignment_torch.ops.attention import make_attention_bias

ROOT = Path(__file__).resolve().parent
# H100 SXM datasheet peaks (dense): bf16 tensor cores, fp32 without them, HBM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
KERNEL_CASES = [  # (label, B, S, N, H, dtype); the first is the main shape
    ("bf16 S=510", 64, 510, 16, 64, torch.bfloat16),
    ("bf16 S=255", 64, 255, 16, 64, torch.bfloat16),
    ("bf16 H=32", 4, 130, 4, 32, torch.bfloat16),
    ("bf16 H=128", 4, 130, 4, 128, torch.bfloat16),
    ("fp32 H=64", 4, 130, 4, 64, torch.float32),
    ("fp32 H=128", 4, 130, 4, 128, torch.float32),
]
LAYERS = 24


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ragged_mask(B: int, S: int, gen: torch.Generator, lo: int = 1
                ) -> torch.Tensor:
    lens = torch.randint(lo, S + 1, (B,), generator=gen, device="cuda")
    return (torch.arange(S, device="cuda")[None, :] < lens[:, None]).long()


def phase_card() -> str:
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    print(f"phase 1 card: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_attention.load_library()
    info = cuda_attention.BUILD_INFO
    regs = [ln.split(":", 1)[1].strip() for ln in info["log"].splitlines()
            if "Used" in ln and "registers" in ln]
    print(f"phase 2 build: {time.perf_counter() - t0:.3f} s "
          f"({Path(info['path']).name}; ptxas: {'; '.join(regs)})",
          flush=True)


def phase_kernel(gen: torch.Generator) -> dict:
    main = None
    worst = 0.0
    for label, B, S, N, H, dt in KERNEL_CASES:
        q, k, v = (torch.randn(B, S, N, H, device="cuda", generator=gen)
                   for _ in range(3))
        q[2] *= 30.0  # a large-norm row
        k[2] *= 30.0
        if dt == torch.float32:
            # a 1/8 grid makes every q.k exact in fp32, so the comparison
            # does not hinge on the summation order of x30 scores
            q, k = torch.round(q * 8) / 8, torch.round(k * 8) / 8
        mask = ragged_mask(B, S, gen)
        mask[1] = 0  # a fully masked row, as mine's padded tail batch
        bias = make_attention_bias(mask)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)

        out = cuda_attention.fused_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref = cuda_attention.fused_attention_reference(
            q.float(), k.float(), v.float(), bias)
        err = (out.float() - ref).abs().max().item()
        uniform = (out[1].float() - v[1].float().mean(0, keepdim=True)
                   ).abs().max().item()
        check(bool(torch.isfinite(out).all()), f"kernel {label}: non-finite")
        check(err <= TOL[dt], f"kernel {label}: max abs err {err} > {TOL[dt]}")
        check(uniform <= TOL[dt],
              f"kernel {label}: masked row off the mean of v by {uniform}")
        worst = max(worst, err)

        iters = 20 if B * S > 10_000 else 50
        ms = cuda_ms(lambda: cuda_attention.fused_attention(q, k, v, bias),
                     iters)
        plain_ms = cuda_ms(
            lambda: cuda_attention.fused_attention_reference(q, k, v, bias),
            3, warmup=1)
        sdpa_mask = bias.to(dt)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=sdpa_mask), iters)
        nbytes = 4 * B * S * N * H * q.element_size() + B * S * 4
        flops = 4 * B * N * S * S * H
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[dt] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        print(f"phase 3 kernel {label} (B={B} S={S} N={N} H={H}): "
              f"max_abs_err {err:.3e} (tol {TOL[dt]:g}), masked-row err "
              f"{uniform:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)",
              flush=True)
        if main is None:
            main = row
        del q, k, v, out, ref
    main["max_abs_err"] = worst
    return main


def pair_batch(B: int, S: int, vocab: int, gen: torch.Generator):
    """Token ids with ragged lengths, pad id 0 after each row's end."""
    mask = ragged_mask(B, S, gen, lo=S // 4)
    ids = torch.randint(5, vocab, (B, S), generator=gen, device="cuda")
    return ids * mask, mask


def phase_cross_encoder(cfg: ModelConfig, seed: int, gen: torch.Generator
                        ) -> int:
    model = RobertaOneTower(cfg, seed=seed).eval()
    S, batches = cfg.pair_seq_len, 2
    reqs = [pair_batch(8, S, cfg.vocab_size, gen) for _ in range(batches + 1)]
    probs, times = [], []
    before = cuda_attention.LAUNCHES
    with torch.inference_mode():
        for ids, mask in reqs:  # the first batch warms up
            t0 = time.perf_counter()
            p = model(ids, mask).probs
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            probs.append(p)
    launches = cuda_attention.LAUNCHES - before
    check(launches == LAYERS * len(reqs),
          f"cross-encoder: {launches} kernel launches for {len(reqs)} "
          f"forwards of {LAYERS} layers")
    got = torch.cat(probs)
    check(bool(torch.isfinite(got).all()) and got.min() >= 0
          and got.max() <= 1, "cross-encoder: probs not finite in [0, 1]")

    plain = RobertaOneTower(cfg.replace(use_flash_attention=False),
                            seed=None).eval()
    plain.load_state_dict(model.state_dict())
    with torch.inference_mode():
        ref = torch.cat([plain(ids, mask).probs for ids, mask in reqs])
    diff = (got - ref).abs().max().item()
    check(diff <= 2e-2, f"cross-encoder: kernel vs plain probs differ {diff}")
    served = 8 * batches
    pairs_s = served / sum(times[1:])
    print(f"phase 4 cross-encoder: {served} pairs at S={S} in "
          f"{sum(times[1:]) * 1e3:.2f} ms ({pairs_s:.2f} pairs/s; warm-up "
          f"batch {times[0] * 1e3:.1f} ms), {launches} launches "
          f"({LAYERS}/forward), probs vs plain attention max diff "
          f"{diff:.3e}", flush=True)
    del model, plain
    torch.cuda.empty_cache()
    return launches


def phase_mining(cfg: ModelConfig, seed: int, gen: torch.Generator) -> int:
    cfg = cfg.replace(interaction_type="two_tower")
    model = RobertaTwoTower(cfg, seed=seed + 1).eval()
    S, n_items, enc_batch, per_item = cfg.item_seq_len, 512, 64, 100
    ids, mask = pair_batch(n_items, S, cfg.vocab_size, gen)
    item_ids = [f"item{i}" for i in range(n_items)]
    batches = [{"input_ids": ids[s:s + enc_batch],
                "attention_mask": mask[s:s + enc_batch]}
               for s in range(0, n_items, enc_batch)]
    inf = TwoTowerInference(two_tower_encode_fn(model),
                            two_tower_head_fn(model), batch_size=4096)

    before = cuda_attention.LAUNCHES
    t0 = time.perf_counter()
    cache = inf.build_cache(item_ids, batches)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    src = torch.arange(n_items).repeat_interleave(per_item).numpy()
    tgt = torch.randint(0, n_items, (n_items * per_item,),
                        generator=torch.Generator().manual_seed(seed)).numpy()
    t0 = time.perf_counter()
    probs = inf.score_pairs(src, tgt)
    score_s = time.perf_counter() - t0
    launches = cuda_attention.LAUNCHES - before
    check(launches == LAYERS * len(batches),
          f"mining: {launches} kernel launches for {len(batches)} encode "
          f"batches of {LAYERS} layers")
    check(tuple(cache.shape) == (n_items, cfg.hidden_size),
          f"mining: cache shape {tuple(cache.shape)}")
    check(probs.shape == (len(src),) and bool(
        ((probs >= 0) & (probs <= 1)).all()), "mining: probs not in [0, 1]")

    idx = slice(0, 8 * per_item, per_item)  # 8 pairs from 8 source items
    s8, t8 = torch.as_tensor(src[idx]).cuda(), torch.as_tensor(tgt[idx]).cuda()
    direct_before = cuda_attention.LAUNCHES
    with torch.inference_mode():
        direct = model(ids[s8], ids[t8], mask[s8], mask[t8]).probs
    direct_launches = cuda_attention.LAUNCHES - direct_before
    check(direct_launches == 2 * LAYERS,
          f"mining: {direct_launches} launches for one two-tower forward")
    diff = (torch.as_tensor(probs[idx]).cuda() - direct).abs().max().item()
    check(diff <= 2e-2, f"mining: cached vs direct probs differ {diff}")
    pairs_s = len(src) / (encode_s + score_s)
    print(f"phase 5 mining: {n_items} items at S={S} encoded in "
          f"{encode_s:.4f} s, {len(src)} pairs scored in {score_s:.4f} s "
          f"({pairs_s:.1f} pairs/s end to end), {launches} launches "
          f"({LAYERS}/encode batch, {direct_launches}/two-tower pair "
          f"forward), cached vs direct probs max diff {diff:.3e}", flush=True)
    return launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    phase_card()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kernel = phase_kernel(gen)

    cfg = ModelConfig.from_json(str(ROOT / "configs" / "roberta_large.json"),
                                max_seq_len=50, max_seq_len_pv=205,
                                dtype="bfloat16")
    check(cfg.num_hidden_layers == LAYERS and cfg.head_dim == 64,
          "unexpected roberta_large config")
    cuda_attention.LAUNCHES = 0  # the main path starts here
    launches = phase_cross_encoder(cfg, args.seed, gen)
    launches += phase_mining(cfg, args.seed, gen)
    check(cuda_attention.LAUNCHES >= launches > 0,
          "the main path launched no kernel")

    print(json.dumps({"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "item_alignment_torch/csrc/fused_attention.cu",
        "replaces": "item_alignment_tpu/ops/pallas_attention.py:63",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
