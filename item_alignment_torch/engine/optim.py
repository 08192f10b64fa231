"""AdamW with the reference's no-decay groups and the linear warmup + linear
decay schedule.

Port of ``item_alignment_tpu/engine/optim.py``.  Parameters are the model's
``named_parameters()``; the masks name them by their Flax paths
(``convert.flax_path``), so they select the same parameters as the JAX
package's masks do on the Flax tree.  Plain torch (``torch._foreach_*``):
the JAX package has no Pallas kernel for the optimizer.

``Optimizer`` is ``make_optimizer``'s chain: optional global-norm clipping,
``FusedAdamW``, zeroed updates for frozen parameters, and optional gradient
accumulation (the running mean of ``optax.MultiSteps``).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping

import torch

from item_alignment_torch.config import OptimizerConfig
from item_alignment_torch.convert import flax_path


def decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True (decay) for dense kernels and embedding tables; False for
    biases and LayerNorm scale/bias."""
    out = {}
    for name in names:
        keys = flax_path(name)
        in_layernorm = any("layer_norm" in k or "LayerNorm" in k for k in keys)
        out[name] = keys[-1] in ("kernel", "embedding") and not in_layernorm
    return out


def freeze_mask(names: Iterable[str], patterns) -> Dict[str, bool]:
    """True (frozen) for parameters whose '/'-joined Flax path contains any
    pattern; dots in patterns are read as '/'."""
    pats = [str(p).replace(".", "/") for p in patterns]
    return {name: any(p in "/".join(flax_path(name)) for p in pats)
            for name in names}


def linear_warmup_decay(cfg: OptimizerConfig) -> Callable[[int], float]:
    """Learning rate at a step: 0 -> lr over the warmup, then lr -> 0."""
    warmup = max(int(cfg.total_steps * cfg.warmup_proportion), 1)
    decay = max(cfg.total_steps - warmup, 1)
    lr = cfg.learning_rate

    def schedule(step: int) -> float:
        if step < warmup:
            return lr * max(step, 0) / warmup
        return lr * (1.0 - min(step - warmup, decay) / decay)

    return schedule


class FusedAdamW:
    """AdamW in one pass over the tensors: fp32 arithmetic, moments stored
    in ``state_dtype``, bias correction, weight decay where ``decay`` says.
    ``update`` returns the updates (``-lr * (m_hat / (sqrt(v_hat) + eps) +
    wd * p)``) without applying them."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 schedule: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float, decay: Mapping[str, bool],
                 state_dtype: torch.dtype = torch.float32):
        self.params = dict(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.decay = [n for n in self.params if decay[n]] if weight_decay else []
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=state_dtype)
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=state_dtype)
                   for n, p in self.params.items()}

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        names = list(self.params)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        g32 = [grads[n].float() for n in names]
        mu = torch._foreach_mul([self.mu[n].float() for n in names], self.b1)
        torch._foreach_add_(mu, g32, alpha=1.0 - self.b1)
        nu = torch._foreach_mul([self.nu[n].float() for n in names], self.b2)
        torch._foreach_addcmul_(nu, g32, g32, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        out = dict(zip(names, upd))
        if self.decay:
            torch._foreach_add_([out[n] for n in self.decay],
                                [self.params[n].float() for n in self.decay],
                                alpha=self.wd)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_copy_([self.mu[n] for n in names], mu)
        torch._foreach_copy_([self.nu[n] for n in names], nu)
        return out


class Optimizer:
    """``make_optimizer``'s chain over ``params`` (name -> parameter).
    ``step`` reads each parameter's ``.grad`` (None counts as zero)."""

    def __init__(self, cfg: OptimizerConfig,
                 params: Mapping[str, torch.Tensor]):
        self.cfg = cfg
        self.params = dict(params)
        names = list(self.params)
        state_dtype = getattr(torch, cfg.state_dtype) if cfg.fused else torch.float32
        self.adamw = FusedAdamW(self.params, linear_warmup_decay(cfg), cfg.b1,
                                cfg.b2, cfg.eps, cfg.weight_decay,
                                decay_mask(names), state_dtype)
        frozen = freeze_mask(names, cfg.freeze_patterns)
        self.trained = [n for n in names if not frozen[n]]
        self.mini_step = 0
        self.acc: Dict[str, torch.Tensor] = {}

    def _grads(self) -> Dict[str, torch.Tensor]:
        return {n: torch.zeros_like(p) if p.grad is None else p.grad
                for n, p in self.params.items()}

    @torch.no_grad()
    def step(self) -> bool:
        """One mini-step; returns whether the parameters were updated."""
        grads = self._grads()
        k = self.cfg.grad_accumulation_steps
        if k > 1:
            n = self.mini_step
            self.acc = {name: g.float().clone() if n == 0
                        else self.acc[name] + (g.float() - self.acc[name]) / (n + 1)
                        for name, g in grads.items()}
            self.mini_step = (n + 1) % k
            if self.mini_step:
                return False
            grads, self.acc = self.acc, {}
        if self.cfg.max_grad_norm:
            grads = clip_by_global_norm(grads, self.cfg.max_grad_norm)
        upd = self.adamw.update(grads)
        torch._foreach_add_([self.params[n] for n in self.trained],
                            [upd[n] for n in self.trained])
        return True

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def state_dict(self) -> Dict[str, object]:
        """What a resumed run needs: the AdamW moments (in their storage
        dtype) and step count, which is also the schedule's position, and
        the gradient-accumulation window."""
        return {"count": self.adamw.count, "mu": dict(self.adamw.mu),
                "nu": dict(self.adamw.nu), "mini_step": self.mini_step,
                "acc": dict(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping[str, object]) -> None:
        for ours, theirs in ((self.adamw.mu, state["mu"]),
                             (self.adamw.nu, state["nu"])):
            if ours.keys() != theirs.keys():
                raise KeyError("optimizer state names differ from the model's")
            for name, t in ours.items():
                if theirs[name].dtype != t.dtype:
                    raise TypeError(
                        f"moment {name} was saved as {theirs[name].dtype}, "
                        f"this optimizer stores {t.dtype}")
                t.copy_(theirs[name])
        self.adamw.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.acc = {n: t.to(self.params[n].device)
                    for n, t in state["acc"].items()}


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Dict[str, torch.Tensor]:
    """Scale every gradient by max_norm / norm when the global norm is not
    below max_norm (no host synchronisation)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads.values()]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return {n: g * factor.to(g.dtype) for n, g in grads.items()}


def make_optimizer(cfg: OptimizerConfig, params: Mapping[str, torch.Tensor]
                   ) -> Optimizer:
    return Optimizer(cfg, params)

