"""Adversarial embedding-noise training (FREE / PGD / MIX).

Port of ``item_alignment_tpu/engine/adversarial.py``: FGSM-style sign
updates of persistent embedding-space deltas, clamped to the epsilon ball.

- FREE: delta <- clamp(delta + eps * sign(grad), +-eps)
- PGD:  delta <- clamp(U(-eps, eps) + alpha * sign(grad), +-eps)
- MIX:  one draw u ~ U(0, 1) a step for all deltas: u < 0.15 FREE,
  u < 0.45 PGD, else every stored delta becomes zero (the JAX package
  multiplies the new deltas by ``u < 0.45``, so the "off" branch zeroes
  them; its docstring's "kept" is not what the code does).

The deltas' gradients come from the same ``backward()`` as the
parameters'.  ``update_deltas`` draws from generators seeded with the
``seed`` it is given (``Trainer`` passes a pure function of ``(config.seed,
step)``, so a resumed run draws what the uninterrupted one drew): MIX's
``u`` on the host, so the branch costs no wait for the device, the PGD
restarts on the deltas' device.  ``u`` and the restarts can also be passed
in, so that a test gives both packages the same draws; the JAX package
draws from threefry, which torch does not reproduce.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from item_alignment_torch.ops.dropout import fold_seed

MODES = ("FREE", "PGD", "MIX")
P_FREE, P_PGD = 0.15, 0.45


def free_update(delta: torch.Tensor, grad: torch.Tensor, epsilon: float
                ) -> torch.Tensor:
    return torch.clamp(delta + epsilon * torch.sign(grad), -epsilon, epsilon)


def pgd_update(delta: torch.Tensor, grad: torch.Tensor, epsilon: float,
               alpha: float, generator: Optional[torch.Generator] = None,
               restart: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``restart`` is U(-eps, eps) of ``delta``'s shape; drawn from
    ``generator`` when not given."""
    if restart is None:
        u = torch.rand(delta.shape, generator=generator, device=delta.device,
                       dtype=delta.dtype)
        restart = u * (2.0 * epsilon) - epsilon
    return torch.clamp(restart + alpha * torch.sign(grad), -epsilon, epsilon)


def mix_update(delta: torch.Tensor, grad: torch.Tensor, epsilon: float,
               alpha: float, u: float,
               generator: Optional[torch.Generator] = None,
               restart: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, float]:
    """(the FREE, PGD or unchanged delta picked by ``u``, active): active
    is 0.0 where ``u`` turns the noise off."""
    if u < P_FREE:
        new = free_update(delta, grad, epsilon)
    elif u < P_PGD:
        new = pgd_update(delta, grad, epsilon, alpha, generator, restart)
    else:
        new = delta
    return new, float(u < P_PGD)


def update_deltas(mode: str, deltas: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], epsilon: float,
                  alpha: float, seed: Optional[int] = None,
                  u: Optional[float] = None,
                  restarts: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """One FREE/PGD/MIX update of the deltas from their loss gradients.
    What is not given is drawn from ``seed``: MIX's ``u`` from a CPU
    generator, then each PGD restart, in the order of ``deltas``, from one
    generator on their device."""
    if mode not in MODES:
        raise ValueError(f"unknown adversarial mode {mode}")
    restarts = restarts or {}
    if mode == "FREE":
        return {k: free_update(d, grads[k], epsilon)
                for k, d in deltas.items()}
    generator = None
    if seed is not None and deltas:
        device = next(iter(deltas.values())).device
        generator = torch.Generator(device=device).manual_seed(
            fold_seed(seed, 1))
    if mode == "PGD":
        return {k: pgd_update(d, grads[k], epsilon, alpha, generator,
                              restarts.get(k)) for k, d in deltas.items()}
    if u is None:
        if seed is None:
            raise ValueError("MIX needs a seed or a draw u")
        host = torch.Generator().manual_seed(fold_seed(seed, 0))
        u = torch.rand((), generator=host, dtype=torch.float64).item()
    out = {}
    for k, d in deltas.items():
        new, active = mix_update(d, grads[k], epsilon, alpha, u, generator,
                                 restarts.get(k))
        out[k] = new * active
    return out
