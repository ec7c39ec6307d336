"""Optimizer and LR schedules (port of `ddg_tpu/runtime/optim.py`).

`make_optimizer` is optax's `chain(clip_by_global_norm(grad_clip),
adamw(schedule, b1, b2, eps, weight_decay))` over a list of float32
tensors, updated in place:

* the clip scales by max_norm / ||g|| only when ||g|| >= max_norm, with no
  epsilon (unlike `torch.nn.utils.clip_grad_norm_`), on the card, with no
  host sync;
* AdamW is `torch.optim.AdamW`, whose decoupled decay (p -= lr wd p) and
  bias-corrected moments are optax's arithmetic;
* the schedule is read at the update count before the update, so the
  first update under `constant_warmup` has lr = schedule(0) = 0.

Schedules:
  * `constant_warmup`: linear 0 -> lr over num_warmup_steps, then constant;
  * `cosine_decay_warmup`: timm CosineLRScheduler with warmup_prefix,
    linear warmup_lr_init -> lr over warmup_t, then cosine lr -> lr_min
    over t_initial.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List

import torch


@dataclasses.dataclass(frozen=True)
class OptimSpec:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    scheduler: str = 'constant_warmup'
    num_warmup_steps: int = 2500
    # cosine_decay_warmup (reference defaults)
    max_steps: int = 1_000_000
    warmup_frac: float = 0.1
    warmup_lr_init: float = 1e-6
    lr_min: float = 1e-6


def constant_warmup_schedule(lr: float, num_warmup_steps: int
                             ) -> Callable[[int], float]:
    if num_warmup_steps <= 0:
        return lambda step: lr
    return lambda step: lr * min(1.0, step / max(1.0, num_warmup_steps))


def cosine_decay_warmup_schedule(lr: float, warmup_t: int, t_initial: int,
                                 warmup_lr_init: float, lr_min: float
                                 ) -> Callable[[int], float]:
    """timm CosineLRScheduler(t_in_epochs=False, warmup_prefix=True)."""
    def schedule(step):
        if step < warmup_t:
            return warmup_lr_init + step * (lr - warmup_lr_init) / max(
                1.0, warmup_t)
        t = min(max(step - warmup_t, 0.0), t_initial)
        return lr_min + 0.5 * (lr - lr_min) * (
            1.0 + math.cos(math.pi * t / max(1.0, t_initial)))
    return schedule


def make_schedule(spec: OptimSpec) -> Callable[[int], float]:
    if spec.scheduler == 'constant_warmup':
        return constant_warmup_schedule(spec.lr, spec.num_warmup_steps)
    if spec.scheduler == 'cosine_decay_warmup':
        warmup_t = int(spec.warmup_frac * spec.max_steps)
        return cosine_decay_warmup_schedule(
            spec.lr, warmup_t, spec.max_steps - warmup_t,
            spec.warmup_lr_init, spec.lr_min)
    raise NotImplementedError(
        f'LR scheduler {spec.scheduler} not implemented.')


class Optimizer:
    """clip_by_global_norm + AdamW with a schedule over `params`, float32
    tensors that `step` updates in place."""

    def __init__(self, spec: OptimSpec, params: List[torch.Tensor]):
        self.spec = spec
        self.params = list(params)
        self.schedule = make_schedule(spec)
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=0.0, betas=(spec.beta1, spec.beta2),
            eps=spec.eps, weight_decay=spec.weight_decay)

    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """One update from `grads` (clipped in place). Returns the global
        norm of the unclipped grads, on their device."""
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        max_norm = self.spec.grad_clip
        factor = torch.where(norm < max_norm, torch.ones_like(norm),
                             max_norm / norm)
        torch._foreach_mul_(grads, factor)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.param_groups[0]['lr'] = self.schedule(self.count)
        self.adamw.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return norm


def make_optimizer(spec: OptimSpec, params: List[torch.Tensor]) -> Optimizer:
    return Optimizer(spec, params)
