"""Weight averaging, EMA and SWA (port of `ddg_tpu/runtime/averaging.py`)
on {name: float32 tensor} dicts.

EMA: decay_t = min(decay, (1 + n) / (10 + n)) with `use_num_updates`,
shadow <- shadow - (1 - decay_t) (shadow - params). SWA: from start_step,
every avg_frequency steps, shadow <- shadow + (params - shadow) / n. The
counters are host integers (they depend on nothing on the card); the
shadow is updated in place with foreach kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AveragingState:
    shadow_params: Params
    num_updates: int = 0       # EMA update count / SWA snapshot count
    step_counter: int = 0      # SWA: counts every update() call


@dataclasses.dataclass(frozen=True)
class AveragingSpec:
    kind: str                    # 'ema' | 'swa' | 'none'
    decay: float = 0.9999        # ema
    use_num_updates: bool = True  # ema
    start_step: int = 0          # swa
    avg_frequency: int = 1       # swa

    @staticmethod
    def ema(decay: float, use_num_updates: bool = True) -> 'AveragingSpec':
        return AveragingSpec(kind='ema', decay=decay,
                             use_num_updates=use_num_updates)

    @staticmethod
    def swa(max_steps: int, start_pct: float,
            num_snapshots: int) -> 'AveragingSpec':
        start_step = int(max_steps * start_pct)
        avg_frequency = max(1, (max_steps - start_step) // num_snapshots)
        return AveragingSpec(kind='swa', start_step=start_step,
                             avg_frequency=avg_frequency)


def init(spec: AveragingSpec, params: Params) -> Optional[AveragingState]:
    if spec.kind == 'none':
        return None
    return AveragingState({k: v.detach().clone() for k, v in params.items()})


def update(spec: AveragingSpec, state: Optional[AveragingState],
           params: Params) -> Optional[AveragingState]:
    """One averaging step, after each optimizer step; updates `state` in
    place and returns it."""
    if state is None:
        return None
    shadow = list(state.shadow_params.values())
    live = [params[k] for k in state.shadow_params]
    if spec.kind == 'ema':
        state.num_updates += 1
        n = state.num_updates
        decay = spec.decay
        if spec.use_num_updates:
            decay = min(decay, (1.0 + n) / (10.0 + n))
        torch._foreach_lerp_(shadow, live, 1.0 - decay)
        state.step_counter += 1
        return state
    if spec.kind == 'swa':
        state.step_counter += 1
        step = state.step_counter
        if (step >= spec.start_step
                and (step - spec.start_step) % spec.avg_frequency == 0):
            state.num_updates += 1
            torch._foreach_lerp_(shadow, live, 1.0 / state.num_updates)
        return state
    raise NotImplementedError(f'Averaging type {spec.kind} not implemented.')


def averaged_params(state: Optional[AveragingState],
                    params: Params) -> Params:
    """The weights to evaluate with: the shadow when averaging, else the
    live ones."""
    return params if state is None else state.shadow_params
