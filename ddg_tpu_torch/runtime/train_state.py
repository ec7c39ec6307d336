"""Train state and the train/eval steps (port of
`ddg_tpu/runtime/train_state.py`).

One `train_step` is forward, backward, clip, AdamW and EMA over a global
batch, as gradient accumulation over micro-batches, with the metrics
returned as tensors on the card (no host sync inside the step).

The module holds the layers that flax runs in `compute_dtype` with
weights in that dtype (`models/dit.py`); JAX keeps every parameter in
float32 and casts per call. So the state keeps float32 master copies: the
optimizer and the averaging work on them, the micro-batch gradients (each
the gradient of the module's weight, which is flax's gradient through its
cast) are summed in float32 buffers, and after each update the masters
are copied into the module's weights. The state is updated in place;
`train_step` returns it for symmetry with the JAX step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ddg_tpu_torch.diffusion import DiffusionSpec, loss_fn
from ddg_tpu_torch.runtime import averaging
from ddg_tpu_torch.runtime.averaging import AveragingSpec, AveragingState
from ddg_tpu_torch.runtime.optim import (Optimizer, OptimSpec,
                                         make_optimizer, make_schedule)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]     # float32 masters
    opt_state: Optimizer
    averaging: Optional[AveragingState]
    generator: torch.Generator


def init_train_state(generator: torch.Generator, params,
                     optim_spec: OptimSpec,
                     averaging_spec: AveragingSpec) -> TrainState:
    """`params` is the module's own dict (`model_apply.params`); the
    masters are float32 copies of it."""
    masters = {k: v.detach().float().clone() for k, v in params.items()}
    return TrainState(step=0, params=masters,
                      opt_state=make_optimizer(optim_spec,
                                               list(masters.values())),
                      averaging=averaging.init(averaging_spec, masters),
                      generator=generator)


def _x0(spec, batch):
    if spec.parameterization == 'ar':
        return batch['input_ids'], batch['output_ids']
    return batch['input_ids']


def make_train_step(spec: DiffusionSpec, model_apply,
                    optim_spec: OptimSpec, averaging_spec: AveragingSpec,
                    accum_steps: int = 1):
    """The train step: (state, batch) -> (state, metrics).

    batch: 'input_ids' (B, L) int, 'attention_mask' (B, L), optional
    'cond' (B,); for AR, 'input_ids'/'output_ids' are the shifted pair.
    With accum_steps > 1 every entry has a leading (accum_steps, micro,
    ...) shape; the micro-batch gradients are averaged and the optimizer
    and the averaging update once. Dropout, t and x_t are drawn from
    `state.generator`."""
    live = model_apply.params
    names = list(live)
    weights = [live[k] for k in names]
    schedule = make_schedule(optim_spec)

    def train_step(state: TrainState, batch):
        masters = [state.params[k] for k in names]
        grads = [torch.zeros_like(m) for m in masters]
        micro = ([batch] if accum_steps == 1 else
                 [{k: v[i] for k, v in batch.items()}
                  for i in range(accum_steps)])
        loss_sum = nll_sum = count = 0.0
        for mb in micro:
            # Accumulating, the step returns no per-term metric, so a
            # term computed only for one is skipped (XLA drops it from the
            # JAX step).
            out = loss_fn(spec, model_apply, live, _x0(spec, mb),
                          mb['attention_mask'], mb.get('cond'),
                          state.generator, train=True, step=state.step,
                          metrics=accum_steps == 1)
            g = torch.autograd.grad(out.loss, weights, allow_unused=True)
            for acc, gi in zip(grads, g):
                if gi is not None:
                    acc.add_(gi)
            loss_sum = loss_sum + out.loss.detach()
            nll_sum = nll_sum + out.nlls.detach().sum()
            count = count + out.token_mask.sum()
        if accum_steps > 1:
            torch._foreach_div_(grads, float(accum_steps))
        grad_norm = state.opt_state.step(grads)
        with torch.no_grad():
            torch._foreach_copy_(weights, masters)
        averaging.update(averaging_spec, state.averaging, state.params)
        metrics = {
            'loss': loss_sum / accum_steps,
            'nll_sum': nll_sum,
            'token_count': count,
            'lr': torch.full((), schedule(state.step),
                             device=grad_norm.device),
            'grad_norm': grad_norm,
        }
        if accum_steps == 1:
            for name in ('recon_loss', 'diffusion_loss', 'unroll_loss'):
                if getattr(out, name) is not None:
                    metrics[name] = getattr(out, name)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(spec: DiffusionSpec, model_apply, *,
                   use_averaged: bool = True):
    """Validation step: the averaged (EMA/SWA) weights, or the masters,
    cast to the module's dtypes as flax casts per call; label smoothing
    0."""
    own = model_apply.params

    def eval_step(state: TrainState, batch, generator):
        src = (averaging.averaged_params(state.averaging, state.params)
               if use_averaged else state.params)
        params = {k: v.to(own[k].dtype) for k, v in src.items()}
        out = loss_fn(spec, model_apply, params, _x0(spec, batch),
                      batch['attention_mask'], batch.get('cond'), generator,
                      train=False, label_smoothing=0.0)
        return {'nll_sum': out.nlls.sum(),
                'token_count': out.token_mask.sum()}

    return eval_step
