"""Diffusion core (port of `ddg_tpu/diffusion.py:32-118`): the static
`DiffusionSpec`, sigma processing and the backbone forward with the
parameterization transform. The training losses (`loss_fn`) come with the
training slice."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ddg_tpu_torch.ops import forward_process as fp
from ddg_tpu_torch.ops.noise_schedules import NoiseSchedule

# model_apply(params, x, sigma, cond, x_emb, *, train, rng) -> logits
ModelApply = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionSpec:
    """Static model/process hyperparameters: the fields of `ddg_tpu`'s
    spec that sampling reads (the loss settings come with `loss_fn`)."""
    diffusion: str                  # 'absorbing_state' | 'uniform'
    parameterization: str           # 'subs' | 'd3pm' | 'ar'
    noise: NoiseSchedule
    vocab_size: int                 # includes mask token if added
    mask_index: int
    T: int = 0
    time_conditioning: bool = False
    subs_masking: bool = False
    num_classes: Optional[int] = None

    def __post_init__(self):
        if (self.diffusion != 'absorbing_state'
                and self.parameterization in {'ar', 'subs'}):
            raise ValueError(f'{self.parameterization} needs '
                             'absorbing_state diffusion')
        if self.T > 0 and self.parameterization not in {'d3pm', 'subs'}:
            raise ValueError('T > 0 needs the d3pm or subs '
                             'parameterization')
        if self.subs_masking and self.parameterization != 'd3pm':
            raise ValueError('subs_masking needs the d3pm '
                             'parameterization')


def process_sigma(spec: DiffusionSpec, sigma):
    """Zero sigma unless the model is time-conditioned (the default)."""
    if sigma is None:
        if spec.parameterization != 'ar':
            raise ValueError('sigma is None outside the ar '
                             'parameterization')
        return None
    if sigma.ndim > 1:
        sigma = sigma.squeeze(-1)
    if not spec.time_conditioning:
        sigma = torch.zeros_like(sigma)
    return sigma


def log_x_theta(spec: DiffusionSpec, model_apply: ModelApply, params,
                xt: torch.Tensor, sigma, cond=None, x_emb=None, *,
                train: bool = False, rng=None) -> torch.Tensor:
    """Backbone forward + parameterization transform -> fp32 log-probs."""
    sigma = process_sigma(spec, sigma)
    logits = model_apply(params, xt, sigma, cond, x_emb, train=train,
                         rng=rng).float()
    if spec.parameterization == 'subs':
        return fp.subs_parameterization(logits, xt,
                                        mask_index=spec.mask_index)
    if spec.parameterization in {'ar', 'd3pm'}:
        if spec.subs_masking:
            mask_oh = F.one_hot(torch.tensor(spec.mask_index),
                                spec.vocab_size).to(logits)
            logits = logits + mask_oh * fp.NEG_INFINITY
        return torch.log_softmax(logits, dim=-1)
    return logits
