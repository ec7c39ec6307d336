"""Denoiser backbones and the ModelApply adapter bridging an `nn.Module`
to the functional diffusion core (port of `ddg_tpu/models/__init__.py`):
the DiT and DiMamba (inference and training) and the UNet (inference)."""

from __future__ import annotations

import torch

from ddg_tpu_torch.models.dimamba import DiMamba, DiMambaConfig  # noqa: F401
from ddg_tpu_torch.models.dit import DIT, DITConfig  # noqa: F401
from ddg_tpu_torch.models.unet import UNet, UNetConfig  # noqa: F401


def make_model_apply(module: torch.nn.Module):
    """Wrap a denoiser module into the ModelApply protocol:
    (params, x, sigma, cond, x_emb, *, train, rng,
     return_hidden_states=False, **kwargs) -> logits [, hidden].

    `params` is a {name: tensor} dict over the module's parameters, as
    the head functions of `models.dit` read it. `apply.params` is the
    module's own dict: with it the module runs as it is; any other dict
    runs through `torch.func.functional_call`. With `train=False` the
    forward runs under `torch.no_grad()`; with `train=True` it records
    gradients and applies dropout with masks from the `rng` generator."""
    own = dict(module.named_parameters())

    def run(params, x, sigma, cond, x_emb, kwargs):
        if params is own:
            return module(x, sigma, cond, x_emb, **kwargs)
        return torch.func.functional_call(module, params,
                                          (x, sigma, cond, x_emb), kwargs)

    def apply(params, x, sigma, cond=None, x_emb=None, *,
              train: bool = False, rng=None, **kwargs):
        if train:
            return run(params, x, sigma, cond, x_emb,
                       dict(kwargs, train=True, rng=rng))
        with torch.no_grad():
            return run(params, x, sigma, cond, x_emb, kwargs)

    apply.params = own
    return apply
