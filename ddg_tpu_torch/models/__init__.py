"""Denoiser backbones, the DiT classifier and the adapters bridging an
`nn.Module` to the functional diffusion core and the guidance (port of
`ddg_tpu/models/__init__.py`): the DiT and DiMamba (inference and
training), the UNet (inference) and the DiT classifier."""

from __future__ import annotations

import torch

from ddg_tpu_torch.models.dimamba import DiMamba, DiMambaConfig  # noqa: F401
from ddg_tpu_torch.models.dit import (DIT, DITClassifier,  # noqa: F401
                                     DITConfig)
from ddg_tpu_torch.models.unet import UNet, UNetConfig  # noqa: F401


def _functional(module, own, params, args, kwargs):
    """module(*args, **kwargs) on `params`: the module's own dict `own` runs
    it as it is, any other dict through `torch.func.functional_call`."""
    if params is own:
        return module(*args, **kwargs)
    return torch.func.functional_call(module, params, args, kwargs)


def _run(module, own, params, args, kwargs, train, rng, grad):
    """`train=True` records gradients and applies dropout with masks from
    `rng`; `train=False` runs without dropout, under `torch.no_grad()`
    unless `grad=True`, which records gradients even inside a caller's
    `no_grad` (the guidance steps differentiate a classifier and the
    denoiser's head while sampling)."""
    if train:
        return _functional(module, own, params, args,
                           dict(kwargs, train=True, rng=rng))
    with torch.set_grad_enabled(grad):
        return _functional(module, own, params, args, kwargs)


def make_model_apply(module: torch.nn.Module):
    """Wrap a denoiser module into the ModelApply protocol:
    (params, x, sigma, cond, x_emb, *, train, rng, grad=False,
     return_hidden_states=False, **kwargs) -> logits [, hidden].

    `params` is a {name: tensor} dict over the module's parameters, as
    the head functions of `models.dit` read it. `apply.params` is the
    module's own dict: with it the module runs as it is; any other dict
    runs through `torch.func.functional_call`. Grad mode and dropout as
    `_run` sets them."""
    own = dict(module.named_parameters())

    def apply(params, x, sigma, cond=None, x_emb=None, *,
              train: bool = False, rng=None, grad: bool = False, **kwargs):
        return _run(module, own, params, (x, sigma, cond, x_emb), kwargs,
                    train, rng, grad)

    apply.params = own
    return apply


def make_classifier_apply(module: torch.nn.Module):
    """Wrap a classifier module into the classifier protocol (port of
    `ddg_tpu/models/__init__.py:84-95`):
    (params, x, sigma, x_emb=None, attention_mask=None, *, train, rng,
     grad=False) -> logits (B, ..., num_classes).

    x is token indices (B, L) or one-hot/soft inputs (B, L, V). `params`,
    `apply.params`, grad mode and dropout as in `make_model_apply`."""
    own = dict(module.named_parameters())

    def apply(params, x, sigma, x_emb=None, attention_mask=None, *,
              train: bool = False, rng=None, grad: bool = False):
        return _run(module, own, params, (x, sigma, x_emb, attention_mask),
                    {}, train, rng, grad)

    apply.params = own
    return apply
