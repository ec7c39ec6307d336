"""Entry points of the port (counterpart of `__graft_entry__.py:19-57`).

`flagship()` builds the serving flagship: the LM1B-class DiT-small MDLM
denoiser (hidden 768, cond_dim 128, 12 blocks of 12 heads, L=128,
V=30523 = bert-base + mask, 2 classes + the null class) in bf16 with a
bf16 vocab head, running its attention and adaLN chains through the
Hopper kernels (`fused_rope_attn=True`, `fused_adaln=True`). The weights
are seeded random ones in the reference layout
(`convert.make_reference_dit_state_dict`) until a published checkpoint
is in the repository.

`entry()` returns one denoiser forward to log-probs with example inputs.

Both run on the card unless the caller passes `device='cpu'`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ddg_tpu_torch.convert import make_reference_dit_state_dict
from ddg_tpu_torch.diffusion import DiffusionSpec, log_x_theta
from ddg_tpu_torch.models import DIT, DITConfig, make_model_apply
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise


def resolve_device(device=None) -> torch.device:
    """`device`, defaulting to the current CUDA card; raises when a CUDA
    device is asked for and none is visible."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is visible; pass device="cpu" '
                           'to run on the CPU')
    return device


def flagship(tiny: bool = False, device=None, *, seed: int = 0):
    """Returns (spec, cfg, model, model_apply, params) on `device`."""
    device = resolve_device(device)
    if tiny:
        cfg = DITConfig(hidden_size=64, cond_dim=32, length=32, n_blocks=2,
                        n_heads=2, vocab_size=258)
    else:
        cfg = DITConfig(hidden_size=768, cond_dim=128, length=128,
                        n_blocks=12, n_heads=12, vocab_size=30523)
    cfg = dataclasses.replace(cfg, num_classes=2,
                              logits_dtype=torch.bfloat16,
                              fused_rope_attn=True, fused_adaln=True)
    spec = DiffusionSpec(diffusion='absorbing_state',
                         parameterization='subs', noise=LogLinearNoise(),
                         vocab_size=cfg.vocab_size,
                         mask_index=cfg.vocab_size - 1, num_classes=2)
    model = DIT(cfg)
    model.load_state_dict(make_reference_dit_state_dict(
        np.random.RandomState(seed), hidden=cfg.hidden_size,
        cond_dim=cfg.cond_dim, n_blocks=cfg.n_blocks,
        vocab=cfg.vocab_size, with_cond=True), strict=True)
    model = model.to(device).eval()
    apply_fn = make_model_apply(model)
    return spec, cfg, model, apply_fn, apply_fn.params


def entry(device=None):
    """Returns (fn, example_args): fn(params, x, sigma) -> log-probs of one
    flagship forward, B=8."""
    spec, cfg, _, apply_fn, params = flagship(device=device)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, cfg.vocab_size, (8, cfg.length), generator=gen,
                      device=dev, dtype=torch.int32)
    sigma = torch.full((8,), 0.5, device=dev)

    def fn(params, x, sigma):
        with torch.no_grad():
            return log_x_theta(spec, apply_fn, params, x, sigma)

    return fn, (params, x, sigma)
