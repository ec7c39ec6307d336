"""Categorical sampling primitives: Gumbel-max, low-confidence, argmax
(port of `ddg_tpu/ops/sampling.py`). Noise comes from an explicit
`torch.Generator`, or is passed in."""

from __future__ import annotations

import torch


def gumbel_noise_like(shape, *, generator: torch.Generator,
                      dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel(0, 1) noise, -log(-log(u)) with u clamped away
    from 0 (as `jax.random.gumbel`)."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=dtype)
    # In place: one buffer of the noise's size (the AR samplers draw
    # (B, L-1, V) at once).
    return u.clamp_min_(torch.finfo(dtype).tiny).log_().neg_().log_().neg_()


def low_confidence_mask(probs: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """Boolean mask of the bottom-`threshold` cumulative probability mass:
    stable ascending sort, inclusive cumsum, keep cum <= threshold,
    scattered back to vocab order."""
    order = torch.argsort(probs, dim=-1, stable=True)
    sorted_probs = torch.gather(probs, -1, order)
    keep_sorted = torch.cumsum(sorted_probs, dim=-1) <= threshold
    return torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)


def sample_categorical(probs: torch.Tensor, *,
                       generator: torch.Generator | None = None,
                       u: torch.Tensor | None = None,
                       low_confidence_sampling: bool = False,
                       low_confidence_threshold: float = 0.3,
                       argmax_sampling: bool = False) -> torch.Tensor:
    """Token ids from a probability tensor (..., V) by Gumbel-max in the
    reference's form argmax(probs / (1e-10 - log(U + 1e-10))). `u`
    injects the uniforms; otherwise they come from `generator`."""
    if low_confidence_sampling:
        keep = low_confidence_mask(probs, low_confidence_threshold)
        probs = torch.where(keep, probs, torch.zeros_like(probs))
    if argmax_sampling:
        return torch.argmax(probs, dim=-1)
    if u is None:
        u = torch.rand(probs.shape, generator=generator,
                       device=generator.device, dtype=probs.dtype)
    gumbel_norm = 1e-10 - torch.log(u + 1e-10)
    return torch.argmax(probs / gumbel_norm, dim=-1)


def sample_token(log_probs: torch.Tensor, noise: torch.Tensor, *,
                 low_confidence_sampling: bool = False,
                 low_confidence_threshold: float = 0.3) -> torch.Tensor:
    """Token sampling with pre-drawn Gumbel noise: argmax(log_p + g)."""
    if low_confidence_sampling:
        probs = torch.softmax(log_probs, dim=-1)
        keep = low_confidence_mask(probs, low_confidence_threshold)
        log_probs = torch.where(keep, log_probs,
                                torch.full_like(log_probs, -torch.inf))
    return torch.argmax(log_probs + noise, dim=-1)
