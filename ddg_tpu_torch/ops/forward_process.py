"""Forward corruption process and reverse posteriors (port of
`ddg_tpu/ops/forward_process.py`).

Conventions:
  x0, xt      integer token ids, shape (B, L)
  x / x_theta probability simplexes over vocab, shape (B, L, V)
  move_chance 1 - alpha(t), broadcastable to (B, 1) or (B, 1, 1)
  NEG_INFINITY is the reference's -1e6 sentinel (not -inf), so that
  log_softmax over "forced" rows reproduces its numerics. (The fused
  sampling kernels use their own -1e30 sentinel.)

Random draws take an explicit `torch.Generator`; its device is where the
draw happens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INFINITY = -1_000_000.0


def _one_hot(idx: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """One-hot row of index idx in like's dtype, made on like's device
    without a copy from the host (which would wait for the card)."""
    return (torch.arange(n, device=like.device) == idx).to(like.dtype)


def sample_t(n: int, *, sampling_eps: float, generator: torch.Generator,
             antithetic: bool = True, noise=None,
             importance_sampling: bool = False,
             dtype=torch.float32) -> torch.Tensor:
    """Per-example diffusion times t in (eps, 1). Antithetic: one uniform
    shared across the batch, offset by i/n."""
    eps_t = torch.rand((n,), generator=generator, device=generator.device,
                       dtype=dtype)
    if antithetic:
        offset = torch.arange(n, dtype=dtype, device=eps_t.device) / n
        eps_t = (eps_t / n + offset) % 1
    t = (1 - sampling_eps) * eps_t + sampling_eps
    if importance_sampling:
        t = noise.importance_sampling_transformation(t)
    return t


def discretize_t(t: torch.Tensor, T: int) -> torch.Tensor:
    """Map continuous t to the discrete grid {1/T, ..., 1}."""
    t = (t * T).to(torch.int32).to(t.dtype) / T
    return t + 1.0 / T


def q_xt(x0: torch.Tensor, move_chance: torch.Tensor, *, diffusion: str,
         mask_index: int, vocab_size: int,
         generator: torch.Generator) -> torch.Tensor:
    """Sample x_t ~ q(x_t | x_0); move_chance has shape (B, 1)."""
    dev = generator.device
    move = torch.rand(x0.shape, generator=generator, device=dev,
                      dtype=move_chance.dtype) < move_chance
    if diffusion == 'absorbing_state':
        return torch.where(move, torch.full_like(x0, mask_index), x0)
    if diffusion == 'uniform':
        uniform_tokens = torch.randint(0, vocab_size, x0.shape,
                                       generator=generator, device=dev,
                                       dtype=x0.dtype)
        return torch.where(move, uniform_tokens, x0)
    raise NotImplementedError(
        f'Diffusion type {diffusion} not implemented.')


def sample_prior(shape, *, diffusion: str, mask_index: int,
                 vocab_size: int, device,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """x_T from the limiting distribution (int32)."""
    if diffusion == 'absorbing_state':
        return torch.full(shape, mask_index, dtype=torch.int32,
                          device=device)
    if diffusion == 'uniform':
        return torch.randint(0, vocab_size, shape, generator=generator,
                             device=device, dtype=torch.int32)
    raise NotImplementedError(
        f'Diffusion type {diffusion} not implemented.')


def subs_parameterization(logits: torch.Tensor, xt: torch.Tensor, *,
                          mask_index: int) -> torch.Tensor:
    """MDLM SUBS: -1e6 on the mask logit; rows of unmasked tokens forced
    to a (near-)one-hot at x_t; then log_softmax."""
    vocab_size = logits.shape[-1]
    logits = logits + _one_hot(mask_index, vocab_size,
                               logits) * NEG_INFINITY
    unmasked = (xt != mask_index)[..., None]
    forced = torch.where(F.one_hot(xt.long(), vocab_size).bool(),
                         0.0, NEG_INFINITY).to(logits.dtype)
    logits = torch.where(unmasked, forced, logits)
    return torch.log_softmax(logits, dim=-1)


def uniform_posterior(x: torch.Tensor, xt: torch.Tensor, alpha_s, alpha_t,
                      *, vocab_size: int) -> torch.Tensor:
    """Uniform-diffusion posterior q(x_s | x_t, x); alpha_{s,t}
    broadcast as (B, 1, 1) or (B, L, 1)."""
    alpha_ts = alpha_t / alpha_s
    d_alpha = alpha_s - alpha_t
    xt_one_hot = F.one_hot(xt.long(), vocab_size).to(x.dtype)
    x_at_xt = torch.gather(x, -1, xt.long()[..., None])
    numerator = (alpha_t * vocab_size * x * xt_one_hot
                 + (alpha_ts - alpha_t) * xt_one_hot
                 + d_alpha * x
                 + (1 - alpha_ts) * (1 - alpha_s) / vocab_size)
    denominator = alpha_t * vocab_size * x_at_xt + (1 - alpha_t)
    return numerator / denominator


def absorbing_posterior(x_theta: torch.Tensor, move_chance_t,
                        move_chance_s, *, mask_index: int) -> torch.Tensor:
    """q_xs = x_theta * (mct - mcs); q_xs[..., mask] = mcs; then / mct."""
    vocab_size = x_theta.shape[-1]
    q_xs = x_theta * (move_chance_t - move_chance_s)
    mask_one_hot = _one_hot(mask_index, vocab_size, q_xs)
    q_xs = q_xs * (1 - mask_one_hot) + mask_one_hot * move_chance_s
    return q_xs / move_chance_t


def absorbing_posterior_log(log_x_theta: torch.Tensor, move_chance_t,
                            move_chance_s, *,
                            mask_index: int) -> torch.Tensor:
    """log q_xs = log_x_theta + log(1 - mcs/mct); log(mcs/mct) at the
    mask index."""
    vocab_size = log_x_theta.shape[-1]
    ratio = move_chance_s / move_chance_t
    out = log_x_theta + torch.log(1.0 - ratio)
    mask_one_hot = _one_hot(mask_index, vocab_size, log_x_theta).bool()
    return torch.where(mask_one_hot, torch.log(ratio), out)


def apply_copy_flag_probs(q_xs: torch.Tensor, xt: torch.Tensor, *,
                          mask_index: int) -> torch.Tensor:
    """Force rows of already-decoded tokens to the one-hot of x_t."""
    copy = (xt != mask_index)[..., None]
    one_hot = F.one_hot(xt.long(), q_xs.shape[-1]).to(q_xs.dtype)
    return torch.where(copy, one_hot, q_xs)


def apply_copy_flag_log(log_q_xs: torch.Tensor, xt: torch.Tensor, *,
                        mask_index: int) -> torch.Tensor:
    """Log-space analogue: -1e6 everywhere, 0 at x_t for decoded rows."""
    copy = (xt != mask_index)[..., None]
    forced = torch.where(F.one_hot(xt.long(), log_q_xs.shape[-1]).bool(),
                         0.0, NEG_INFINITY).to(log_q_xs.dtype)
    return torch.where(copy, forced, log_q_xs)


def apply_copy_flag_tokens(xs: torch.Tensor, xt: torch.Tensor, *,
                           mask_index: int) -> torch.Tensor:
    """Carry over already-decoded tokens: where(xt != mask, xt, xs)."""
    return torch.where(xt != mask_index, xt.to(xs.dtype), xs)
