"""ELBO / NLL losses for discrete diffusion (port of
`ddg_tpu/ops/losses.py`).

Label-smoothed NLL, the discrete-T D3PM losses for absorbing and uniform
diffusion, the continuous-time SUBS (MDLM) NELBO and the continuous-time
uniform (UDLM) ELBO. Every function returns per-token losses of shape
(B, L); masking and reduction happen in `diffusion.loss_fn`.

`log_p_smoothed` takes the place of the JAX package's
`(log_probs * smooth_one_hot(x0)).sum(-1)`: the same sum written as a
gather plus, under label smoothing, the row sum, so that no (B, L, V)
one-hot is materialised at the vocabulary of a language model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ddg_tpu_torch.ops.forward_process import uniform_posterior


def smooth_one_hot(x: torch.Tensor, vocab_size: int, label_smoothing: float,
                   dtype=torch.float32) -> torch.Tensor:
    """One-hot of x with epsilon mass spread over the other V-1 classes."""
    one_hot = F.one_hot(x.long(), vocab_size).to(dtype)
    return (one_hot * (1.0 - label_smoothing)
            + label_smoothing / (vocab_size - 1))


def log_p_smoothed(log_probs: torch.Tensor, x0: torch.Tensor,
                   label_smoothing: float = 0.0) -> torch.Tensor:
    """sum_v log_probs[..., v] * smooth_one_hot(x0)[..., v], shape (B, L)."""
    at_x0 = torch.gather(log_probs, -1, x0.long()[..., None]).squeeze(-1)
    if label_smoothing == 0.0:
        return at_x0
    vocab_size = log_probs.shape[-1]
    return ((1.0 - label_smoothing) * at_x0
            + (label_smoothing / (vocab_size - 1)) * log_probs.sum(-1))


def nll_loss(log_probs: torch.Tensor, x0: torch.Tensor,
             label_smoothing: float = 0.0) -> torch.Tensor:
    """Label-smoothed NLL, shape (B, L)."""
    vocab_size = log_probs.shape[-1]
    log_p_true = torch.gather(log_probs, -1,
                              x0.long()[..., None]).squeeze(-1)
    nll = -log_p_true
    if label_smoothing == 0.0:
        return nll
    smooth = -log_probs.sum(-1) + log_p_true
    return ((1.0 - label_smoothing) * nll
            + (label_smoothing / (vocab_size - 1)) * smooth)


def d3pm_absorbing_loss(log_x_theta: torch.Tensor, xt: torch.Tensor,
                        x0: torch.Tensor, t: torch.Tensor, *, T: int,
                        mask_index: int,
                        label_smoothing: float = 0.0) -> torch.Tensor:
    """Discrete-T ELBO for absorbing-state diffusion, T * L_vb per token
    (log-linear noise only: alpha_t = 1 - t)."""
    dt = 1.0 / T
    t = t[:, None].clamp(0.0, 1.0 - 1e-4)           # (B, 1)
    alpha_t = 1 - t
    alpha_s = 1 - (t - dt)
    log_x_theta_at_x0 = log_p_smoothed(log_x_theta, x0, label_smoothing)
    x_theta_at_m = torch.exp(log_x_theta[..., mask_index])
    term_1_coef = dt / t
    term_1_log_nr = torch.log(alpha_t * x_theta_at_m / t + 1)
    term_2_coef = 1 - dt / t
    term_2_log_dr = torch.log(alpha_s * x_theta_at_m / (t - dt) + 1)
    l_vb_masked = (term_1_coef * (term_1_log_nr - log_x_theta_at_x0)
                   + term_2_coef * (term_1_log_nr - term_2_log_dr))
    # A select, as XLA makes of the JAX package's multiply by the mask:
    # unmasked tokens give 0 even where the masked form is not finite.
    return T * torch.where(xt == mask_index, l_vb_masked,
                           torch.zeros_like(l_vb_masked))


def d3pm_uniform_loss(log_x_theta: torch.Tensor, xt: torch.Tensor,
                      x0: torch.Tensor, t: torch.Tensor, *, T: int,
                      vocab_size: int,
                      label_smoothing: float = 0.0) -> torch.Tensor:
    """Discrete-T ELBO for uniform diffusion: T * KL(posterior ||
    predicted posterior) per token."""
    dt = 1.0 / T
    t = t[:, None].clamp(0.0, 1.0 - 1e-4)           # (B, 1)
    alpha_t = (1 - t)[..., None]                     # (B, 1, 1)
    alpha_s = (1 - (t - dt))[..., None]
    x_smooth = smooth_one_hot(x0, vocab_size, label_smoothing,
                              dtype=log_x_theta.dtype)
    posterior = uniform_posterior(x_smooth, xt, alpha_s, alpha_t,
                                  vocab_size=vocab_size)
    posterior_pred = uniform_posterior(torch.exp(log_x_theta), xt, alpha_s,
                                       alpha_t, vocab_size=vocab_size)
    kl = (posterior * (torch.log(posterior + 1e-12)
                       - torch.log(posterior_pred))).sum(-1)
    return T * kl


def subs_continuous_weight(sigma: torch.Tensor,
                           dsigma: torch.Tensor) -> torch.Tensor:
    """Continuous-time MDLM NELBO weight dsigma / expm1(sigma), (B,) ->
    (B, 1)."""
    return (dsigma / torch.expm1(sigma))[:, None]


def subs_continuous_loss(log_x_theta: torch.Tensor, x0: torch.Tensor,
                         sigma: torch.Tensor, dsigma: torch.Tensor, *,
                         label_smoothing: float = 0.0) -> torch.Tensor:
    """Continuous-time absorbing-state SUBS NELBO per token."""
    log_p_theta = log_p_smoothed(log_x_theta, x0, label_smoothing)
    return -log_p_theta * subs_continuous_weight(sigma, dsigma)


def uniform_continuous_loss(log_x_theta: torch.Tensor, xt: torch.Tensor,
                            x0: torch.Tensor, t: torch.Tensor, *,
                            vocab_size: int,
                            label_smoothing: float = 0.0) -> torch.Tensor:
    """Continuous-time uniform-state (UDLM) ELBO per token, for the
    log-linear schedule (alpha_t = 1 - t, alpha_t' = -1), with
    x_bar = V alpha_t x + (1 - alpha_t)."""
    alpha_t_prime = -1.0
    alpha_t = 1.0 - t[..., None, None]               # (B, 1, 1)
    x_smooth = smooth_one_hot(x0, vocab_size, label_smoothing,
                              dtype=log_x_theta.dtype)
    x_bar = vocab_size * alpha_t * x_smooth + 1 - alpha_t
    x_bar_theta = vocab_size * alpha_t * torch.exp(log_x_theta) + 1 - alpha_t
    coeff = alpha_t_prime / (vocab_size * alpha_t)   # (B, 1, 1)
    idx = xt.long()[..., None]
    x_bar_zt = torch.gather(x_bar, -1, idx)
    x_bar_theta_zt = torch.gather(x_bar_theta, -1, idx)
    term1 = vocab_size / x_bar_zt - vocab_size / x_bar_theta_zt
    term2 = ((x_bar / x_bar_zt)
             * (torch.log(x_bar_theta_zt) - torch.log(x_bar_theta)
                + torch.log(x_bar) - torch.log(x_bar_zt))
             ).sum(-1, keepdim=True)
    return (coeff * (term1 - term2)).squeeze(-1)


def masked_mean_nll(nlls_per_token: torch.Tensor,
                    attention_mask: torch.Tensor) -> torch.Tensor:
    """Token-mean NLL over the attention mask."""
    return (nlls_per_token * attention_mask).sum() / attention_mask.sum()
