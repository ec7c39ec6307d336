"""Diffusion core (port of `ddg_tpu/diffusion.py`): the static
`DiffusionSpec`, sigma processing, the backbone forward with the
parameterization transform, and the training losses (`loss_fn`: the
continuous-time SUBS/MDLM and UDLM ELBOs, the discrete-T D3PM losses,
AR cross-entropy, the K-step unrolled CE, CFG cond dropout and the
mask-weighted reduction).

Randomness comes from one explicit `torch.Generator`, drawn in a fixed
order: cond dropout, then (t, x_t) in `sample_corruption`, then the
model's dropout and the unrolled resampling. JAX's key splits give other
numbers, so the draw of (t, x_t) is kept apart from the loss given it
(`diffusion_loss_given`): a comparison with the JAX package hands JAX's
draw to the latter.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ddg_tpu_torch.ops import forward_process as fp
from ddg_tpu_torch.ops import losses as L
from ddg_tpu_torch.ops import sampling as S
from ddg_tpu_torch.ops.noise_schedules import NoiseSchedule

# model_apply(params, x, sigma, cond, x_emb, *, train, rng) -> logits
ModelApply = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionSpec:
    """Static model/process hyperparameters, the fields and defaults of
    `ddg_tpu`'s spec."""
    diffusion: str                  # 'absorbing_state' | 'uniform'
    parameterization: str           # 'subs' | 'd3pm' | 'ar'
    noise: NoiseSchedule
    vocab_size: int                 # includes mask token if added
    mask_index: int
    T: int = 0
    time_conditioning: bool = False
    subs_masking: bool = False
    sampling_eps: float = 1e-3
    antithetic_sampling: bool = True
    importance_sampling: bool = False
    change_of_variables: bool = False
    label_smoothing: float = 0.0
    zero_recon_loss: bool = False
    use_simple_ce_loss: bool = False
    compute_loss_on_pad_tokens: bool = False
    cond_dropout: float = 0.0
    num_classes: Optional[int] = None
    unrolling: bool = False
    unrolling_steps: int = 2
    unrolling_weight: float = 1.0
    unrolling_ignore_diffusion_loss: bool = False
    noise_schedule_warmup: bool = False
    noise_schedule_warmup_fraction: float = 0.1
    noise_schedule_uniform_warmup: bool = False
    max_steps: int = 1_000_000

    def __post_init__(self):
        if self.change_of_variables and self.importance_sampling:
            raise ValueError('change_of_variables and importance_sampling '
                             'exclude each other')
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
            logits = logits + fp._one_hot(spec.mask_index, spec.vocab_size,
                                          logits) * fp.NEG_INFINITY
        return torch.log_softmax(logits, dim=-1)
    return logits


@dataclasses.dataclass
class Loss:
    """`loss` is the scalar to differentiate; the component losses are
    detached token means."""
    loss: torch.Tensor
    nlls: torch.Tensor
    token_mask: torch.Tensor
    recon_loss: Optional[torch.Tensor] = None
    diffusion_loss: Optional[torch.Tensor] = None
    unroll_loss: Optional[torch.Tensor] = None


def _reconstruction_loss(spec: DiffusionSpec, model_apply, params, x0, cond,
                         label_smoothing, *, train, rng):
    """Model NLL at t = 0 (log-linear only, as the reference)."""
    t0 = torch.zeros((x0.shape[0],), dtype=torch.float32, device=x0.device)
    out_t0 = log_x_theta(spec, model_apply, params, x0,
                         spec.noise.total_noise(t0), cond=cond, train=train,
                         rng=rng)
    return L.nll_loss(out_t0, x0, label_smoothing)


def _move_chance_warmup(spec: DiffusionSpec, move_chance, step: int):
    """Noise-schedule warmup: cap move_chance while step < the warmup
    steps (uniformly scaled, or clipped)."""
    warmup_steps = int(spec.max_steps * spec.noise_schedule_warmup_fraction)
    if step >= warmup_steps:
        return move_chance
    cap = min(max(step / max(warmup_steps, 1), 0.0), 1.0)
    if spec.noise_schedule_uniform_warmup:
        return move_chance * cap
    return move_chance.clamp_max(cap)


def _time_terms(spec: DiffusionSpec, t):
    """(sigma, dsigma, time conditioning (B, 1), move_chance (B, 1)) at
    t; sigma and dsigma are None under the change of variables."""
    if spec.change_of_variables:
        f_t = math.log1p(-math.exp(-spec.noise.sigma_max))
        f_0 = math.log1p(-math.exp(-spec.noise.sigma_min))
        return None, None, t[:, None], torch.exp(f_0 + t * (f_t - f_0))[:, None]
    sigma, dsigma = spec.noise(t)
    return sigma, dsigma, sigma[:, None], 1 - torch.exp(-sigma[:, None])


def _sample_t(spec: DiffusionSpec, n: int, generator):
    return fp.sample_t(n, sampling_eps=spec.sampling_eps,
                       generator=generator,
                       antithetic=spec.antithetic_sampling, noise=spec.noise,
                       importance_sampling=spec.importance_sampling)


def sample_corruption(spec: DiffusionSpec, x0, generator, *, step=None):
    """The draw of the diffusion loss: (t (B,), x_t (B, L)), with t on
    the discrete grid when T > 0 and the move chance capped by the
    noise-schedule warmup when it is on and `step` is given."""
    t = _sample_t(spec, x0.shape[0], generator)
    if spec.T > 0:
        t = fp.discretize_t(t, spec.T)
    move_chance = _time_terms(spec, t)[3]
    if spec.noise_schedule_warmup and step is not None:
        move_chance = _move_chance_warmup(spec, move_chance, step)
    xt = fp.q_xt(x0, move_chance, diffusion=spec.diffusion,
                 mask_index=spec.mask_index, vocab_size=spec.vocab_size,
                 generator=generator)
    return t, xt


def _k_step_ce(spec: DiffusionSpec, model_apply, params, xt, x0, time_cond,
               K: int, cond, label_smoothing, *, train, rng):
    """K-step unrolled CE: forward -> CE -> resample from the model, with
    no gradient through the resampling."""
    acc = torch.zeros(x0.shape, dtype=torch.float32, device=x0.device)
    x_prev = xt
    for _ in range(K):
        out = log_x_theta(spec, model_apply, params, x_prev, time_cond,
                          cond=cond, train=train, rng=rng)
        acc = acc + L.nll_loss(out, x0, label_smoothing)
        x_prev = S.sample_categorical(torch.exp(out.detach()),
                                      generator=rng).to(xt.dtype)
    return acc / K


def diffusion_loss_given(spec: DiffusionSpec, model_apply: ModelApply,
                         params, x0, t, xt, cond, generator, *, train: bool,
                         label_smoothing: float,
                         metrics: bool = True) -> dict:
    """The diffusion training loss for a drawn (t, x_t): a dict with
    'loss' (B, L) and the optional 'recon_loss'/'diffusion_loss'. With
    `metrics=False` a term that only feeds a metric (the t = 0
    reconstruction under `zero_recon_loss`) is not computed and comes back
    None, as XLA drops it from the JAX step that discards it."""
    sigma, dsigma, time_cond, _ = _time_terms(spec, t)
    ls = label_smoothing
    if train and spec.unrolling and spec.unrolling_ignore_diffusion_loss:
        # The K-step unrolled CE replaces the ELBO.
        return {'loss': _k_step_ce(spec, model_apply, params, xt, x0,
                                   time_cond, spec.unrolling_steps, cond, ls,
                                   train=train, rng=generator)}
    model_output = log_x_theta(spec, model_apply, params, xt, time_cond,
                               cond=cond, train=train, rng=generator)
    simple_ce = train and spec.use_simple_ce_loss

    if spec.T > 0:
        if spec.diffusion == 'absorbing_state':
            diffusion_loss = L.d3pm_absorbing_loss(
                model_output, xt, x0, t, T=spec.T,
                mask_index=spec.mask_index, label_smoothing=ls)
        else:
            diffusion_loss = L.d3pm_uniform_loss(
                model_output, xt, x0, t, T=spec.T,
                vocab_size=spec.vocab_size, label_smoothing=ls)
        if spec.parameterization == 'd3pm':
            recon = _reconstruction_loss(spec, model_apply, params, x0,
                                         cond, ls, train=train,
                                         rng=generator)
            loss = (L.nll_loss(model_output, x0, ls) if simple_ce
                    else recon + diffusion_loss)
            return {'recon_loss': recon, 'diffusion_loss': diffusion_loss,
                    'loss': loss}
        loss = (L.nll_loss(model_output, x0, ls) if simple_ce
                else diffusion_loss)
        return {'diffusion_loss': diffusion_loss, 'loss': loss}

    if spec.diffusion == 'absorbing_state':
        if spec.change_of_variables or spec.importance_sampling:
            log_p_theta = L.log_p_smoothed(model_output, x0, ls)
            if simple_ce:
                return {'loss': -log_p_theta}
            w = math.log1p(-math.exp(-spec.noise.sigma_min))
            return {'loss': log_p_theta * w}
        if simple_ce:
            return {'loss': L.nll_loss(model_output, x0, ls)}
        return {'loss': L.subs_continuous_loss(model_output, x0, sigma,
                                               dsigma, label_smoothing=ls)}

    if spec.diffusion == 'uniform':
        diffusion_loss = L.uniform_continuous_loss(
            model_output, xt, x0, t, vocab_size=spec.vocab_size,
            label_smoothing=ls)
        # With zero_recon_loss (and no simple CE) the t = 0 term is only a
        # metric: its forward records no graph, so it holds no activations
        # while the loss is backpropagated.
        metric_only = spec.zero_recon_loss and not simple_ce
        recon = None
        if metrics or not metric_only:
            with torch.no_grad() if metric_only else contextlib.nullcontext():
                recon = _reconstruction_loss(spec, model_apply, params, x0,
                                             cond, ls, train=train,
                                             rng=generator)
        if simple_ce:
            loss = L.nll_loss(model_output, x0, ls)
        elif spec.zero_recon_loss:
            loss = diffusion_loss
        else:
            loss = diffusion_loss + recon
        return {'recon_loss': recon, 'diffusion_loss': diffusion_loss,
                'loss': loss}
    raise NotImplementedError(f'Diffusion type {spec.diffusion} not '
                              'implemented for continuous time.')


def forward_pass_diffusion(spec: DiffusionSpec, model_apply: ModelApply,
                           params, x0, cond, generator, *, train: bool,
                           label_smoothing: float, step=None,
                           metrics: bool = True) -> dict:
    """Draw (t, x_t) and return `diffusion_loss_given` on them."""
    t, xt = sample_corruption(spec, x0, generator, step=step)
    return diffusion_loss_given(spec, model_apply, params, x0, t, xt, cond,
                                generator, train=train,
                                label_smoothing=label_smoothing,
                                metrics=metrics)


def loss_fn(spec: DiffusionSpec, model_apply: ModelApply, params, x0,
            attention_mask, cond, generator, *, train: bool,
            label_smoothing: Optional[float] = None, step=None,
            metrics: bool = True) -> Loss:
    """The full loss: CFG cond dropout, the AR CE or the diffusion loss
    (with the unrolled CE as an auxiliary term), and the mask-weighted
    token mean. For AR, x0 is the (inputs, targets) pair. `metrics=False`
    skips terms that feed only a metric (`diffusion_loss_given`)."""
    if label_smoothing is None:
        label_smoothing = spec.label_smoothing if train else 0.0
    recon_loss = diffusion_loss = unroll_loss = None

    if cond is not None and train and spec.cond_dropout > 0:
        drop = torch.rand(cond.shape, generator=generator,
                          device=generator.device) < spec.cond_dropout
        cond = torch.where(drop, torch.full_like(cond, spec.num_classes),
                           cond)

    if spec.parameterization == 'ar':
        inputs, targets = x0
        logprobs = log_x_theta(spec, model_apply, params, inputs, None,
                               cond=cond, train=train, rng=generator)
        loss = -L.log_p_smoothed(logprobs, targets, label_smoothing)
    else:
        out = forward_pass_diffusion(spec, model_apply, params, x0, cond,
                                     generator, train=train,
                                     label_smoothing=label_smoothing,
                                     step=step, metrics=metrics)
        recon_loss = out.get('recon_loss')
        diffusion_loss = out.get('diffusion_loss')
        loss = out['loss']
        if (train and spec.unrolling
                and not spec.unrolling_ignore_diffusion_loss
                and spec.unrolling_steps > 0):
            # Auxiliary K-step unrolled CE on a fresh (t, x_t), without
            # the discrete grid or the warmup.
            t_u = _sample_t(spec, x0.shape[0], generator)
            sigma, _ = spec.noise(t_u)
            xt_u = fp.q_xt(x0, 1 - torch.exp(-sigma)[:, None],
                           diffusion=spec.diffusion,
                           mask_index=spec.mask_index,
                           vocab_size=spec.vocab_size, generator=generator)
            unroll_loss = spec.unrolling_weight * _k_step_ce(
                spec, model_apply, params, xt_u, x0, sigma[:, None],
                spec.unrolling_steps, cond, label_smoothing, train=train,
                rng=generator)
            loss = loss + unroll_loss

    nlls = loss * attention_mask
    count = attention_mask.sum()
    if spec.compute_loss_on_pad_tokens and train:
        token_nll = loss.mean()
    else:
        token_nll = nlls.sum() / count

    def _reduce(x):
        return None if x is None else ((x * attention_mask).sum()
                                       / count).detach()

    return Loss(loss=token_nll, nlls=nlls, token_mask=attention_mask,
                recon_loss=_reduce(recon_loss),
                diffusion_loss=_reduce(diffusion_loss),
                unroll_loss=_reduce(unroll_loss))
