"""Classifier runtime: noisy-input classifier training for guided decoding
(CBG / NOS) and clean-prefix per-position training (AR FUDGE) (port of
`ddg_tpu/classifier.py:32-181`).

  * `ClassifierSpec` is static; `classifier_loss_fn` is the loss;
  * the forward corruption is the diffusion model's own `q_xt`
    (`ops.forward_process`), drawn with t by `sample_corruption`;
  * time-dependent label smoothing interpolates one-hot -> uniform with t;
  * FUDGE mode: per-position logits on clean inputs, CE at every valid
    position against the sequence label;
  * `get_log_probs` = log_softmax(forward), read by CBG, FUDGE and NOS.

Random draws come from one explicit `torch.Generator`, in this order: t,
then x_t (`sample_corruption`), then the classifier's dropout. JAX's key
splits give other numbers, so the draw of (t, x_t) is kept in
`sample_corruption`: a comparison with the JAX package hands JAX's draw to
the loss in its place.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch

from ddg_tpu_torch.ops import forward_process as fp
from ddg_tpu_torch.runtime import averaging
from ddg_tpu_torch.runtime.averaging import AveragingSpec
from ddg_tpu_torch.runtime.optim import OptimSpec, make_schedule
from ddg_tpu_torch.runtime.train_state import TrainState


@dataclasses.dataclass(frozen=True)
class ClassifierSpec:
    diffusion: str                 # 'absorbing_state' | 'uniform'
    parameterization: str          # diffusion param of the paired model
    noise: object                  # an `ops.noise_schedules` schedule
    vocab_size: int
    mask_index: int
    num_classes: int
    T: int = 0
    time_conditioning: bool = False
    sampling_eps: float = 1e-3
    antithetic_sampling: bool = True
    importance_sampling: bool = False
    change_of_variables: bool = False
    use_label_smoothing: bool = False   # time-dependent smoothing
    is_fudge_classifier: bool = False
    # Eval classifiers train on clean sequences with no time conditioning.
    is_eval_classifier: bool = False


def process_sigma(spec: ClassifierSpec, sigma):
    """Squeeze a (B, 1) sigma; zero it unless time-conditioned."""
    if sigma is None:
        return None
    if sigma.ndim > 1:
        sigma = sigma.squeeze(-1)
    if not spec.time_conditioning:
        sigma = torch.zeros_like(sigma)
    return sigma


def get_log_probs(spec: ClassifierSpec, classifier_apply, params, x, sigma,
                  x_emb=None):
    """log p(class | x, sigma), float32."""
    sigma = process_sigma(spec, sigma)
    logits = classifier_apply(params, x, sigma, x_emb=x_emb)
    return torch.log_softmax(logits.float(), dim=-1)


def _time_terms(spec: ClassifierSpec, t):
    """(time conditioning (B, 1), move chance (B, 1)) at times t (B,)."""
    if spec.change_of_variables:
        f_t = math.log1p(-math.exp(-spec.noise.sigma_max))
        f_0 = math.log1p(-math.exp(-spec.noise.sigma_min))
        return t[:, None], torch.exp(f_0 + t * (f_t - f_0))[:, None]
    sigma, _ = spec.noise(t)
    return sigma[:, None], 1 - torch.exp(-sigma[:, None])


def sample_corruption(spec: ClassifierSpec, x0, generator):
    """The draw of the noisy-input loss: (t (B,), x_t (B, L)), t on the
    discrete grid when T > 0."""
    t = fp.sample_t(x0.shape[0], sampling_eps=spec.sampling_eps,
                    generator=generator,
                    antithetic=spec.antithetic_sampling, noise=spec.noise,
                    importance_sampling=spec.importance_sampling)
    if spec.T > 0:
        t = fp.discretize_t(t, spec.T)
    xt = fp.q_xt(x0, _time_terms(spec, t)[1], diffusion=spec.diffusion,
                 mask_index=spec.mask_index, vocab_size=spec.vocab_size,
                 generator=generator)
    return t, xt


def _ce(logits, labels):
    """Softmax cross entropy of float32 logits against soft labels."""
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(-1)


def _ce_int(logits, y):
    """Softmax cross entropy against integer labels."""
    return -torch.log_softmax(logits, dim=-1).gather(
        -1, y.long()[..., None])[..., 0]


def classifier_loss_fn(spec: ClassifierSpec, classifier_apply, params,
                       batch, generator, *, train: bool = True):
    """Noisy-input CE loss. batch: 'input_ids', 'attention_mask', 'label'.
    Returns (loss, float32 logits)."""
    x0 = batch['input_ids']
    attention_mask = batch['attention_mask']
    y = batch['label']
    t = None
    if spec.parameterization == 'ar' or spec.is_eval_classifier:
        # FUDGE/PPLM classifiers train on clean prefixes, eval classifiers
        # on clean full sequences.
        logits = classifier_apply(params, x0, None,
                                  attention_mask=attention_mask,
                                  train=train, rng=generator)
    else:
        t, xt = sample_corruption(spec, x0, generator)
        logits = classifier_apply(
            params, xt, process_sigma(spec, _time_terms(spec, t)[0]),
            attention_mask=attention_mask, train=train, rng=generator)

    logits = logits.float()
    if spec.is_fudge_classifier:
        # Per-position CE against the sequence label, masked positions
        # excluded.
        per_pos = _ce_int(logits, y[:, None].expand(logits.shape[:2]))
        loss = (per_pos * attention_mask).sum() / attention_mask.sum()
        return loss, logits
    if spec.use_label_smoothing and t is not None:
        one_hot = (y.long()[:, None] == torch.arange(
            spec.num_classes, device=y.device)).float()
        labels = (one_hot * (1 - t)[:, None]
                  + (1.0 / spec.num_classes) * t[:, None])
        return _ce(logits, labels).mean(), logits
    return _ce_int(logits, y).mean(), logits


def accuracy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Micro accuracy, a float32 tensor on the logits' device."""
    return (logits.argmax(-1) == y).float().mean()


def _frozen_prefix(key: str) -> str:
    """A JAX top-level param key (`block_3`, `vocab_embed`, ...) as the
    prefix of the port's state-dict names (`blocks.3.`, `vocab_embed.`)."""
    m = re.fullmatch(r'block_(\d+)', key)
    return f'blocks.{m.group(1)}.' if m else f'{key}.'


def make_classifier_train_step(spec: ClassifierSpec, classifier_apply,
                               optim_spec: OptimSpec,
                               averaging_spec: AveragingSpec,
                               frozen_keys=()):
    """Classifier training step on the shared runtime (optimizer and EMA
    as the diffusion train step): (state, batch) -> (state, metrics), the
    state from `runtime.train_state.init_train_state(generator,
    classifier_apply.params, ...)`, updated in place. (t, x_t) and the
    dropout masks are drawn from `state.generator`. Metrics are tensors on
    the card: 'loss', 'lr' and, but for FUDGE, 'accuracy'.

    frozen_keys: JAX's top-level param-tree keys whose gradients are zeroed
    (the frozen pretrained-encoder mode of PPLM/NOS classifiers). Each maps
    onto the prefix of the port's state-dict names: `block_N` -> `blocks.N.`,
    any other key k -> `k.` (`vocab_embed`, `sigma_map`, `output_layer`).
    The optimizer still updates every parameter, as optax does, with zero
    gradients for the frozen ones."""
    live = classifier_apply.params
    names = list(live)
    prefixes = tuple(_frozen_prefix(k) for k in frozen_keys)
    for p in prefixes:
        if not any(n.startswith(p) for n in names):
            raise ValueError(f'frozen key {p[:-1]!r} names no parameter')
    trained = [n for n in names if not n.startswith(prefixes)]
    weights = [live[k] for k in trained]
    schedule = make_schedule(optim_spec)

    def train_step(state: TrainState, batch):
        loss, logits = classifier_loss_fn(spec, classifier_apply, live,
                                          batch, state.generator, train=True)
        g = dict(zip(trained, torch.autograd.grad(loss, weights,
                                                  allow_unused=True)))
        grads = [g[k].float() if g.get(k) is not None
                 else torch.zeros_like(state.params[k]) for k in names]
        state.opt_state.step(grads)
        with torch.no_grad():
            torch._foreach_copy_([live[k] for k in names],
                                 [state.params[k] for k in names])
        averaging.update(averaging_spec, state.averaging, state.params)
        metrics = {'loss': loss.detach(),
                   'lr': torch.full((), schedule(state.step),
                                    device=loss.device)}
        if not spec.is_fudge_classifier:
            metrics['accuracy'] = accuracy(logits.detach(), batch['label'])
        state.step += 1
        return state, metrics

    return train_step
