"""Sampling loops for absorbing-state (MDLM) and uniform-state (UDLM)
diffusion with D-CFG, D-CBG (exact and first-order) and NOS (port of
`ddg_tpu/samplers.py:40-765`, the serving and guidance slices).

The JAX package runs each loop as one `lax.scan`; here it is a Python
loop over steps, and the tokens stay on the device throughout. Random
draws come from one explicit `torch.Generator`, whose device is where the
loop runs. The fused denoise-step kernels (`ops/fused_sampling.py`) serve
the `fused=True` paths when the tokens live on a CUDA device; elsewhere
the unfused chain runs, as the JAX package does off the TPU.

The NFE cache (`use_cache`) is carried as the last computed value, or
None before the first compute, so no `_init_cache` allocation is needed;
under CBG that value is the pair (log x_theta, classifier log-probs).
Checking whether a step changed nothing costs one host sync per step.

The fused steps cover absorbing-state SUBS (K7/K8) and uniform-state
D3PM (K9/K10, every token resampled from raw logits with alpha = 1 -
move chance per row). `fused_head` runs the DiT's vocab projection inside
the absorbing step (K11, or K12 under `quant_int8`) where the NFE cache is
off: in the unguided step and in the D-CFG feature-mix step, as
`ddg_tpu` does; the head's padded (or quantized) weights are prepared
once per sampling call.

Classifier-based guidance runs the unfused chain, as in JAX:
  * D-CBG exact scores every single-token edit of x_t with the classifier,
    in chunks of `cbg_chunk` edits (a Python loop where JAX has `lax.map`;
    the last chunk padded as in JAX), so each chunk is one classifier
    forward of B * cbg_chunk rows;
  * D-CBG first-order (`use_approx`) takes one gradient of the
    classifier's log-probability in the one-hot of x_t;
  * NOS runs Adagrad on a hidden-state delta through the classifier head
    and the denoiser's head, leashed by a KL to the unguided posterior.
The gradients of the last two are taken under a local
`torch.enable_grad()`, with the adapters' `grad=True` (models/__init__.py);
nothing runs in train mode.

AR sampling (`ar_sample`, port of `ddg_tpu/samplers.py:768-1083`) decodes
one position a step, a Python loop over positions with int positions:
  * with `decode_cfg` (a DITConfig or a DiMambaConfig) and no guidance or
    D-CFG, stateful decoding (`_ar_sample_kv`): the DiT's KV cache
    (`models/dit_decode.py`, bf16 or `ar_kv_int8`'s int8 rows) in
    `ar_buckets` length buckets, each reading a 128-ceil window of the
    cache, or the DiMamba's conv and SSM state
    (`models/dimamba_decode.py`); D-CFG decodes cond and null as one
    batch of 2B rows;
  * otherwise the full causal forward of the whole sequence each step,
    for none, D-CFG, FUDGE (the classifier scores each of the top-k
    continuations at the next position) and PPLM (Adagrad on a delta to
    the trunk's hidden state through the classifier and the denoiser's
    head, KL-leashed to the unguided next-token distribution).
The Gumbel noise is drawn once, (B, L-1, V) (FUDGE: (B, L-1, topk)), first
thing from the generator, so both paths draw the same noise.
Diffusion sampling refuses FUDGE and PPLM, which are AR methods.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from ddg_tpu_torch.diffusion import DiffusionSpec, log_x_theta, process_sigma
from ddg_tpu_torch.ops import forward_process as fp
from ddg_tpu_torch.ops import sampling as S
from ddg_tpu_torch.ops.fused_sampling import (
    fused_absorbing_cfg_sample, fused_absorbing_head_sample,
    fused_absorbing_head_sample_int8, fused_absorbing_sample,
    fused_uniform_cfg_sample, fused_uniform_sample, pad_head_weights,
    quantize_head_inputs, quantize_head_weights)
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise

_INT32_MAX = 2 ** 31 - 1


def _raw_logits(spec, model_apply, params, xt, sigma, cond=None):
    """Denoiser forward without the parameterization transform, in bf16:
    the fused kernels read raw logits and do the fp32 math themselves."""
    return model_apply(params, xt, process_sigma(spec, sigma), cond,
                       None, train=False, rng=None).to(torch.bfloat16)


def _fused_ok(spec, sampler, guidance, xt):
    """The fused kernels serve this step: `sampler.fused`, tokens on a
    CUDA device, and a process/parameterization they cover."""
    return (sampler.fused
            and xt.is_cuda
            and ((spec.diffusion == 'absorbing_state'
                  and spec.parameterization == 'subs')
                 or (spec.diffusion == 'uniform'
                     and spec.parameterization == 'd3pm'
                     and not spec.subs_masking))
            and not sampler.low_confidence_sampling
            and not sampler.argmax_sampling
            and not sampler.use_float64)


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Static sampling settings (configs/config.yaml `sampling` group)."""
    steps: int = 128
    eps: float = 1e-5
    use_cache: bool = True
    use_float64: bool = False
    low_confidence_sampling: bool = False
    low_confidence_threshold: float = 0.3
    argmax_sampling: bool = False
    fused: bool = False
    first_hitting: bool = False
    fused_head: bool = False
    # AR decode: split the positions into this many contiguous buckets,
    # bucket j reading a 128-ceil window of the cache (DiT only;
    # token-identical to 1).
    ar_buckets: int = 4
    # AR decode: int8 KV cache rows with per-(block, b, head, position)
    # scales (DiT only; not token-identical to the bf16 cache).
    ar_kv_int8: bool = False


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    """Static guidance settings (configs/guidance/*.yaml). `cfg`, `cbg`
    and `nos` guide the diffusion samplers; `cfg`, `fudge` and `pplm` the
    AR sampler."""
    method: str                      # cfg | cbg | nos | fudge | pplm
    gamma: float = 1.0
    condition: int = 0
    use_approx: bool = False         # cbg first-order approximation
    topk: int = 50                   # fudge
    num_nos_steps: int = 1
    nos_step_size: float = 0.1
    nos_stability_coef: float = 0.01
    cbg_chunk: int = 256             # edits per classifier chunk (exact cbg)
    num_pplm_steps: int = 1
    pplm_step_size: float = 0.1
    pplm_stability_coef: float = 0.01


def _sample_dtype(sampler: SamplerSpec):
    return torch.float64 if sampler.use_float64 else torch.float32


def _seed(generator):
    """One int32 kernel seed in [0, 2^31 - 1), drawn on the generator's
    device (no host sync)."""
    return torch.randint(0, _INT32_MAX, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def _posterior_probs(spec: DiffusionSpec, x_theta, xt, mct, mcs):
    """Unguided reverse posterior as probabilities."""
    if spec.diffusion == 'absorbing_state':
        return fp.absorbing_posterior(x_theta, mct, mcs,
                                      mask_index=spec.mask_index)
    if spec.diffusion == 'uniform':
        return fp.uniform_posterior(x_theta, xt, 1 - mcs, 1 - mct,
                                    vocab_size=spec.vocab_size)
    raise NotImplementedError(
        f'Diffusion type {spec.diffusion} not implemented.')


def _sample_and_copy(spec, sampler, generator, q_xs, xt):
    xs = S.sample_categorical(
        q_xs, generator=generator,
        low_confidence_sampling=sampler.low_confidence_sampling,
        low_confidence_threshold=sampler.low_confidence_threshold,
        argmax_sampling=sampler.argmax_sampling)
    if spec.diffusion == 'absorbing_state':
        xs = fp.apply_copy_flag_tokens(xs, xt, mask_index=spec.mask_index)
    return xs.to(torch.int32)


def _cached(compute, cache, cache_valid):
    """NFE cache: reuse `cache` while the last step changed nothing, else
    recompute. Returns (value, new_cache). cache_valid=None disables the
    cache: nothing is kept between steps."""
    if cache_valid is None:
        return compute(), cache
    if cache_valid:
        return cache, cache
    val = compute()
    return val, val


def _prepare_head(dit_cfg, params):
    """The head-fused step's weights, once per sampling call: the vocab
    head padded in `logits_dtype` (K11), or quantized and padded (K12)."""
    w = params['output_layer.linear.weight']
    b = params['output_layer.linear.bias']
    if dit_cfg.quant_int8:
        return quantize_head_weights(w, b)
    return pad_head_weights(w.to(dit_cfg.logits_dtype), b)


def _head_fused_sample(spec, dit_cfg, head, seed, xt, feats, mct, mcs):
    """Head-fused denoise step (`ddg_tpu/samplers.py:185-217`): K12 on the
    quantized features under `quant_int8`, else K11 on the features in
    `logits_dtype`. `head` is `_prepare_head`'s result."""
    kw = dict(vocab_size=spec.vocab_size, mask_index=spec.mask_index)
    if dit_cfg.quant_int8:
        feats_q, x_scale = quantize_head_inputs(feats)
        return fused_absorbing_head_sample_int8(
            seed, xt, feats_q, x_scale, *head, mct[:, 0, 0], mcs[:, 0, 0],
            **kw)
    return fused_absorbing_head_sample(
        seed, xt, feats.to(dit_cfg.logits_dtype).contiguous(), *head,
        mct[:, 0, 0], mcs[:, 0, 0], **kw)


# ---------------------------------------------------------------------------
# Denoise-step variants. Each returns (xs, cache).
# ---------------------------------------------------------------------------

def _ddpm_step(spec, sampler, model_apply, params, generator, xt, sigma_t,
               mct, mcs, cache, cache_valid, dit_cfg=None, head=None):
    if (head is not None and cache_valid is None
            and _fused_ok(spec, sampler, None, xt)):
        from ddg_tpu_torch.models.dit import dit_head_features
        hidden, cvec = model_apply(params, xt, process_sigma(spec, sigma_t),
                                   None, None, train=False, rng=None,
                                   skip_head=True)
        feats = dit_head_features(dit_cfg, params, hidden, cvec)
        xs = _head_fused_sample(spec, dit_cfg, head, _seed(generator), xt,
                                feats, mct, mcs)
        return xs, cache
    if _fused_ok(spec, sampler, None, xt):
        logits, new_cache = _cached(
            lambda: _raw_logits(spec, model_apply, params, xt, sigma_t),
            cache, cache_valid)
        if spec.diffusion == 'uniform':
            xs = fused_uniform_sample(
                _seed(generator), xt, logits, 1 - mct[:, 0, 0],
                1 - mcs[:, 0, 0], vocab_size=spec.vocab_size)
        else:
            xs = fused_absorbing_sample(
                _seed(generator), xt, logits, mct[:, 0, 0], mcs[:, 0, 0],
                mask_index=spec.mask_index)
        return xs, new_cache

    def compute():
        out = log_x_theta(spec, model_apply, params, xt, sigma_t)
        return out.to(_sample_dtype(sampler))

    log_xt, new_cache = _cached(compute, cache, cache_valid)
    q_xs = _posterior_probs(spec, log_xt.exp(), xt, mct, mcs)
    return _sample_and_copy(spec, sampler, generator, q_xs, xt), new_cache


def _cfg_step(spec, sampler, guidance, model_apply, params, generator, xt,
              sigma_t, mct, mcs, cond, cache, cache_valid, dit_cfg=None,
              head=None):
    """D-CFG. gamma in {0, 1} takes a single forward; otherwise one
    batched [cond; uncond] forward at 2B. `head` (the prepared head
    weights) sends the feature-mix path through K11/K12."""
    gamma = guidance.gamma
    null_cond = torch.full_like(cond, spec.num_classes)
    B = xt.shape[0]
    mixed = gamma not in (0.0, 1.0)
    fused = mixed and _fused_ok(spec, sampler, guidance, xt)

    def doubled():
        """[cond; uncond] rows for one batched forward at 2B."""
        return (torch.cat([xt, xt]), torch.cat([sigma_t, sigma_t]),
                torch.cat([cond, null_cond]))

    if (fused and spec.diffusion == 'absorbing_state'
            and dit_cfg is not None and cache_valid is None):
        # Feature-mix path: the head is linear in its features, so
        # gamma * logits_c + (1 - gamma) * logits_u equals the head
        # applied to gamma * feats_c + (1 - gamma) * feats_u: one vocab
        # matmul on B rows instead of 2B, and B rows of logits.
        from ddg_tpu_torch.models.dit import (dit_head_features,
                                              dit_head_matmul)
        x2, s2, c2 = doubled()
        hidden2, cvec2 = model_apply(params, x2, process_sigma(spec, s2), c2,
                                     None, train=False, rng=None,
                                     skip_head=True)
        feats2 = dit_head_features(dit_cfg, params, hidden2, cvec2)
        fmix = (gamma * feats2[:B].float()
                + (1 - gamma) * feats2[B:].float())
        if head is not None:
            xs = _head_fused_sample(spec, dit_cfg, head, _seed(generator),
                                    xt, fmix.to(feats2.dtype), mct, mcs)
            return xs, cache
        logits_mix = dit_head_matmul(
            dit_cfg, params, fmix.to(feats2.dtype)).to(torch.bfloat16)
        xs = fused_absorbing_sample(
            _seed(generator), xt, logits_mix, mct[:, 0, 0], mcs[:, 0, 0],
            mask_index=spec.mask_index)
        return xs, cache

    if fused:
        logits2, new_cache = _cached(
            lambda: _raw_logits(spec, model_apply, params, *doubled()),
            cache, cache_valid)
        if spec.diffusion == 'uniform':
            # Log-posterior interpolation inside the kernel.
            xs = fused_uniform_cfg_sample(
                _seed(generator), xt, logits2[:B], logits2[B:], gamma,
                1 - mct[:, 0, 0], 1 - mcs[:, 0, 0],
                vocab_size=spec.vocab_size)
        else:
            xs = fused_absorbing_cfg_sample(
                _seed(generator), xt, logits2[:B], logits2[B:], gamma,
                mct[:, 0, 0], mcs[:, 0, 0], mask_index=spec.mask_index)
        return xs, new_cache

    dt = _sample_dtype(sampler)
    if not mixed:
        use_cond = cond if gamma == 1.0 else null_cond
        log_xt, new_cache = _cached(
            lambda: log_x_theta(spec, model_apply, params, xt, sigma_t,
                                cond=use_cond).to(dt),
            cache, cache_valid)
        q_xs = _posterior_probs(spec, log_xt.exp(), xt, mct, mcs)
        return (_sample_and_copy(spec, sampler, generator, q_xs, xt),
                new_cache)

    def compute():
        x2, s2, c2 = doubled()
        return log_x_theta(spec, model_apply, params, x2, s2,
                           cond=c2).to(dt)

    log_both, new_cache = _cached(compute, cache, cache_valid)
    log_cond, log_uncond = log_both[:B], log_both[B:]
    if spec.diffusion == 'absorbing_state':
        # Interpolate in x_theta logit space, then the posterior.
        log_mix = gamma * log_cond + (1 - gamma) * log_uncond
        q_xs = _posterior_probs(spec, torch.softmax(log_mix, dim=-1), xt,
                                mct, mcs)
    else:
        # Uniform: interpolate log-posteriors, then normalise.
        log_q_c = torch.log(_posterior_probs(spec, log_cond.exp(), xt,
                                             mct, mcs))
        log_q_u = torch.log(_posterior_probs(spec, log_uncond.exp(), xt,
                                             mct, mcs))
        q_xs = torch.softmax(gamma * log_q_c + (1 - gamma) * log_q_u,
                             dim=-1)
    return _sample_and_copy(spec, sampler, generator, q_xs, xt), new_cache


def _posterior_log(spec, log_xt, xt, mct, mcs):
    """Unguided posterior in log space."""
    if spec.diffusion == 'absorbing_state':
        return fp.absorbing_posterior_log(log_xt, mct, mcs,
                                          mask_index=spec.mask_index)
    return torch.log(fp.uniform_posterior(
        log_xt.exp(), xt, 1 - mcs, 1 - mct, vocab_size=spec.vocab_size))


def classifier_log_probs_edits(classifier_apply, classifier_params, xt,
                               sigma, conditioning_class, *, vocab_size,
                               chunk: int = 256):
    """log p(class | edit) for every single-token edit of xt: for each
    (position l, token v), xt with xt[l] := v, scored by the classifier.
    Runs in chunks of `chunk` edits, each one classifier forward of
    B * chunk rows; the edit ids are padded to a multiple of `chunk` (the
    padding edits the last position and is dropped). Returns (B, L, V)
    float32."""
    B, L = xt.shape
    total = L * vocab_size
    n_chunks = -(-total // chunk)
    ids = torch.arange(n_chunks * chunk, device=xt.device)
    pos = (ids // vocab_size).clamp(0, L - 1)
    tok = (ids % vocab_size).to(xt.dtype)
    at_pos = pos[:, None] == torch.arange(L, device=xt.device)  # (N, L)
    sig = sigma.repeat_interleave(chunk)
    scores = []
    for c in range(n_chunks):
        part = slice(c * chunk, (c + 1) * chunk)
        edited = torch.where(at_pos[None, part], tok[None, part, None],
                             xt[:, None, :])                  # (B, C, L)
        logits = classifier_apply(classifier_params,
                                  edited.reshape(B * chunk, L), sig)
        scores.append(torch.log_softmax(logits.float(), dim=-1)
                      [..., conditioning_class].reshape(B, chunk))
    return torch.cat(scores, dim=1)[:, :total].reshape(B, L, vocab_size)


def _cbg_first_order(classifier_apply, classifier_params, xt, sigma,
                     condition: int, vocab_size: int):
    """First-order (Taylor) CBG around the one-hot of xt: log p(class | xt)
    plus the one-hot gradient of it, less the gradient at xt's own token."""
    xt_oh = F.one_hot(xt.long(), vocab_size).float().requires_grad_()
    with torch.enable_grad():
        logits = classifier_apply(classifier_params, xt_oh, sigma, grad=True)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        grad, = torch.autograd.grad(log_probs[..., condition].sum(), xt_oh)
    ratio = grad - (xt_oh.detach() * grad).sum(-1, keepdim=True)
    return ratio + log_probs.detach()[..., condition][..., None, None]


def _cbg_step(spec, sampler, guidance, model_apply, params,
              classifier_apply, classifier_params, generator, xt, sigma_t,
              mct, mcs, cache, cache_valid):
    """D-CBG: the guided posterior softmax(gamma * classifier log-prob +
    log q_xs), the classifier's log-probs exact over every edit or
    first-order (`guidance.use_approx`)."""
    dt = _sample_dtype(sampler)

    def compute():
        log_xt = log_x_theta(spec, model_apply, params, xt, sigma_t).to(dt)
        if guidance.use_approx:
            clf = _cbg_first_order(classifier_apply, classifier_params, xt,
                                   sigma_t, guidance.condition,
                                   spec.vocab_size)
        else:
            clf = classifier_log_probs_edits(
                classifier_apply, classifier_params, xt, sigma_t,
                guidance.condition, vocab_size=spec.vocab_size,
                chunk=guidance.cbg_chunk)
        return log_xt, clf.to(dt)

    (log_xt, clf), new_cache = _cached(compute, cache, cache_valid)
    guided = (guidance.gamma * clf
              + _posterior_log(spec, log_xt, xt, mct, mcs))
    if spec.diffusion == 'absorbing_state':
        guided = fp.apply_copy_flag_log(guided, xt,
                                        mask_index=spec.mask_index)
    xs = _sample_and_copy(spec, sampler, generator,
                          torch.softmax(guided, dim=-1), xt)
    return xs, new_cache


def _nos_step(spec, sampler, guidance, model_apply, params,
              classifier_apply, classifier_params, generator, xt, sigma_t,
              mct, mcs):
    """NOS: Adagrad on a hidden-state delta that raises the classifier's
    log-probability of `guidance.condition` while staying KL-close
    (`batchmean`) to the unguided reverse posterior; the trunk runs once,
    each inner step differentiates the classifier on hidden + delta and the
    denoiser's head on it."""
    sigma_in = process_sigma(spec, sigma_t)
    logits, hidden = model_apply(params, xt, sigma_in, None, None,
                                 train=False, rng=None,
                                 return_hidden_states=True)

    def to_log_probs(raw_logits):
        raw_logits = raw_logits.float()
        if spec.parameterization == 'subs':
            return fp.subs_parameterization(raw_logits, xt,
                                            mask_index=spec.mask_index)
        if spec.subs_masking:
            raw_logits = raw_logits + fp._one_hot(
                spec.mask_index, spec.vocab_size, raw_logits) \
                * fp.NEG_INFINITY
        return torch.log_softmax(raw_logits, dim=-1)

    def guided_log_posterior(raw_logits):
        out = _posterior_log(spec, to_log_probs(raw_logits), xt, mct, mcs)
        if spec.diffusion == 'absorbing_state':
            out = fp.apply_copy_flag_log(out, xt, mask_index=spec.mask_index)
        return out

    diffusion_log_probs = guided_log_posterior(logits)
    diffusion_probs = diffusion_log_probs.exp()

    def nos_grad(delta):
        with torch.enable_grad():
            delta = delta.detach().requires_grad_()
            h = hidden + delta
            clf_logits = classifier_apply(classifier_params, xt, sigma_in,
                                          x_emb=h, grad=True)
            target = torch.log_softmax(clf_logits.float(), dim=-1)[
                ..., guidance.condition].sum()
            new_logits = model_apply(params, xt, sigma_in, None, h,
                                     train=False, rng=None, grad=True)
            adjusted = guided_log_posterior(new_logits)
            # KLDivLoss(log_target=True, reduction='batchmean')
            kl = (diffusion_probs * (diffusion_log_probs - adjusted)
                  ).sum() / xt.shape[0]
            loss = -target + guidance.nos_stability_coef * kl
            return torch.autograd.grad(loss, delta)[0]

    delta = torch.zeros_like(hidden)
    acc = torch.zeros_like(hidden)
    for _ in range(guidance.num_nos_steps):
        g = nos_grad(delta)
        acc = acc + g * g
        delta = delta - guidance.nos_step_size * g / (acc.sqrt() + 1e-10)

    guided_logits = model_apply(params, xt, sigma_in, None, hidden + delta,
                                train=False, rng=None)
    if spec.diffusion == 'absorbing_state':
        guided_probs = guided_log_posterior(guided_logits).exp()
    else:
        guided_probs = fp.uniform_posterior(
            to_log_probs(guided_logits).exp(), xt, 1 - mcs, 1 - mct,
            vocab_size=spec.vocab_size)
    return _sample_and_copy(spec, sampler, generator, guided_probs, xt)


# ---------------------------------------------------------------------------
# Main loops
# ---------------------------------------------------------------------------

def _check_guidance(sampler, guidance, cond, classifier_apply=None,
                    classifier_params=None):
    """The guidance method, after checking that it is ported here and has
    what it needs: `cond` for cfg, a classifier for cbg and nos."""
    method = guidance.method if guidance is not None else None
    if method in ('cbg', 'nos'):
        if classifier_apply is None or classifier_params is None:
            raise ValueError(f'{method} guidance needs `classifier_apply` '
                             'and `classifier_params`')
    elif method in ('fudge', 'pplm'):
        raise NotImplementedError(
            f'guidance method {method!r} guides AR decoding: use '
            '`ar_sample`')
    elif method not in (None, 'cfg'):
        raise NotImplementedError(
            f'guidance method {method!r} not implemented')
    if method == 'cfg' and cond is None:
        raise ValueError('cfg guidance needs `cond`')
    return method


@torch.no_grad()
def diffusion_sample(spec: DiffusionSpec, sampler: SamplerSpec,
                     model_apply, params, generator: torch.Generator, *,
                     batch_size: int, length: int,
                     guidance: Optional[GuidanceSpec] = None,
                     cond: Optional[torch.Tensor] = None,
                     classifier_apply=None, classifier_params=None,
                     dit_cfg=None) -> torch.Tensor:
    """Ancestral reverse-diffusion sampling on `generator.device`.
    Returns (batch_size, length) int32 tokens."""
    if (sampler.first_hitting and spec.diffusion == 'absorbing_state'
            and (guidance is None or guidance.method == 'cfg')):
        return first_hitting_sample(
            spec, sampler, model_apply, params, generator,
            batch_size=batch_size, length=length, guidance=guidance,
            cond=cond, dit_cfg=dit_cfg)
    method = _check_guidance(sampler, guidance, cond, classifier_apply,
                             classifier_params)
    dev = generator.device
    B = batch_size
    xt = fp.sample_prior((B, length), diffusion=spec.diffusion,
                         mask_index=spec.mask_index,
                         vocab_size=spec.vocab_size, device=dev,
                         generator=generator)
    timesteps = torch.linspace(1.0, sampler.eps, sampler.steps + 1,
                               dtype=torch.float32, device=dev)
    dt_step = (1 - sampler.eps) / sampler.steps
    use_cache = (sampler.use_cache and spec.diffusion == 'absorbing_state'
                 and method in (None, 'cfg', 'cbg'))
    cache, valid = None, False
    # The head-fused step serves where the cache is off (`ddg_tpu`'s
    # precedence: the NFE cache's route wins); its weights are prepared
    # here, once.
    head = None
    if (sampler.fused_head and dit_cfg is not None and not use_cache
            and spec.diffusion == 'absorbing_state'
            and (method is None
                 or (method == 'cfg' and guidance.gamma not in (0.0, 1.0)))
            and _fused_ok(spec, sampler, guidance, xt)):
        head = _prepare_head(dit_cfg, params)
    for i in range(sampler.steps):
        t = timesteps[i]
        if spec.T > 0:
            t = fp.discretize_t(t, spec.T)
        t_vec = t.expand(B)
        sigma_t = spec.noise.total_noise(t_vec)
        sigma_s = spec.noise.total_noise(t_vec - dt_step)
        mct = (1 - torch.exp(-sigma_t))[:, None, None]
        mcs = (1 - torch.exp(-sigma_s))[:, None, None]
        cache_valid = valid if use_cache else None
        if method is None:
            xs, cache = _ddpm_step(spec, sampler, model_apply, params,
                                   generator, xt, sigma_t, mct, mcs, cache,
                                   cache_valid, dit_cfg=dit_cfg, head=head)
        elif method == 'cfg':
            xs, cache = _cfg_step(spec, sampler, guidance, model_apply,
                                  params, generator, xt, sigma_t, mct, mcs,
                                  cond, cache, cache_valid, dit_cfg=dit_cfg,
                                  head=head)
        elif method == 'cbg':
            xs, cache = _cbg_step(spec, sampler, guidance, model_apply,
                                  params, classifier_apply,
                                  classifier_params, generator, xt, sigma_t,
                                  mct, mcs, cache, cache_valid)
        else:
            xs = _nos_step(spec, sampler, guidance, model_apply, params,
                           classifier_apply, classifier_params, generator,
                           xt, sigma_t, mct, mcs)
        if use_cache:
            valid = torch.equal(xs, xt)
        xt = xs
    return xt


@torch.no_grad()
def first_hitting_sample(spec: DiffusionSpec, sampler: SamplerSpec,
                         model_apply, params, generator: torch.Generator, *,
                         batch_size: int, length: int,
                         guidance: Optional[GuidanceSpec] = None,
                         cond: Optional[torch.Tensor] = None,
                         dit_cfg=None) -> torch.Tensor:
    """Event-driven MDLM sampling (the exact T -> infinity limit): each
    token's decode time has survival move_chance(t) / move_chance(1);
    events are processed in decreasing time, one denoiser forward each,
    sampling the decoded token from x_theta at sigma(tau). L forwards in
    all (2B rows each under CFG)."""
    if spec.diffusion != 'absorbing_state':
        raise ValueError('first-hitting sampling is defined for '
                         'absorbing-state diffusion')
    method = _check_guidance(sampler, guidance, cond)
    dev = generator.device
    B, L = batch_size, length
    u = (torch.rand((B, L), generator=generator, device=dev)
         * (1.0 - sampler.eps) + sampler.eps)
    if isinstance(spec.noise, LogLinearNoise):
        tau = u        # move chance is linear in t
    else:
        mc1 = 1.0 - torch.exp(-spec.noise.total_noise(1.0)).item()
        sigma_tau = -torch.log1p(-u * mc1)
        tau = spec.noise.inverse_total_noise(sigma_tau).clamp(
            sampler.eps, 1.0)
    order = torch.argsort(-tau, dim=-1)
    times = torch.gather(tau, 1, order)
    xt = torch.full((B, L), spec.mask_index, dtype=torch.int32, device=dev)
    gamma = guidance.gamma if guidance is not None else None
    mixed_cfg = method == 'cfg' and gamma not in (0.0, 1.0)
    use_cond = None
    if method == 'cfg' and not mixed_cfg:
        use_cond = cond if gamma == 1.0 else torch.full_like(
            cond, spec.num_classes)

    def rows_log_probs(x, sigma, c, pos):
        """log-probs (rows, V) at position `pos` of each row."""
        if dit_cfg is not None:
            # Trunk only, then the head on the decoded row alone.
            from ddg_tpu_torch.models.dit import dit_head_fn
            hidden, cvec = model_apply(params, x, process_sigma(spec, sigma),
                                       c, None, train=False, rng=None,
                                       skip_head=True)
            rows = hidden[torch.arange(x.shape[0], device=dev), pos]
            logits = dit_head_fn(dit_cfg, params, rows, cvec)
            logits[:, spec.mask_index] += fp.NEG_INFINITY
            return torch.log_softmax(logits, dim=-1)
        lp = log_x_theta(spec, model_apply, params, x, sigma, cond=c)
        return lp[torch.arange(x.shape[0], device=dev), pos]

    for k in range(L):
        sigma_t = spec.noise.total_noise(times[:, k])
        pos = order[:, k]
        if mixed_cfg:
            null = torch.full_like(cond, spec.num_classes)
            lp2 = rows_log_probs(torch.cat([xt, xt]),
                                 torch.cat([sigma_t, sigma_t]),
                                 torch.cat([cond, null]),
                                 torch.cat([pos, pos]))
            row = torch.log_softmax(gamma * lp2[:B] + (1 - gamma) * lp2[B:],
                                    dim=-1)
        else:
            row = rows_log_probs(xt, sigma_t, use_cond, pos)
        g = S.gumbel_noise_like(row.shape, generator=generator,
                                dtype=row.dtype)
        tok = S.sample_token(
            row, g, low_confidence_sampling=sampler.low_confidence_sampling,
            low_confidence_threshold=sampler.low_confidence_threshold)
        xt[torch.arange(B, device=dev), pos] = tok.to(torch.int32)
    return xt


# ---------------------------------------------------------------------------
# AR sampling
# ---------------------------------------------------------------------------

def _ar_noise(sampler: SamplerSpec, generator, shape):
    """The AR samplers' Gumbel noise, drawn once before the first step."""
    return S.gumbel_noise_like(shape, generator=generator,
                               dtype=_sample_dtype(sampler))


def _ar_token(sampler: SamplerSpec, log_probs, noise):
    return S.sample_token(
        log_probs, noise,
        low_confidence_sampling=sampler.low_confidence_sampling,
        low_confidence_threshold=sampler.low_confidence_threshold)


def _ar_row_log_probs(model_apply, params, x, i, cond):
    """float32 log-probs (rows, V) of the token after position i, from the
    full causal forward of x."""
    logits = model_apply(params, x, None, cond, None, train=False, rng=None)
    return torch.log_softmax(logits[:, i].float(), dim=-1)


def _fudge_log_probs(spec, guidance, classifier_apply, classifier_params,
                     x, i, lp):
    """FUDGE: the top-k continuations of lp (B, V), each scored by the
    per-position classifier at position i + 1 (its prefix x[:, :i+1] plus
    the candidate; later positions stay 0). Returns (guided log-probs over
    the candidates (B, topk), their token ids)."""
    B, L = x.shape
    K = guidance.topk
    top, idx = torch.topk(lp, K, dim=-1)
    cand = x[:, None, :].repeat(1, K, 1)
    cand[:, :, i + 1] = idx.to(x.dtype)
    sig = spec.noise.total_noise(torch.zeros((B * K,), device=x.device))
    clf = classifier_apply(classifier_params, cand.view(B * K, L), sig)
    score = torch.log_softmax(clf.float(), dim=-1)[
        :, i + 1, guidance.condition].view(B, K)
    return torch.log_softmax(top + guidance.gamma * score, dim=-1), idx


def _pplm_log_probs(guidance, model_apply, params, classifier_apply,
                    classifier_params, x, i):
    """PPLM: Adagrad on a delta to the trunk's final hidden state, raising
    the classifier's log-probability of `guidance.condition` (on hidden +
    delta, the prefix 0..i as its attention mask) with a KL leash to the
    unguided next-token distribution; then the next token's float32
    log-probs from the denoiser's head on hidden + delta."""
    B, L = x.shape
    logits, hidden = model_apply(params, x, None, None, None, train=False,
                                 rng=None, return_hidden_states=True)
    base_lp = torch.log_softmax(logits[:, i].float(), dim=-1)
    base_p = base_lp.exp()
    prefix = (torch.arange(L, device=x.device) <= i).float().expand(B, L)

    def grad(delta):
        with torch.enable_grad():
            delta = delta.detach().requires_grad_()
            h = hidden + delta
            clf = classifier_apply(classifier_params, x, None, x_emb=h,
                                   attention_mask=prefix, grad=True)
            target = torch.log_softmax(clf.float(), dim=-1)[
                ..., guidance.condition].sum()
            new = model_apply(params, x, None, None, h, train=False,
                              rng=None, grad=True)
            new_lp = torch.log_softmax(new[:, i].float(), dim=-1)
            kl = (base_p * (base_lp - new_lp)).sum() / B
            loss = -target + guidance.pplm_stability_coef * kl
            return torch.autograd.grad(loss, delta)[0]

    delta = torch.zeros_like(hidden)
    acc = torch.zeros_like(hidden)
    for _ in range(guidance.num_pplm_steps):
        g = grad(delta)
        acc = acc + g * g
        delta = delta - guidance.pplm_step_size * g / (acc.sqrt() + 1e-10)
    guided = model_apply(params, x, None, None, hidden + delta, train=False,
                         rng=None)
    return torch.log_softmax(guided[:, i].float(), dim=-1)


@torch.no_grad()
def ar_sample(spec: DiffusionSpec, sampler: SamplerSpec, model_apply,
              params, generator: torch.Generator, *, batch_size: int,
              length: int, bos_token_id: int,
              guidance: Optional[GuidanceSpec] = None,
              cond: Optional[torch.Tensor] = None,
              classifier_apply=None, classifier_params=None,
              decode_cfg=None) -> torch.Tensor:
    """AR decoding on `generator.device` (`ddg_tpu`'s `ar_sample`): the
    stateful decode of `decode_cfg` for none and D-CFG, else the full
    causal forward each step (FUDGE, PPLM, or no `decode_cfg`). Returns
    (batch_size, length) int32 tokens, position 0 the bos token."""
    if spec.parameterization != 'ar':
        raise ValueError('ar_sample needs the ar parameterization, got '
                         f'{spec.parameterization!r}')
    method = guidance.method if guidance is not None else None
    if method not in (None, 'cfg', 'fudge', 'pplm'):
        raise NotImplementedError(
            f'guidance method {method!r} does not guide AR decoding')
    if method == 'cfg' and cond is None:
        raise ValueError('cfg guidance needs `cond`')
    if method in ('fudge', 'pplm') and (classifier_apply is None
                                        or classifier_params is None):
        raise ValueError(f'{method} guidance needs `classifier_apply` and '
                         '`classifier_params`')
    if decode_cfg is not None and method in (None, 'cfg'):
        return _ar_sample_kv(spec, sampler, params, generator,
                             batch_size=batch_size, length=length,
                             bos_token_id=bos_token_id, guidance=guidance,
                             cond=cond, decode_cfg=decode_cfg)
    if sampler.ar_kv_int8:
        warnings.warn('ar_kv_int8=True ignored: the full-forward AR path '
                      'has no KV cache')
    dev = generator.device
    B, dt = batch_size, _sample_dtype(sampler)
    noise = _ar_noise(sampler, generator, (
        B, length - 1, guidance.topk if method == 'fudge'
        else spec.vocab_size))
    x = torch.zeros((B, length), dtype=torch.int32, device=dev)
    x[:, 0] = bos_token_id
    for i in range(length - 1):
        pick = None
        if method == 'cfg':
            gamma = guidance.gamma
            null = torch.full_like(cond, spec.num_classes)
            if gamma in (0.0, 1.0):
                lp = _ar_row_log_probs(model_apply, params, x, i,
                                       cond if gamma == 1.0 else null).to(dt)
            else:
                lp2 = _ar_row_log_probs(model_apply, params,
                                        torch.cat([x, x]), i,
                                        torch.cat([cond, null])).to(dt)
                lp = torch.log_softmax(
                    gamma * lp2[:B] + (1 - gamma) * lp2[B:], dim=-1)
        elif method == 'fudge':
            lp, pick = _fudge_log_probs(
                spec, guidance, classifier_apply, classifier_params, x, i,
                _ar_row_log_probs(model_apply, params, x, i, None).to(dt))
        elif method == 'pplm':
            lp = _pplm_log_probs(guidance, model_apply, params,
                                 classifier_apply, classifier_params, x,
                                 i).to(dt)
        else:
            lp = _ar_row_log_probs(model_apply, params, x, i, None).to(dt)
        y = _ar_token(sampler, lp, noise[:, i])
        if pick is not None:
            y = pick.gather(1, y[:, None])[:, 0]
        x[:, i + 1] = y.to(torch.int32)
    return x


def _ar_sample_kv(spec, sampler, params, generator, *, batch_size, length,
                  bos_token_id, guidance, cond, decode_cfg):
    """Stateful AR decoding; D-CFG decodes cond and null as one batch of
    2B rows and mixes their log-probs. `decode_cfg` picks the decode: a
    DiMambaConfig its conv and SSM state, a DITConfig its KV cache, read
    in `sampler.ar_buckets` length buckets."""
    from ddg_tpu_torch.models import dimamba_decode, dit_decode
    from ddg_tpu_torch.models.dimamba import DiMambaConfig
    dev = generator.device
    B, dt = batch_size, _sample_dtype(sampler)
    num_pred = length - 1
    noise = _ar_noise(sampler, generator, (B, num_pred, spec.vocab_size))
    method = guidance.method if guidance is not None else None
    gamma = guidance.gamma if guidance is not None else None
    mixed = method == 'cfg' and gamma not in (0.0, 1.0)
    dec_cond = None
    if method == 'cfg':
        null = torch.full_like(cond, spec.num_classes)
        dec_cond = (torch.cat([cond, null]) if mixed
                    else null if gamma == 0.0 else cond)
    dec_B = 2 * B if mixed else B
    if isinstance(decode_cfg, DiMambaConfig):
        if sampler.ar_kv_int8:
            warnings.warn('ar_kv_int8=True has no effect: this decode '
                          'backbone has no KV cache (DiT only)')
        dparams = dimamba_decode.precast(params)
        cache = dimamba_decode.init_cache(decode_cfg, dec_B, device=dev)

        def logits_at(tok, i, window):
            return dimamba_decode.decode_step(decode_cfg, dparams, cache,
                                              tok, cond=dec_cond)[0]
        buckets = 1
    else:
        dparams = dit_decode.precast(decode_cfg, params)
        cache = dit_decode.init_cache(decode_cfg, dec_B,
                                      kv_int8=sampler.ar_kv_int8, device=dev)
        terms = (None if dec_cond is None
                 else dit_decode.cond_terms(decode_cfg, dparams, dec_cond))

        def logits_at(tok, i, window):
            return dit_decode.decode_step(decode_cfg, dparams, cache, tok, i,
                                          window=window, terms=terms)[0]
        buckets = max(1, sampler.ar_buckets)
    x = torch.zeros((B, length), dtype=torch.int32, device=dev)
    x[:, 0] = bos_token_id
    bounds = [round(num_pred * j / buckets) for j in range(buckets + 1)]
    for j in range(buckets):
        # Bucket j's positions read a 128-ceil prefix of the cache.
        window = (min(length, -(-bounds[j + 1] // 128) * 128)
                  if buckets > 1 else None)
        for i in range(bounds[j], bounds[j + 1]):
            tok = x[:, i]
            lp = torch.log_softmax(
                logits_at(torch.cat([tok, tok]) if mixed else tok, i,
                          window).to(dt), dim=-1)
            if mixed:
                lp = torch.log_softmax(
                    gamma * lp[:B] + (1 - gamma) * lp[B:], dim=-1)
            x[:, i + 1] = _ar_token(sampler, lp, noise[:, i]).to(torch.int32)
    return x
