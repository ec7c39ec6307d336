"""Fused denoise steps, one kernel per step (port of
`ddg_tpu/ops/fused_sampling.py:40-398`).

Absorbing state (MDLM; K7, K8): SUBS + posterior + Gumbel-argmax +
copy-over from raw logits.
  log q_v    = z_v - LSE(z) + log(mct - mcs)  for v != mask   (z_mask = -1e30)
  log q_mask = log(mcs)
  xs = argmax_v(log q_v + g_v), lowest index on ties; xs = xt where xt != mask
The CFG variant takes z = gamma * l_c + (1 - gamma) * l_u with a single LSE
(the per-row log-partition constants of the two log-softmaxes cancel).

Uniform state (UDLM; K9, K10): softmax + posterior numerator + Gumbel-
argmax, every token resampled. With p = softmax(z) over the first
`vocab_size` columns, a_ts = a_t / a_s and I = [v == xt]:
  num_v   = p_v ((a_s - a_t) + I a_t vocab_size) + I (a_ts - a_t)
            + (1 - a_ts)(1 - a_s) / vocab_size
  log q_v = log(num_v + 1e-35);  -1e30 at columns >= vocab_size
The posterior's denominator is constant along a row. The CFG variant
interpolates log-posteriors, gamma log q(l_c) + (1 - gamma) log q(l_u).

On CUDA tensors each function is one launch of `csrc/absorbing_sample.cu`
or `csrc/uniform_sample.cu`; on CPU tensors the plain versions below run
instead. `gumbel=` passes (B, L, V) float32 noise in; otherwise the noise
comes from `seed`: a Philox counter in the kernel, a `torch.Generator`
seeded with it in the plain version. The two give different draws of the
same distribution.
"""

from __future__ import annotations

import torch

from ddg_tpu_torch.ops import _build

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gumbel_from_seed(seed, shape, device):
    """Gumbel noise from 24-bit uniforms, u = top24 / 2^24 + 1e-10, as the
    kernels build it; the bits come from a generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    bits = torch.randint(0, 1 << 24, shape, generator=gen, device=device,
                         dtype=torch.int32)
    u = bits.float() * (1.0 / (1 << 24)) + 1e-10
    return -torch.log(-torch.log(u))


def cfg_mix(logits_cond, logits_uncond, gamma):
    """gamma * l_c + (1 - gamma) * l_u in fp32, as the CFG kernel forms
    it."""
    return gamma * logits_cond.float() + (1 - gamma) * logits_uncond.float()


def perturbed_scores(seed, z, move_chance_t, move_chance_s, *,
                     mask_index: int, gumbel=None):
    """log q + g over the vocabulary, from fp32 scores z (B, L, V): the
    quantity whose argmax the kernels take. (The top-two gap of these
    scores says where two correct implementations may pick different
    tokens.)"""
    V = z.shape[-1]
    is_mask = torch.arange(V, device=z.device) == mask_index
    z = torch.where(is_mask, torch.full_like(z, NEG), z)
    m = z.amax(-1, keepdim=True)
    lse = m + torch.log(torch.exp(z - m).sum(-1, keepdim=True))
    log_move = torch.log(move_chance_t.float() - move_chance_s.float())
    log_stay = torch.log(move_chance_s.float())
    log_q = torch.where(is_mask, log_stay[:, None, None],
                        z - lse + log_move[:, None, None])
    if gumbel is None:
        gumbel = _gumbel_from_seed(seed, z.shape, z.device)
    return log_q + gumbel.float()


def _sample_plain(seed, xt, z, mct, mcs, mask_index, gumbel):
    """Gumbel-argmax (lowest index on ties) and copy-over."""
    scores = perturbed_scores(seed, z, mct, mcs, mask_index=mask_index,
                              gumbel=gumbel)
    xs = torch.argmax(scores, dim=-1).to(torch.int32)
    return torch.where(xt != mask_index, xt.to(torch.int32), xs)


def fused_absorbing_sample_plain(seed, xt, logits, move_chance_t,
                                 move_chance_s, *, mask_index: int,
                                 gumbel=None):
    """Plain PyTorch version of `fused_absorbing_sample`."""
    return _sample_plain(seed, xt, logits.float(), move_chance_t,
                         move_chance_s, mask_index, gumbel)


def fused_absorbing_cfg_sample_plain(seed, xt, logits_cond, logits_uncond,
                                     gamma, move_chance_t, move_chance_s, *,
                                     mask_index: int, gumbel=None):
    """Plain PyTorch version of `fused_absorbing_cfg_sample`."""
    return _sample_plain(seed, xt, cfg_mix(logits_cond, logits_uncond,
                                           gamma),
                         move_chance_t, move_chance_s, mask_index, gumbel)


def _checked_seed(seed, xt, lc, lu, row_t, row_s, gumbel):
    """Check what the sampling kernels take; returns the seed as a one-
    element int32 tensor on the logits' device."""
    B, L, V = lc.shape
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([seed], dtype=torch.int32, device=lc.device)
    tensors = [seed, xt, lc, row_t, row_s]
    if lu is not None:
        tensors.append(lu)
    if gumbel is not None:
        tensors.append(gumbel)
    _build.require_cuda(*tensors)
    if lc.dtype not in _DTYPES or (lu is not None and (
            lu.dtype != lc.dtype or lu.shape != lc.shape)):
        raise ValueError('logits must be float32/bfloat16 and, for CFG, '
                         'share dtype and shape')
    if (seed.dtype != torch.int32 or seed.numel() != 1
            or xt.dtype != torch.int32 or tuple(xt.shape) != (B, L)
            or row_t.dtype != torch.float32 or row_s.dtype != torch.float32
            or tuple(row_t.shape) != (B,) or tuple(row_s.shape) != (B,)):
        raise ValueError('seed: one int32; xt: (B, L) int32; '
                         'move chances or alphas: (B,) float32')
    if gumbel is not None and (gumbel.dtype != torch.float32
                               or gumbel.shape != lc.shape):
        raise ValueError('gumbel must be float32 of the logits\' shape')
    return seed


def _launch(wrapper, seed, xt, lc, lu, mct, mcs, gumbel, mask_index,
            gamma):
    B, L, V = lc.shape
    seed = _checked_seed(seed, xt, lc, lu, mct, mcs, gumbel)
    if not 0 <= mask_index < V:
        raise ValueError(f'mask_index {mask_index} outside [0, {V})')
    out = torch.empty((B, L), dtype=torch.int32, device=lc.device)
    fn = _build.kernel(
        'absorbing_sample', 'ddg_absorbing_sample',
        (_build.ptr,) * 8 + (_build.i32,) * 4 + (_build.f32,) * 2
        + (_build.i32,) * 2 + (_build.ptr,))
    g = 0.0 if gamma is None else float(gamma)
    rc = fn(seed.data_ptr(), xt.data_ptr(), lc.data_ptr(),
            None if lu is None else lu.data_ptr(), mct.data_ptr(),
            mcs.data_ptr(), None if gumbel is None else gumbel.data_ptr(),
            out.data_ptr(), B * L, L, V, mask_index, g, 1.0 - g,
            int(lu is not None), _DTYPES[lc.dtype], _build.stream(lc))
    wrapper.launches += 1
    _build.check(rc, 'ddg_absorbing_sample')
    return out


def fused_absorbing_sample(seed, xt, logits, move_chance_t, move_chance_s,
                           *, mask_index: int, gumbel=None):
    """Fused SUBS + posterior + Gumbel-argmax + copy-over.

    seed: int, or a one-element int32 tensor on the logits' device;
    xt: (B, L) int32; logits: (B, L, V) float32 or bfloat16, any V;
    move_chance_*: (B,) float32; gumbel: optional (B, L, V) float32.
    Returns xs (B, L) int32."""
    if logits.device.type == 'cpu':
        return fused_absorbing_sample_plain(
            seed, xt, logits, move_chance_t, move_chance_s,
            mask_index=mask_index, gumbel=gumbel)
    return _launch(fused_absorbing_sample, seed, xt, logits, None,
                   move_chance_t, move_chance_s, gumbel, mask_index, None)


fused_absorbing_sample.launches = 0


def fused_absorbing_cfg_sample(seed, xt, logits_cond, logits_uncond, gamma,
                               move_chance_t, move_chance_s, *,
                               mask_index: int, gumbel=None):
    """CFG variant: z = gamma * logits_cond + (1 - gamma) * logits_uncond
    (fp32), then as `fused_absorbing_sample`. gamma: Python float."""
    if logits_cond.device.type == 'cpu':
        return fused_absorbing_cfg_sample_plain(
            seed, xt, logits_cond, logits_uncond, gamma, move_chance_t,
            move_chance_s, mask_index=mask_index, gumbel=gumbel)
    return _launch(fused_absorbing_cfg_sample, seed, xt, logits_cond,
                   logits_uncond, move_chance_t, move_chance_s, gumbel,
                   mask_index, gamma)


fused_absorbing_cfg_sample.launches = 0


# ---------------------------------------------------------------------------
# Uniform state (UDLM): K9, K10
# ---------------------------------------------------------------------------

def uniform_log_num(logits, xt, alpha_t, alpha_s, *, vocab_size: int):
    """log(num + 1e-35) of the uniform posterior, fp32 (B, L, V), -1e30 at
    columns >= vocab_size; alpha_*: (B,)."""
    z = logits.float()
    v = torch.arange(z.shape[-1], device=z.device)
    valid = v < vocab_size
    lg = torch.where(valid, z, NEG)
    m = lg.amax(-1, keepdim=True)
    lse = m + torch.log(torch.exp(lg - m).sum(-1, keepdim=True))
    p = torch.exp(lg - lse)
    a_t = alpha_t.float()[:, None, None]
    a_s = alpha_s.float()[:, None, None]
    a_ts = a_t / a_s
    is_xt = (v == xt[..., None].long()).float()
    num = (p * ((a_s - a_t) + is_xt * (a_t * vocab_size))
           + is_xt * (a_ts - a_t)
           + (1.0 - a_ts) * (1.0 - a_s) / vocab_size)
    return torch.where(valid, torch.log(num + 1e-35), NEG)


def uniform_perturbed_scores(seed, log_q, *, vocab_size: int, gumbel=None):
    """log q + g, -1e30 at columns >= vocab_size: the quantity whose argmax
    K9/K10 take."""
    if gumbel is None:
        gumbel = _gumbel_from_seed(seed, log_q.shape, log_q.device)
    valid = torch.arange(log_q.shape[-1], device=log_q.device) < vocab_size
    return torch.where(valid, log_q + gumbel.float(), NEG)


def uniform_cfg_log_num(logits_cond, logits_uncond, gamma, xt, alpha_t,
                        alpha_s, *, vocab_size: int):
    """gamma * log q(l_c) + (1 - gamma) * log q(l_u), -1e30 at columns >=
    vocab_size."""
    log_c = uniform_log_num(logits_cond, xt, alpha_t, alpha_s,
                            vocab_size=vocab_size)
    log_u = uniform_log_num(logits_uncond, xt, alpha_t, alpha_s,
                            vocab_size=vocab_size)
    valid = torch.arange(log_c.shape[-1], device=log_c.device) < vocab_size
    return torch.where(valid, gamma * log_c + (1 - gamma) * log_u, NEG)


def fused_uniform_sample_plain(seed, xt, logits, alpha_t, alpha_s, *,
                               vocab_size: int, gumbel=None):
    """Plain PyTorch version of `fused_uniform_sample`."""
    scores = uniform_perturbed_scores(
        seed, uniform_log_num(logits, xt, alpha_t, alpha_s,
                              vocab_size=vocab_size),
        vocab_size=vocab_size, gumbel=gumbel)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def fused_uniform_cfg_sample_plain(seed, xt, logits_cond, logits_uncond,
                                   gamma, alpha_t, alpha_s, *,
                                   vocab_size: int, gumbel=None):
    """Plain PyTorch version of `fused_uniform_cfg_sample`."""
    scores = uniform_perturbed_scores(
        seed, uniform_cfg_log_num(logits_cond, logits_uncond, gamma, xt,
                                  alpha_t, alpha_s, vocab_size=vocab_size),
        vocab_size=vocab_size, gumbel=gumbel)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _launch_uniform(wrapper, seed, xt, lc, lu, alpha_t, alpha_s, gumbel,
                    vocab_size, gamma):
    B, L, V = lc.shape
    seed = _checked_seed(seed, xt, lc, lu, alpha_t, alpha_s, gumbel)
    if not 0 < vocab_size <= V:
        raise ValueError(f'vocab_size {vocab_size} outside (0, {V}]')
    rows = [t for t in (lc, lu, gumbel) if t is not None]
    vec = V % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in rows)
    out = torch.empty((B, L), dtype=torch.int32, device=lc.device)
    fn = _build.kernel(
        'uniform_sample', 'ddg_uniform_sample',
        (_build.ptr,) * 8 + (_build.i32,) * 4 + (_build.f32,) * 2
        + (_build.i32,) * 3 + (_build.ptr,))
    g = 0.0 if gamma is None else float(gamma)
    rc = fn(seed.data_ptr(), xt.data_ptr(), lc.data_ptr(),
            None if lu is None else lu.data_ptr(), alpha_t.data_ptr(),
            alpha_s.data_ptr(), None if gumbel is None else gumbel.data_ptr(),
            out.data_ptr(), B * L, L, V, vocab_size, g, 1.0 - g,
            int(lu is not None), _DTYPES[lc.dtype], int(vec),
            _build.stream(lc))
    wrapper.launches += 1
    _build.check(rc, 'ddg_uniform_sample')
    return out


def fused_uniform_sample(seed, xt, logits, alpha_t, alpha_s, *,
                         vocab_size: int, gumbel=None):
    """Fused uniform posterior + Gumbel-argmax (a UDLM reverse step).

    seed: int, or a one-element int32 tensor on the logits' device;
    xt: (B, L) int32; logits: (B, L, V) float32 or bfloat16, any V >=
    vocab_size; alpha_*: (B,) float32 alpha(t), alpha(s); gumbel: optional
    (B, L, V) float32. Returns xs (B, L) int32."""
    if logits.device.type == 'cpu':
        return fused_uniform_sample_plain(seed, xt, logits, alpha_t, alpha_s,
                                          vocab_size=vocab_size,
                                          gumbel=gumbel)
    return _launch_uniform(fused_uniform_sample, seed, xt, logits, None,
                           alpha_t, alpha_s, gumbel, vocab_size, None)


fused_uniform_sample.launches = 0


def fused_uniform_cfg_sample(seed, xt, logits_cond, logits_uncond, gamma,
                             alpha_t, alpha_s, *, vocab_size: int,
                             gumbel=None):
    """CFG variant: gamma * log q(logits_cond) + (1 - gamma) * log
    q(logits_uncond), then as `fused_uniform_sample`. gamma: Python
    float."""
    if logits_cond.device.type == 'cpu':
        return fused_uniform_cfg_sample_plain(
            seed, xt, logits_cond, logits_uncond, gamma, alpha_t, alpha_s,
            vocab_size=vocab_size, gumbel=gumbel)
    return _launch_uniform(fused_uniform_cfg_sample, seed, xt, logits_cond,
                           logits_uncond, alpha_t, alpha_s, gumbel,
                           vocab_size, gamma)


fused_uniform_cfg_sample.launches = 0
