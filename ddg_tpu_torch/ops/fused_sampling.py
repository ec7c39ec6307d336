"""Fused absorbing-state denoise step (port of
`ddg_tpu/ops/fused_sampling.py:40-292`): SUBS + posterior + Gumbel-argmax
+ copy-over from raw logits, in one kernel per step.

Math (MDLM, absorbing state):
  log q_v    = z_v - LSE(z) + log(mct - mcs)  for v != mask   (z_mask = -1e30)
  log q_mask = log(mcs)
  xs = argmax_v(log q_v + g_v), lowest index on ties; xs = xt where xt != mask
The CFG variant takes z = gamma * l_c + (1 - gamma) * l_u with a single LSE
(the per-row log-partition constants of the two log-softmaxes cancel).

On CUDA tensors each function is one launch of `csrc/absorbing_sample.cu`;
on CPU tensors the plain versions below run instead. `gumbel=` passes
(B, L, V) float32 noise in; otherwise the noise comes from `seed`: a
Philox counter in the kernel, a `torch.Generator` seeded with it in the
plain version. The two give different draws of the same distribution.
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


def _launch(wrapper, seed, xt, lc, lu, mct, mcs, gumbel, mask_index,
            gamma):
    B, L, V = lc.shape
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([seed], dtype=torch.int32, device=lc.device)
    tensors = [seed, xt, lc, mct, mcs]
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
            or mct.dtype != torch.float32 or mcs.dtype != torch.float32
            or tuple(mct.shape) != (B,) or tuple(mcs.shape) != (B,)):
        raise ValueError('seed: one int32; xt: (B, L) int32; '
                         'move chances: (B,) float32')
    if gumbel is not None and (gumbel.dtype != torch.float32
                               or gumbel.shape != lc.shape):
        raise ValueError('gumbel must be float32 of the logits\' shape')
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
