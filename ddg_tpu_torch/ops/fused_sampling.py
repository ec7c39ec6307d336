"""Fused denoise steps, one kernel per step (port of
`ddg_tpu/ops/fused_sampling.py:40-763`).

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
On the card both take a thread a row or a warp a row by the row's width
(`uniform_plan`).

Head-fused absorbing state (K11, K12): the vocab projection of the head
features runs inside the step, z = W f + bias (bf16 or fp32 operands,
fp32 sums; or the int8 head's (acc * x_scale) * w_scale + bias), and the
(B, L, V) logits never reach memory. The pick is the same posterior
argmax as K7's. The bf16 and int8 heads run a TMA and wgmma kernel
where `head_plan` (shape only) takes it (bf16 D up to 1280, int8 D up to
2560), in vocab splits of 1024 and 3840 rows; the fp32 head, and the
others past those widths, the first kernel (the bf16 head in the same
splits, the others in those `head_splits` sets from the card's SM count).

On CUDA tensors each function is one call of `csrc/absorbing_sample.cu`,
`csrc/uniform_sample.cu` or `csrc/head_sample.cu`; on CPU tensors the
plain versions below run instead. `gumbel=` passes (B, L, V) float32 noise in; otherwise the noise
comes from `seed`: a Philox counter in the kernel, a `torch.Generator`
seeded with it in the plain version. The two give different draws of the
same distribution.
"""

from __future__ import annotations

import functools

import torch

from ddg_tpu_torch.ops import _build
from ddg_tpu_torch.ops import quant

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


def uniform_plan(V: int, vocab_size: int, dtype, aligned: bool) -> dict:
    """How the card runs a uniform step, of one logits tensor (K9) or two
    (K10) alike, from its shape alone, as csrc `plan` (`ddg_uniform_plan`)
    does: a thread a row where the vocabulary is at most 32 columns
    (kernel 1, holding 12, 16 or 32 of them), else a warp a row (kernel 2
    for one turn of 256 columns, 3 for more), a lane 8 columns a turn,
    16-byte loads (`vec`) where V % 8 == 0 and every row is 16-byte
    aligned (`aligned`: each tensor's address)."""
    if dtype not in _DTYPES or not 0 < vocab_size <= V:
        raise ValueError(f'no uniform-step plan for V={V}, vocab_size='
                         f'{vocab_size}, {dtype}')
    for cols in (12, 16, 32):
        if vocab_size <= cols:
            return dict(kernel=1, rows=256, cols=cols, vec=0)
    return dict(kernel=2 if vocab_size <= 256 else 3, rows=8, cols=8,
                vec=int(V % 8 == 0 and aligned))


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


# ---------------------------------------------------------------------------
# Head-fused absorbing state: K11, K12
# ---------------------------------------------------------------------------

# Vocab rows a chunk of the CUDA kernel, and token rows a block.
HEAD_CHUNK = 128
HEAD_TOKENS = 128
_HEAD_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _pad_rows(x, rows):
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))


def _padded_vocab(V, tile_v):
    return -(-V // tile_v) * tile_v


def pad_head_weights(weight, bias, tile_v: int = 2048):
    """One-time preparation for `fused_absorbing_head_sample`: the (V, D)
    head weight (the `nn.Linear` layout, which is the JAX kernel
    transposed) zero-padded to (Vp, D), Vp a multiple of tile_v, in its
    own dtype; the bias as a (Vp, 1) fp32 column. Loop-invariant."""
    Vp = _padded_vocab(weight.shape[0], tile_v)
    w_t = _pad_rows(weight, Vp).contiguous()
    bias_col = _pad_rows(bias.float()[:, None], Vp).contiguous()
    return w_t, bias_col


def quantize_head_weights(weight, bias, tile_v: int = 2048):
    """One-time preparation for `fused_absorbing_head_sample_int8`: the
    (V, D) head weight (float32, as the int8 DiT holds it) quantized per
    vocab row (the scheme of `ops.quant`), zero-padded to (Vp, D) int8, its (Vp, 1) fp32 scales and
    the (Vp, 1) fp32 bias. Loop-invariant."""
    q, scale = quant.quantize_rowwise(weight)
    Vp = _padded_vocab(weight.shape[0], tile_v)
    return (_pad_rows(q, Vp).contiguous(), _pad_rows(scale, Vp).contiguous(),
            _pad_rows(bias.float()[:, None], Vp).contiguous())


def quantize_head_inputs(feats):
    """Per-token int8 head features for K12: (B, L, D) -> ((B, L, D)
    int8, (B, L, 1) fp32 scales). The JAX function returns the same codes
    and scales transposed to its kernel's (B, D, L) and (B, 1, L)."""
    return quant.quantize_rowwise(feats)


def head_logits(feats, w_t, bias_col):
    """fp32 logits (B, L, Vp) of the bf16 or fp32 head: the operands'
    exact products summed in fp32, plus the bias."""
    return torch.matmul(feats.float(), w_t.float().t()) + bias_col[:, 0]


def head_logits_int8(feats_q, x_scale, w_q, w_scale, bias_col):
    """fp32 logits (B, L, Vp) of the int8 head: the s32 product, then
    (acc * x_scale) * w_scale + bias, as `ops.quant.int8_dense` forms
    them."""
    B, L, D = feats_q.shape
    acc = quant.int8_matmul(feats_q.reshape(B * L, D), w_q)
    return quant.rescale(acc.reshape(B, L, -1), x_scale, w_scale[:, 0],
                         bias_col[:, 0], torch.float32)


def _head_pick(seed, xt, logits, mct, mcs, vocab_size, mask_index,
               gumbel_t):
    g = None
    if gumbel_t is not None:
        g = gumbel_t.transpose(1, 2)[..., :vocab_size]
    return _sample_plain(seed, xt, logits[..., :vocab_size], mct, mcs,
                         mask_index, g)


def fused_absorbing_head_sample_plain(seed, xt, feats, w_t, bias_col,
                                      move_chance_t, move_chance_s, *,
                                      vocab_size: int, mask_index: int,
                                      tile_v: int = 2048, gumbel_t=None):
    """Plain PyTorch version of `fused_absorbing_head_sample`: the full
    fp32 logits, then K7's pick (lowest index on ties)."""
    return _head_pick(seed, xt, head_logits(feats, w_t, bias_col),
                      move_chance_t, move_chance_s, vocab_size, mask_index,
                      gumbel_t)


def fused_absorbing_head_sample_int8_plain(seed, xt, feats_q, x_scale, w_q,
                                           w_scale, bias_col, move_chance_t,
                                           move_chance_s, *,
                                           vocab_size: int, mask_index: int,
                                           tile_v: int = 2048,
                                           gumbel_t=None):
    """Plain PyTorch version of `fused_absorbing_head_sample_int8`."""
    logits = head_logits_int8(feats_q, x_scale, w_q, w_scale, bias_col)
    return _head_pick(seed, xt, logits, move_chance_t, move_chance_s,
                      vocab_size, mask_index, gumbel_t)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The bf16 head kernel for Hopper (csrc `head_plan`, path 1): 64 tokens a
# block, 128 vocab rows a chunk, 8 chunks a split (a block); D / 64
# feature tiles of 8 KB, 2 to 8 W slots of 16 KB and a 64 x 132 fp32
# logits tile a block, with 1 KB of alignment and the mbarriers, within
# the card's shared memory.
_HW_TOKENS, _HW_CHUNK, _HW_SPLIT_CHUNKS = 64, 128, 8
_HW_TILE, _HW_STAGE, _HW_MAX_STAGES, _SMEM_MAX = 8192, 16384, 8, 232448
_HW_Z = 64 * 132 * 4
# The int8 head kernel (csrc `s8`, path 1 for int8): 64 tokens a block,
# 128 vocab rows a chunk, 30 chunks a split; D / 128 feature tiles of 8 KB,
# 2 to 8 W slots of 16 KB (128 rows x 128 int8) and a 64 x 132 s32 tile.
_S8_TOKENS, _S8_CHUNK, _S8_SPLIT_CHUNKS, _S8_K, _S8_MIN_STAGES = (
    64, 128, 30, 128, 2)


def _hw_smem(nk: int, stages: int) -> int:
    return (1024 + nk * _HW_TILE + stages * _HW_STAGE + _HW_Z
            + 8 * (2 * stages + 3))


def _s8_smem(nk: int, stages: int) -> int:
    return (1024 + nk * _S8_TOKENS * _S8_K + stages * _S8_CHUNK * _S8_K
            + _S8_TOKENS * (_S8_CHUNK + 4) * 4 + 8 * (2 * stages + 3))


def _stages(smem, nk: int) -> int:
    stages = _HW_MAX_STAGES
    while stages > 0 and smem(nk, stages) > _SMEM_MAX:
        stages -= 1
    return stages


def head_plan(n_tokens: int, D: int, Vp: int, dtype) -> dict:
    """How the card runs a head call, from its shape alone (no SM count),
    as csrc `head_plan` (`ddg_head_plan`) does. A bf16 head takes vocab
    splits of 1024 rows (the last what is left): on path 1, the bf16
    kernel (TMA, wgmma, a block per 64 tokens and split), where its
    feature tiles fit beside two W slots (D up to 1280); else on path 0,
    the first kernel. An int8 head takes path 1, the int8 kernel (int8
    wgmma, a block per 64 tokens and split of 3840 rows), where its
    feature tiles fit beside two W slots (D up to 2560, a multiple of 16);
    else path 0 with no splits here, as the fp32 head: `head_splits` sets
    theirs."""
    zero = dict(path=0, tokens=0, chunk=0, split_chunks=0, splits=0,
                stages=0, smem=0)
    if n_tokens <= 0 or D <= 0 or Vp <= 0 or Vp % _HW_CHUNK:
        return zero
    if dtype == torch.int8:
        nk = -(-D // _S8_K)
        stages = _stages(_s8_smem, nk)
        if D % 16 or stages < _S8_MIN_STAGES:
            return zero
        return dict(path=1, tokens=_S8_TOKENS, chunk=_S8_CHUNK,
                    split_chunks=_S8_SPLIT_CHUNKS,
                    splits=-(-Vp // (_S8_SPLIT_CHUNKS * _S8_CHUNK)),
                    stages=stages, smem=_s8_smem(nk, stages))
    nk = -(-D // 64)
    stages = _stages(_hw_smem, nk)
    splits = -(-Vp // (_HW_SPLIT_CHUNKS * _HW_CHUNK))
    if dtype != torch.bfloat16 or D % 8:
        return zero
    if stages < 2:
        return dict(path=0, tokens=0, chunk=0,
                    split_chunks=_HW_SPLIT_CHUNKS, splits=splits, stages=0,
                    smem=0)
    return dict(path=1, tokens=_HW_TOKENS, chunk=_HW_CHUNK,
                split_chunks=_HW_SPLIT_CHUNKS, splits=splits,
                stages=stages, smem=_hw_smem(nk, stages))


def head_splits(n_tokens: int, Vp: int, sms: int) -> int:
    """Vocab splits of the first head kernel's grid for the fp32 head and
    the int8 head on path 0: enough blocks for two a multiprocessor, each split a whole
    number of chunks and none empty."""
    chunks = Vp // HEAD_CHUNK
    tiles = -(-n_tokens // HEAD_TOKENS)
    want = min(chunks, max(1, -(-2 * sms // tiles)))
    per = -(-chunks // want)
    return -(-chunks // per)


def _check_head(seed, xt, feats, w_t, bias_col, mct, mcs, vocab_size,
                mask_index, tile_v, gumbel_t, extra=()):
    B, L, D = feats.shape
    Vp = w_t.shape[0]
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([seed], dtype=torch.int32, device=feats.device)
    tensors = [seed, xt, feats, w_t, bias_col, mct, mcs, *extra]
    if gumbel_t is not None:
        tensors.append(gumbel_t)
    _build.require_cuda(*tensors)
    es = feats.element_size()
    if (feats.dtype not in _HEAD_MODES or w_t.dtype != feats.dtype
            or tuple(w_t.shape) != (Vp, D)):
        raise ValueError('feats (B, L, D) and w_t (Vp, D) must share a '
                         'dtype: float32, bfloat16 or int8')
    if (D * es) % 64 or feats.data_ptr() % 16 or w_t.data_ptr() % 16:
        raise ValueError(f'the head kernel takes rows of D a multiple of '
                         f'64 bytes ({64 // es} {feats.dtype} values), '
                         f'16-byte aligned; got D={D}')
    if (Vp % tile_v or Vp % HEAD_CHUNK or not 2 <= vocab_size <= Vp
            or not 0 <= mask_index < vocab_size):
        raise ValueError(f'Vp={Vp} must be a multiple of tile_v={tile_v} '
                         f'and of {HEAD_CHUNK}, with 2 <= vocab_size '
                         f'({vocab_size}) <= Vp and mask_index in '
                         '[0, vocab_size)')
    if (seed.dtype != torch.int32 or seed.numel() != 1
            or xt.dtype != torch.int32 or tuple(xt.shape) != (B, L)
            or mct.dtype != torch.float32 or mcs.dtype != torch.float32
            or tuple(mct.shape) != (B,) or tuple(mcs.shape) != (B,)
            or bias_col.dtype != torch.float32
            or tuple(bias_col.shape) != (Vp, 1)):
        raise ValueError('seed: one int32; xt: (B, L) int32; move chances: '
                         '(B,) float32; bias_col: (Vp, 1) float32')
    if gumbel_t is not None and (gumbel_t.dtype != torch.float32
                                 or tuple(gumbel_t.shape) != (B, Vp, L)):
        raise ValueError('gumbel_t must be float32 (B, Vp, L)')
    return seed


def _launch_head(wrapper, seed, xt, feats, w_t, bias_col, x_scale, w_scale,
                 mct, mcs, vocab_size, mask_index, tile_v, gumbel_t,
                 logits_out=None):
    """One call of `csrc/head_sample.cu` (the product-and-pick kernel of
    `head_plan`'s path, then the merge of its vocab splits in order).
    `logits_out`, a (B, L, Vp) fp32 tensor, receives the logits the kernel
    formed (a probe for checks)."""
    extra = () if x_scale is None else (x_scale, w_scale)
    seed = _check_head(seed, xt, feats, w_t, bias_col, mct, mcs, vocab_size,
                       mask_index, tile_v, gumbel_t, extra)
    B, L, D = feats.shape
    Vp = w_t.shape[0]
    if x_scale is not None and (
            x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32
            or tuple(x_scale.shape) != (B, L, 1)
            or tuple(w_scale.shape) != (Vp, 1)):
        raise ValueError('x_scale: (B, L, 1) float32; w_scale: (Vp, 1) '
                         'float32')
    if logits_out is not None and (logits_out.dtype != torch.float32
                                   or tuple(logits_out.shape) != (B, L, Vp)
                                   or not logits_out.is_contiguous()):
        raise ValueError('logits_out must be contiguous float32 (B, L, Vp)')
    splits = (head_plan(B * L, D, Vp, feats.dtype)['splits']
              or head_splits(B * L, Vp, _sm_count(feats.device.index or 0)))
    part = torch.empty((5, splits, B * L), dtype=torch.float32,
                       device=feats.device)
    out = torch.empty((B, L), dtype=torch.int32, device=feats.device)
    fn = _build.kernel('head_sample', 'ddg_head_sample',
                       (_build.ptr,) * 13 + (_build.i32,) * 8
                       + (_build.ptr,))
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = fn(seed.data_ptr(), xt.data_ptr(), feats.data_ptr(),
            w_t.data_ptr(), bias_col.data_ptr(), ptr(x_scale),
            ptr(w_scale), mct.data_ptr(), mcs.data_ptr(), ptr(gumbel_t),
            out.data_ptr(), part.data_ptr(), ptr(logits_out), B, L, D, Vp,
            vocab_size, mask_index, _HEAD_MODES[feats.dtype], splits,
            _build.stream(feats))
    wrapper.launches += 1
    _build.check(rc, 'ddg_head_sample')
    return out


def fused_absorbing_head_sample(seed, xt, feats, w_t, bias_col,
                                move_chance_t, move_chance_s, *,
                                vocab_size: int, mask_index: int,
                                tile_v: int = 2048, gumbel_t=None):
    """SUBS + posterior + Gumbel-argmax + copy-over with the vocab product
    inside (K11).

    feats: (B, L, D) head features, bfloat16 or float32, contiguous in D
    (the JAX kernel takes them transposed, (B, D, L)); w_t: (Vp, D) head
    weight of the same dtype, zero-padded to a multiple of tile_v
    (`pad_head_weights`); bias_col: (Vp, 1) float32; xt: (B, L) int32;
    move_chance_*: (B,) float32; gumbel_t: optional (B, Vp, L) float32, the
    JAX layout. seed: int or a one-element int32 tensor. Returns xs (B, L)
    int32. On the card D must fill whole 64-byte rows (D % 32 in bf16, D %
    16 in fp32) and Vp be a multiple of 128."""
    if feats.device.type == 'cpu':
        return fused_absorbing_head_sample_plain(
            seed, xt, feats, w_t, bias_col, move_chance_t, move_chance_s,
            vocab_size=vocab_size, mask_index=mask_index, tile_v=tile_v,
            gumbel_t=gumbel_t)
    if feats.dtype == torch.int8:
        raise ValueError('int8 features take '
                         'fused_absorbing_head_sample_int8')
    return _launch_head(fused_absorbing_head_sample, seed, xt, feats, w_t,
                        bias_col, None, None, move_chance_t, move_chance_s,
                        vocab_size, mask_index, tile_v, gumbel_t)


fused_absorbing_head_sample.launches = 0


def fused_absorbing_head_sample_int8(seed, xt, feats_q, x_scale, w_q,
                                     w_scale, bias_col, move_chance_t,
                                     move_chance_s, *, vocab_size: int,
                                     mask_index: int, tile_v: int = 2048,
                                     gumbel_t=None):
    """K11 with the int8 head (K12): an s8 x s8 -> s32 product rescaled as
    `ops.quant.int8_dense` does, so the logits equal the unfused int8
    head's.

    feats_q: (B, L, D) int8 and x_scale: (B, L, 1) float32 from
    `quantize_head_inputs` (the JAX kernel takes them transposed); w_q:
    (Vp, D) int8, w_scale and bias_col: (Vp, 1) float32 from
    `quantize_head_weights`; the rest as `fused_absorbing_head_sample`. On
    the card D must be a multiple of 64."""
    if feats_q.device.type == 'cpu':
        return fused_absorbing_head_sample_int8_plain(
            seed, xt, feats_q, x_scale, w_q, w_scale, bias_col,
            move_chance_t, move_chance_s, vocab_size=vocab_size,
            mask_index=mask_index, tile_v=tile_v, gumbel_t=gumbel_t)
    if feats_q.dtype != torch.int8:
        raise ValueError('fused_absorbing_head_sample_int8 takes int8 '
                         'features')
    return _launch_head(fused_absorbing_head_sample_int8, seed, xt, feats_q,
                        w_q, bias_col, x_scale, w_scale, move_chance_t,
                        move_chance_s, vocab_size, mask_index, tile_v,
                        gumbel_t)


fused_absorbing_head_sample_int8.launches = 0
