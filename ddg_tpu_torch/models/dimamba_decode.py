"""Stateful single-token decoding for the unidirectional DiMamba (port of
`ddg_tpu/models/dimamba_decode.py`).

Per block and row a rolling window of the last `d_conv` conv inputs and
the SSM state h (d_inner x d_state), both float32:
  h' = exp(delta A) h + delta B x,  y = C . h' + D x,  out = y silu(z).
The step runs in float32 throughout, as `ddg_tpu`'s, on the port's
`DiMamba` parameters (the `{name: tensor}` dict of
`make_model_apply(model).params`); `precast` gives those weights float32
once per sampling call (the port's mixer holds the compute dtype). The
decode has no position argument and no window: its state is O(1) in L.
Only the forward direction exists (a bidirectional DiMamba cannot
decode).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ddg_tpu_torch.models.dimamba import DiMambaConfig
from ddg_tpu_torch.ops.mamba import softplus


def init_cache(cfg: DiMambaConfig, batch_size: int,
               device=None) -> Dict[str, torch.Tensor]:
    """Zeroed float32 states: 'conv' (n_blocks, B, d_conv, d_inner) and
    'ssm' (n_blocks, B, d_inner, d_state)."""
    d = cfg.d_inner
    return {'conv': torch.zeros((cfg.n_blocks, batch_size, cfg.d_conv, d),
                                device=device),
            'ssm': torch.zeros((cfg.n_blocks, batch_size, d, cfg.d_state),
                               device=device)}


def precast(params) -> Dict[str, torch.Tensor]:
    """Every floating parameter as float32 (a copy of those held in
    another dtype), once per sampling call."""
    return {k: (v.float() if v.is_floating_point() else v)
            for k, v in params.items()}


def _dense(params, name: str, x: torch.Tensor) -> torch.Tensor:
    b = params.get(name + '.bias')
    return F.linear(x, params[name + '.weight'], b)


def _layer_norm(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with scale and bias, float32 two-pass moments, eps 1e-5
    (`ddg_tpu`'s decode norm)."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return y * params[name + '.scale'] + params[name + '.bias']


def _mixer_step(cfg: DiMambaConfig, params, prefix: str, conv_state,
                ssm_state, h):
    """One Mamba step of the forward direction for h (B, D): returns
    (out (B, D), conv', ssm')."""
    core = prefix + 'core_fwd.'
    x, z = _dense(params, prefix + 'in_proj_fwd', h).chunk(2, -1)
    conv_state = torch.cat([conv_state[:, 1:], x[:, None, :]], 1)
    kernel = params[core + 'conv1d_kernel'][:, 0, :]          # (d_conv, d)
    conv_out = F.silu((conv_state * kernel[None]).sum(1)
                      + params[core + 'conv1d_bias'])
    x_dbl = F.linear(conv_out, params[core + 'x_proj.weight'])
    R, N = cfg.dt_rank, cfg.d_state
    dt, B_ssm, C_ssm = x_dbl[:, :R], x_dbl[:, R:R + N], x_dbl[:, R + N:]
    delta = softplus(_dense(params, core + 'dt_proj', dt.float()))
    A = -torch.exp(params[core + 'A_log'])                    # (d, N)
    a = torch.exp(delta[..., None] * A[None])                 # (B, d, N)
    b = (delta[..., None] * B_ssm[:, None, :].float()
         * conv_out[..., None].float())
    ssm_state = a * ssm_state + b
    y = ((ssm_state * C_ssm[:, None, :].float()).sum(-1)
         + params[core + 'D'] * conv_out.float())
    y = y * F.silu(z.float())
    out = F.linear(y.to(h.dtype), params[prefix + 'out_proj_fwd.weight'])
    return out, conv_state, ssm_state


def decode_step(cfg: DiMambaConfig, params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, cond: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One AR decode step: token (B,) -> (float32 logits (B, V), cache),
    the states updated in place. The AR DiMamba has no sigma conditioning;
    `cond` (a CFG label) enters through the adaLN projections when
    configured. `params` as `precast` gives them."""
    if cfg.bidirectional:
        raise ValueError('stateful decode needs a unidirectional DiMamba '
                         '(bidirectional=False)')
    x = params['word_embeddings.weight'][token.long()].float()    # (B, D)
    c = None
    if cond is not None:
        c = F.silu(params['cond_map.weight'][cond.long()]).float()
    residual = None
    for i in range(cfg.n_blocks):
        p = f'block_{i}.'
        residual = x + residual if residual is not None else x
        h = _layer_norm(params, p + 'norm', residual)
        gate = None
        if cfg.use_adaLN and c is not None:
            shift, scale, gate = _dense(params, p + 'adaLN_modulation',
                                        c).chunk(3, -1)
            h = h * (1 + scale) + shift
        out, conv, ssm = _mixer_step(cfg, params, p + 'mixer.',
                                     cache['conv'][i], cache['ssm'][i], h)
        cache['conv'][i] = conv
        cache['ssm'][i] = ssm
        x = gate * out + residual if gate is not None else out
    final = x + residual if residual is not None else x
    final = _layer_norm(params, 'norm_f', final)
    if cfg.use_adaLN and c is not None and 'adaLN_final.weight' in params:
        shift, scale = _dense(params, 'adaLN_final', c).chunk(2, -1)
        final = final * (1 + scale) + shift
    if cfg.tie_word_embeddings:
        logits = final @ params['word_embeddings.weight'].T
    else:
        logits = _dense(params, 'lm_head', final)
    return logits.float(), cache
