"""KV-cache decoding for the causal DiT (port of
`ddg_tpu/models/dit_decode.py`).

One token a step against cached keys and values: O(L^2) attention work a
sequence where the full causal forward of every prefix is O(L^3). The
decode reads the port's own `DIT` parameters, the `{name: tensor}` dict
of `make_model_apply(model).params`, so decoding and the full forward
share one set of weights.

The cache is heads-major, `(n_blocks, B, H, L, Dh)`, so that the first
`window` rows of a block are one batched-matmul operand without a copy
(`ddg_tpu` keeps `(n_blocks, B, L, H, Dh)`). The int8 cache keeps int8
rows and one float32 scale per (block, b, head, position); the scales
multiply outside the products: the scores by k's scale, the softmax
weights by v's. The int8 window is converted to the compute dtype before
its products (one dequantized copy of the window a block and step: XLA
fuses that convert into the dot, eager PyTorch cannot).

The attention is plain PyTorch (`ddg_tpu` computes it with einsums
outside any Pallas kernel): scores in float32 from the compute-dtype q
and cache (on the card `torch.bmm(..., out_dtype=torch.float32)`, which
accumulates and returns float32 without an upcast copy of the cache; on
the CPU the same product on float32 copies), a -1e30 mask past `pos`, a
float32 softmax, the weights cast to the compute dtype before PV.

`decode_step` takes `pos` as a Python int, so a loop over positions
needs no host sync; it writes the new rows into `cache` in place. The
class's adaLN terms do not depend on the position: `cond_terms` forms them
once for a loop.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ddg_tpu_torch.models.dit import DITConfig, rope_cos_sin

NEG = -1e30


def init_cache(cfg: DITConfig, batch_size: int, kv_int8: bool = False,
               device=None) -> Dict[str, torch.Tensor]:
    """Zeroed caches: 'k', 'v' (n_blocks, B, H, L, Dh) in the compute
    dtype, or int8 with 'k_s', 'v_s' (n_blocks, B, H, L) float32 scales."""
    head_dim = cfg.hidden_size // cfg.n_heads
    shape = (cfg.n_blocks, batch_size, cfg.n_heads, cfg.length, head_dim)
    if kv_int8:
        return {'k': torch.zeros(shape, dtype=torch.int8, device=device),
                'v': torch.zeros(shape, dtype=torch.int8, device=device),
                'k_s': torch.zeros(shape[:-1], device=device),
                'v_s': torch.zeros(shape[:-1], device=device)}
    return {'k': torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            'v': torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def _quant_row(x: torch.Tensor):
    """Per-row int8 over the last axis of x (B, H, D): codes round(x /
    scale) half to even, scale = max(absmax, 1e-12) / 127 (an IEEE
    division by a device tensor, so the card's codes are the CPU's)."""
    x32 = x.float()
    amax = x32.abs().amax(-1)
    scale = (torch.maximum(amax, amax.new_full((), 1e-12))
             / amax.new_full((), 127.0))
    q = torch.round(x32 / scale[..., None])
    return q.to(torch.int8), scale


def _dense(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b with the weights in x's dtype (`ddg_tpu`'s `_dense`:
    a no-op cast once `precast` has run)."""
    w = params[name + '.weight'].to(x.dtype)
    b = params.get(name + '.bias')
    return F.linear(x, w, None if b is None else b.to(x.dtype))


def _layer_norm(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Weight-only LayerNorm, float32 two-pass moments, eps 1e-5, cast back
    to x's dtype."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, -1, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + 1e-5) * weight).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_table(length: int, head_dim: int, device: str):
    return rope_cos_sin(length, head_dim, device=torch.device(device))


def _rope_at(pos: int, head_dim: int, length: int, device):
    """cos, sin (head_dim // 2,) float32 at position `pos`: rows of the
    full forward's table (pos * inv_freq in float32, as `ddg_tpu`)."""
    cos, sin = _rope_table(length, head_dim, str(device))
    return cos[pos], sin[pos]


def _apply_rope_single(x, cos, sin):
    """Rotate-half RoPE of x (..., D) at one position (q and k at once),
    float32, cast back to x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in float32, from operands in their
    own dtype."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


_DENSE = re.compile(r'(attn_qkv|attn_out|mlp\.\d|adaLN_modulation|linear)'
                    r'\.(weight|bias)$')


def precast(cfg: DITConfig, params) -> Dict[str, torch.Tensor]:
    """The dense weights and biases cast once to the dtype `decode_step`
    multiplies them in (the vocab head's to `logits_dtype`, the rest to
    `compute_dtype`; `ddg_tpu`'s `_precast`). The same roundings as the
    in-loop casts, so the logits do not change; embeddings and norm
    weights stay as they are. A no-op copy of the dict at float32."""
    out = dict(params)
    if cfg.compute_dtype == torch.float32:
        return out
    for k, v in params.items():
        if _DENSE.search(k) and v.dtype == torch.float32:
            dt = (cfg.logits_dtype if k.startswith('output_layer.linear.')
                  else cfg.compute_dtype)
            out[k] = v.to(dt)
    return out


def cond_terms(cfg: DITConfig, params, cond: torch.Tensor):
    """The adaLN terms of class `cond` (B,): each block's (shift, 1 + scale,
    gate) before attention and before the MLP, and the head's (shift,
    1 + scale), in the compute dtype; None without adaLN. They do not
    depend on the position, so a decode loop computes them once (the
    same roundings as forming them every step)."""
    if not cfg.use_adaLN:
        return None
    emb = params['cond_map.embedding_table.weight'][cond.long()]
    c = F.silu(emb).to(cfg.compute_dtype)
    blocks = []
    for i in range(cfg.n_blocks):
        sh1, sc1, g1, sh2, sc2, g2 = _dense(
            params, f'blocks.{i}.adaLN_modulation', c).chunk(6, -1)
        blocks.append((sh1, 1 + sc1, g1, sh2, 1 + sc2, g2))
    final = None
    if 'output_layer.adaLN_modulation.weight' in params:
        shift, scale = _dense(params, 'output_layer.adaLN_modulation',
                              c).chunk(2, -1)
        final = (shift, 1 + scale)
    return {'blocks': blocks, 'final': final}


def decode_step(cfg: DITConfig, params, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, pos: int,
                cond: Optional[torch.Tensor] = None, *,
                window: Optional[int] = None, terms=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One AR decode step: token (B,) at position `pos` (a Python int,
    0-based) -> (float32 logits (B, V), cache), the cache updated in place.
    The logits equal the full causal forward's at `pos`.

    window: an upper bound on pos + 1; attention reads only the first
    `window` cache rows. Rows in [pos + 1, window) are masked either way,
    so the result does not depend on it. terms: `cond_terms(cfg, params,
    cond)`, formed here from `cond` when not given."""
    W = cfg.length if window is None else min(window, cfg.length)
    if pos >= W:
        raise ValueError(f'position {pos} outside the window of {W} rows')
    B = token.shape[0]
    H = cfg.n_heads
    Dh = cfg.hidden_size // H
    cdt = cfg.compute_dtype
    if terms is None and cond is not None:
        terms = cond_terms(cfg, params, cond)
    x = F.embedding(token, params['vocab_embed.embedding']).to(cdt)
    cos, sin = _rope_at(pos, Dh, cfg.length, token.device)
    kv_int8 = 'k_s' in cache
    for i in range(cfg.n_blocks):
        p = f'blocks.{i}.'
        if terms is not None:
            sh1, sc1, g1, sh2, sc2, g2 = terms['blocks'][i]
        skip = x
        h = _layer_norm(params[p + 'norm1.weight'], x)
        if terms is not None:
            h = h * sc1 + sh1
        qkv = _dense(params, p + 'attn_qkv', h).view(B, 3, H, Dh)
        qk = _apply_rope_single(qkv[:, :2], cos, sin)       # (B, 2, H, Dh)
        if kv_int8:
            kvq, kvs = _quant_row(torch.stack([qk[:, 1], qkv[:, 2]], 1))
            cache['k'][i, :, :, pos] = kvq[:, 0]
            cache['v'][i, :, :, pos] = kvq[:, 1]
            cache['k_s'][i, :, :, pos] = kvs[:, 0]
            cache['v_s'][i, :, :, pos] = kvs[:, 1]
            k_win = cache['k'][i, :, :, :W].to(cdt)
            v_win = cache['v'][i, :, :, :W].to(cdt)
        else:
            cache['k'][i, :, :, pos] = qk[:, 1]
            cache['v'][i, :, :, pos] = qkv[:, 2]
            k_win = cache['k'][i, :, :, :W]
            v_win = cache['v'][i, :, :, :W]
        # (B H, 1, Dh) x (B H, Dh, W): float32 scores of the one query.
        s = _bmm_f32(qk[:, 0].reshape(B * H, 1, Dh),
                     k_win.reshape(B * H, W, Dh).transpose(1, 2))
        s = s.view(B, H, W)
        if kv_int8:
            s = s * cache['k_s'][i, :, :, :W]
        s = s / math.sqrt(Dh)
        s[..., pos + 1:] = NEG
        w = torch.softmax(s, dim=-1)
        if kv_int8:
            w = w * cache['v_s'][i, :, :, :W]
        attn = _bmm_f32(w.to(cdt).view(B * H, 1, W),
                        v_win.reshape(B * H, W, Dh))
        h = _dense(params, p + 'attn_out', attn.view(B, H * Dh).to(cdt))
        if terms is not None:
            h = g1 * h
        x = skip + h
        skip = x
        h = _layer_norm(params[p + 'norm2.weight'], x)
        if terms is not None:
            h = h * sc2 + sh2
        h = F.gelu(_dense(params, p + 'mlp.0', h), approximate='tanh')
        h = _dense(params, p + 'mlp.2', h)
        if terms is not None:
            h = g2 * h
        x = skip + h

    h = _layer_norm(params['output_layer.norm_final.weight'], x)
    if terms is not None and terms['final'] is not None:
        shift, scale = terms['final']
        h = h * scale + shift
    logits = _dense(params, 'output_layer.linear', h.to(cfg.logits_dtype))
    return logits.float(), cache
