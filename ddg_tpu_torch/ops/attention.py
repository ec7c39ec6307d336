"""RoPE + softmax attention for the DiT's short sequences (port of
`ddg_tpu/ops/attention_pallas.py:fused_rope_attention`, forward and
backward).

On CUDA tensors one launch of `csrc/rope_attention.cu` rotates q and k
(rotate-half RoPE in fp32, rounded back to the input dtype), computes
softmax(q' k'^T / sqrt(D)) with fp32 scores, rounds the probabilities to
v's dtype and accumulates P V in fp32: on tensor cores for bf16 with
D = 64 and L <= 128 (the DiT's shapes), on CUDA cores otherwise (the
source picks). The backward saves only q, k and v, as `_rope_flash_fwd`
does, and recomputes the probabilities in one launch of
`csrc/rope_attention_bwd.cu` (D = 64 and L <= 128 only), rounding where
the VJP of `_rope_reference` rounds. On CPU tensors the plain versions
below run instead. Layout is the model's (B, L, H, D), as in `ddg_tpu`.
"""

from __future__ import annotations

import torch

from ddg_tpu_torch.ops import _build

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def apply_rope(x, cos, sin):
    """Rotate (B, L, H, D) q or k by rotate-half RoPE in fp32:
    (x1 c - x2 s, x2 c + x1 s), cast back to x's dtype. cos, sin:
    (L, D/2) float32."""
    d2 = x.shape[-1] // 2
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


def attention_plain(q, k, v, *, causal: bool = False):
    """softmax(q k^T / sqrt(D)) v on (B, L, H, D) with fp32 scores and the
    probabilities cast to v's dtype before the product."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        L = s.shape[-1]
        keep = torch.ones((L, L), dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype), v).to(v.dtype)


def fused_rope_attention_plain(q, k, v, cos, sin, *, causal: bool = False):
    """Plain PyTorch version of `fused_rope_attention`."""
    return attention_plain(apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                           v, causal=causal)


def unrotate(g, cos, sin):
    """The transpose of `apply_rope` on a gradient, in fp32, cast back to
    g's dtype: (g1 c + g2 s, g2 c - g1 s)."""
    d2 = g.shape[-1] // 2
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    g1 = g[..., :d2].float()
    g2 = g[..., d2:].float()
    return torch.cat([g1 * c + g2 * s, g2 * c - g1 * s], -1).to(g.dtype)


def fused_rope_attention_bwd_plain(q, k, v, cos, sin, do, *,
                                   causal: bool = False):
    """Plain PyTorch version of `fused_rope_attention_bwd`: the VJP of
    `fused_rope_attention_plain` written out, with the rounding points of
    `jax.vjp` through `_rope_reference`. Products of input-dtype operands
    accumulate in fp32 and round once."""
    dt = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qr = apply_rope(q, cos, sin).float()
    kr = apply_rope(k, cos, sin).float()
    do = do.to(dt).float()
    s = torch.einsum('bqhd,bkhd->bhqk', qr, kr) * scale
    if causal:
        L = s.shape[-1]
        keep = torch.ones((L, L), dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum('bhqk,bqhd->bkhd', p.to(dt).float(), do).to(dt)
    dp = torch.einsum('bqhd,bkhd->bhqk', do, v.float()).to(dt).float()
    ds = (p * dp - p * (p * dp).sum(-1, keepdim=True)) * scale
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, kr).to(dt)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, qr).to(dt)
    return unrotate(dq, cos, sin), unrotate(dk, cos, sin), dv


class _RopeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cos, sin, causal):
        ctx.save_for_backward(q, k, v, cos, sin)
        ctx.causal = causal
        return _forward(q, k, v, cos, sin, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v, cos, sin = ctx.saved_tensors
        dq, dk, dv = fused_rope_attention_bwd(q, k, v, cos, sin, do,
                                              causal=ctx.causal)
        return dq, dk, dv, None, None, None


def fused_rope_attention(q, k, v, cos, sin, *, causal: bool = False):
    """RoPE(q), RoPE(k) and softmax attention, differentiable in q, k, v.
    q, k, v: (B, L, H, D), contiguous or views sharing one token stride
    (the q/k/v slices of the fused qkv projection); cos, sin: (L, D/2)
    float32. Returns a contiguous (B, L, H, D). Without gradients
    (sampling) the forward runs as it is, outside autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _RopeAttention.apply(q, k, v, cos, sin, causal)
    return _forward(q, k, v, cos, sin, causal)


def _check(q, k, v, cos, sin):
    """Raise unless q, k, v, cos, sin are what the kernels take; returns
    the token stride."""
    B, L, H, D = q.shape
    _build.require_cuda(cos, sin)
    _build.require_cuda(q, k, v, cos, contiguous=False)
    ts = q.stride(1)
    if any(t.stride() != (L * ts, ts, D, 1) for t in (q, k, v)):
        raise ValueError('q, k, v must be (B, L, H, D) with dense heads and '
                         'one token stride')
    if (k.shape != q.shape or v.shape != q.shape or D % 2
            or q.dtype not in _DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError('q, k, v must share a float32/bfloat16 dtype and a '
                         '(B, L, H, D) shape with even D')
    if (cos.dtype != torch.float32 or sin.dtype != torch.float32
            or tuple(cos.shape) != (L, D // 2) or sin.shape != cos.shape):
        raise ValueError(f'cos, sin must be float32 of shape ({L}, {D // 2})')
    return ts


def _forward(q, k, v, cos, sin, causal):
    if q.device.type == 'cpu':
        return fused_rope_attention_plain(q, k, v, cos, sin, causal=causal)
    B, L, H, D = q.shape
    ts = _check(q, k, v, cos, sin)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _build.kernel('rope_attention', 'ddg_rope_attention',
                       (_build.ptr,) * 6 + (_build.i32,) * 6
                       + (_build.f32, _build.i32, _build.ptr))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), o.data_ptr(), B, L, H, D, ts, int(causal),
            1.0 / (D ** 0.5), _DTYPES[q.dtype], _build.stream(q))
    fused_rope_attention.launches += 1
    _build.check(rc, 'ddg_rope_attention')
    return o


fused_rope_attention.launches = 0


def fused_rope_attention_bwd(q, k, v, cos, sin, do, *, causal: bool = False):
    """(dq, dk, dv) of `fused_rope_attention` for the output gradient do,
    recomputed from q, k, v. On CUDA tensors one kernel launch, for
    D = 64 and L <= 128; other shapes raise."""
    if q.device.type == 'cpu':
        return fused_rope_attention_bwd_plain(q, k, v, cos, sin, do,
                                              causal=causal)
    B, L, H, D = q.shape
    ts = _check(q, k, v, cos, sin)
    if D != 64 or L > 128:
        raise ValueError(
            f'the attention backward kernel takes head_dim 64 and L <= 128, '
            f'got head_dim {D}, L {L}: retiling it is queued in ROADMAP.md '
            '(section B)')
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f'do must have the shape {tuple(q.shape)}')
    do = do.to(q.dtype).contiguous()
    _build.require_cuda(q, do, contiguous=False)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    fn = _build.kernel('rope_attention_bwd', 'ddg_rope_attention_bwd',
                       (_build.ptr,) * 9 + (_build.i32,) * 5
                       + (_build.f32, _build.i32, _build.ptr))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, L, H, ts, int(causal), 1.0 / (D ** 0.5),
            _DTYPES[q.dtype], _build.stream(q))
    fused_rope_attention_bwd.launches += 1
    _build.check(rc, 'ddg_rope_attention_bwd')
    return dq, dk, dv


fused_rope_attention_bwd.launches = 0
