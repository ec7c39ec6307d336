"""Softmax attention for the DiT's sequences (ports of
`ddg_tpu/ops/attention_pallas.py`: `fused_rope_attention`, K1, and
`short_seq_attention`, K2, forward and backward).

On CUDA tensors one launch of `csrc/rope_attention.cu` computes
softmax(q k^T / sqrt(D)) with fp32 scores, rounds the probabilities to v's
dtype and accumulates P V in fp32; K1 first rotates q and k (rotate-half
RoPE in fp32, rounded back to the input dtype) inside the kernel, K2 takes
them as they are (the DiT rotates them before it, as `ddg_tpu` does). Both
forward kernels walk the keys in tiles of 64, in two passes (the row max
and sum, then the normalised P), and take any L: the products run on
tensor cores (`wgmma`) for bf16 with D = 64 and rows on 16-byte
boundaries, on CUDA cores otherwise (the source picks and reports which:
each wrapper's `tensor_core_launches` counts the former; `forward_plan`
mirrors the launch plan). The backward saves
only q, k and v, as `_rope_flash_fwd` and `_flash_fwd` do, and recomputes
the probabilities in two launches of `csrc/rope_attention_bwd.cu` (a
query-tile kernel for dq and each row's softmax statistics and delta, then
a key-tile kernel for dk and dv; K1b on the tensor cores also rotates q
and k in a pass before them and un-rotates dq and dk in one after),
rounding where the VJP of
`_rope_reference` or `_reference` rounds, at any L: tensor cores for bf16
with D = 64 and rows on 16-byte boundaries, CUDA cores otherwise (counted
the same way, one call each; `backward_plan` mirrors the launch plan). On
CPU tensors the plain versions below run instead.
Layout is the model's (B, L, H, D), as in `ddg_tpu`; q, k and v may each
have their own token stride (views into the fused qkv projection).
"""

from __future__ import annotations

import ctypes

import torch

from ddg_tpu_torch.ops import _build

NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels' tiles and shared memory (csrc/rope_attention.cu,
# csrc/rope_attention_bwd.cu).
_KEY_TILE = 64
_SMEM_MAX = 232448
_CORE_D_MAX = 290               # the CUDA-core forward's widest head: both take it


def forward_plan(B, L, H, D, dtype, aligned=True):
    """What a K1 or K2 forward launches for a (B, L, H, D) call of `dtype`
    whose rows start on 16-byte boundaries (`aligned`) or not: a dict of
    path (1: the bf16 tensor-core kernel, 0: the CUDA-core one), q_tile,
    k_tile, stages (of the cp.async ring; 1: staged synchronously), smem
    (dynamic shared bytes), threads and grid. The mirror of the C
    library's `ddg_attention_fwd_plan`; raises ValueError where no kernel
    takes the shape."""
    if (D <= 0 or D % 2 or min(B, L, H) <= 0 or max(B, H) > 65535
            or dtype not in _DTYPES):
        raise ValueError(f'no attention kernel takes B={B}, L={L}, H={H}, '
                         f'D={D}, {dtype}')
    if dtype == torch.bfloat16 and D == 64 and aligned:
        # Two warpgroups a 128-row query tile: 64 x 64 bf16 tiles of Q (one
        # a warpgroup), four K slots (every K tile up to L = 256) and a
        # two-stage V ring.
        plan = dict(path=1, q_tile=128, k_tile=_KEY_TILE, stages=2,
                    smem=64 * 64 * 2 * (2 + 4 + 2), threads=256)
    else:
        # fp32: the Q tile, one key tile of K (rows padded by one) and V,
        # the 32 x 64 scores and the 32-row O sums.
        smem = 4 * (32 * D + _KEY_TILE * (D + 1) + _KEY_TILE * D
                    + 32 * _KEY_TILE + 32 * D)
        if smem > _SMEM_MAX:
            raise ValueError(f'the CUDA-core attention kernel takes head_dim '
                             f'up to 290, got {D}')
        plan = dict(path=0, q_tile=32, k_tile=_KEY_TILE, stages=1,
                    smem=smem, threads=256)
    plan['grid'] = (-(-L // plan['q_tile']), H, B)
    return plan


def _launch(q_tile, k_tile, stages, smem, threads, grid):
    return dict(q_tile=q_tile, k_tile=k_tile, stages=stages, smem=smem,
                threads=threads, grid=grid)


def backward_plan(B, L, H, D, dtype, aligned=True):
    """What a K1b or K2b backward launches for a (B, L, H, D) call of
    `dtype` whose rows start on 16-byte boundaries (`aligned`) or not: a
    dict of path (1: the bf16 tensor-core kernels, 0: the CUDA-core ones),
    stats_len (the row length of the (B, H, 3, stats_len) fp32 workspace
    that carries each query row's softmax statistics and delta from the
    first launch to the second: L rounded up to 64), and for each launch,
    'q' (query-tile parallel: dq) and 'kv' (key-tile parallel: dk, dv),
    its q_tile, k_tile, stages (of the cp.async ring; 1: staged
    synchronously), smem (dynamic shared bytes), threads and grid; 'rope'
    is the threads and grid of the launches that, in a K1b call on the
    tensor cores, rotate q and k before them and un-rotate dq and dk after
    (None on the CUDA cores, which rotate as they stage). The mirror of
    the C library's `ddg_attention_bwd_plan`; raises ValueError where no
    kernel takes the shape."""
    if (D <= 0 or D % 2 or min(B, L, H) <= 0 or max(B, H) > 65535
            or dtype not in _DTYPES):
        raise ValueError(f'no attention backward kernel takes B={B}, L={L}, '
                         f'H={H}, D={D}, {dtype}')
    tile = 64 * 64 * 2              # one 64 x 64 bf16 tile
    if dtype == torch.bfloat16 and D == 64 and aligned:
        # Two warpgroups a block of 128 query rows (Q: two Q and two dO
        # tiles, four K and four V slots) or 128 keys (KV: two K and two V
        # tiles, a two-stage ring of a Q tile, a dO tile and 1 KB of
        # workspace rows).
        g = -(-L // 128)
        plan = dict(path=1,
                    q=_launch(128, _KEY_TILE, 2, tile * 12, 256, (g, H, B)),
                    kv=_launch(64, 128, 2, tile * 4 + 2 * (2 * tile + 1024),
                               256, (g, H, B)),
                    rope=dict(threads=256,
                              grid=(-(-B * L * H * 4 // 256), 2, 1)))
    else:
        # fp32 on qt-row query tiles and kt-key tiles: q', dO, the dq sums,
        # k', v (rows padded by one), S and dP (Q); k', v, q', dO (rows
        # padded by one), P^T, the tile's statistics, the dk and dv sums
        # (KV). 32 and 64 while they fit (D <= 174), else 16 and 32, up to
        # the CUDA-core forward's widest head.
        if D > _CORE_D_MAX:
            raise ValueError(f'the CUDA-core attention backward takes '
                             f'head_dim up to {_CORE_D_MAX}, as the '
                             f'forward does, got {D}')

        def smem(qt, kt):
            return (4 * (3 * qt * D + 2 * kt * (D + 1) + 2 * qt * kt),
                    4 * (2 * kt * (D + 1) + 2 * qt * (D + 1) + kt * (qt + 1)
                         + 3 * qt + 2 * kt * D))
        qt = 32 if max(smem(32, 64)) <= _SMEM_MAX else 16
        kt = 2 * qt
        q_smem, kv_smem = smem(qt, kt)
        plan = dict(path=0,
                    q=_launch(qt, kt, 1, q_smem, 256, (-(-L // qt), H, B)),
                    kv=_launch(qt, kt, 1, kv_smem, 256, (-(-L // kt), H, B)),
                    rope=None)
    plan['stats_len'] = -(-L // _KEY_TILE) * _KEY_TILE
    return plan


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


def _masked_scores(q32, k32, causal):
    scale = 1.0 / (q32.shape[-1] ** 0.5)
    s = torch.einsum('bqhd,bkhd->bhqk', q32, k32) * scale
    if causal:
        L = s.shape[-1]
        keep = torch.ones((L, L), dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG))
    return s


def attention_plain(q, k, v, *, causal: bool = False):
    """softmax(q k^T / sqrt(D)) v on (B, L, H, D) with fp32 scores and the
    probabilities cast to v's dtype before the product: the plain version
    of `short_seq_attention`."""
    p = torch.softmax(_masked_scores(q.float(), k.float(), causal), dim=-1)
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


def short_seq_attention_bwd_plain(q, k, v, do, *, causal: bool = False):
    """Plain PyTorch version of `short_seq_attention_bwd`: the VJP of
    `attention_plain` written out, with the rounding points of `jax.vjp`
    through `_reference`. Products of input-dtype operands accumulate in
    fp32 and round once."""
    dt = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    q32, k32 = q.float(), k.float()
    do = do.to(dt).float()
    p = torch.softmax(_masked_scores(q32, k32, causal), dim=-1)
    dv = torch.einsum('bhqk,bqhd->bkhd', p.to(dt).float(), do).to(dt)
    dp = torch.einsum('bqhd,bkhd->bhqk', do, v.float()).to(dt).float()
    ds = (p * dp - p * (p * dp).sum(-1, keepdim=True)) * scale
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, k32).to(dt)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, q32).to(dt)
    return dq, dk, dv


def fused_rope_attention_bwd_plain(q, k, v, cos, sin, do, *,
                                   causal: bool = False):
    """Plain PyTorch version of `fused_rope_attention_bwd`: the VJP of
    `fused_rope_attention_plain` written out, with the rounding points of
    `jax.vjp` through `_rope_reference`."""
    dq, dk, dv = short_seq_attention_bwd_plain(
        apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, do,
        causal=causal)
    return unrotate(dq, cos, sin), unrotate(dk, cos, sin), dv


class _Attention(torch.autograd.Function):
    """K1 (cos, sin given) or K2 (cos = sin = None) with its backward."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, causal):
        ctx.save_for_backward(q, k, v)
        ctx.rope, ctx.causal = (cos, sin), causal
        return _forward(q, k, v, cos, sin, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        cos, sin = ctx.rope
        if cos is None:
            grads = short_seq_attention_bwd(q, k, v, do, causal=ctx.causal)
        else:
            grads = fused_rope_attention_bwd(q, k, v, cos, sin, do,
                                             causal=ctx.causal)
        return (*grads, None, None, None)


def _attend(q, k, v, cos, sin, causal):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, cos, sin, causal)
    return _forward(q, k, v, cos, sin, causal)


def fused_rope_attention(q, k, v, cos, sin, *, causal: bool = False):
    """RoPE(q), RoPE(k) and softmax attention (K1), differentiable in q,
    k, v. q, k, v: (B, L, H, D) with dense heads, each with its own token
    stride; cos, sin: (L, D/2) float32. Returns a contiguous (B, L, H, D).
    Without gradients (sampling) the forward runs as it is, outside
    autograd."""
    return _attend(q, k, v, cos, sin, causal)


def short_seq_attention(q, k, v, *, causal: bool = False):
    """softmax(q k^T / sqrt(D)) v (K2), differentiable in q, k, v: the
    port of `ddg_tpu`'s `short_seq_attention`, whose caller rotates q and
    k. Shapes and strides as `fused_rope_attention`."""
    return _attend(q, k, v, None, None, causal)


def _check(q, k, v, cos, sin):
    """Raise unless q, k, v (and cos, sin for K1) are what the kernels
    take; returns the token strides of q, k and v."""
    B, L, H, D = q.shape
    tables = () if cos is None else (cos, sin)
    _build.require_cuda(q, k, v, *tables, contiguous=False)
    if (k.shape != q.shape or v.shape != q.shape or D % 2
            or q.dtype not in _DTYPES or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError('q, k, v must share a float32/bfloat16 dtype and a '
                         '(B, L, H, D) shape with even D')
    strides = tuple(t.stride(1) for t in (q, k, v))
    if any(t.stride() != (L * ts, ts, D, 1) for t, ts in zip((q, k, v),
                                                             strides)):
        raise ValueError('q, k, v must be (B, L, H, D) with dense heads')
    if cos is not None and (
            cos.dtype != torch.float32 or sin.dtype != torch.float32
            or tuple(cos.shape) != (L, D // 2) or sin.shape != cos.shape
            or not cos.is_contiguous() or not sin.is_contiguous()):
        raise ValueError(f'cos, sin must be contiguous float32 of shape '
                         f'({L}, {D // 2})')
    return strides


def _forward(q, k, v, cos, sin, causal):
    rope = cos is not None
    if q.device.type == 'cpu':
        if rope:
            return fused_rope_attention_plain(q, k, v, cos, sin,
                                              causal=causal)
        return attention_plain(q, k, v, causal=causal)
    B, L, H, D = q.shape
    strides = _check(q, k, v, cos, sin)
    forward_plan(B, L, H, D, q.dtype, aligned=False)  # raises where no kernel takes it
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    wrapper = fused_rope_attention if rope else short_seq_attention
    name = 'ddg_rope_attention' if rope else 'ddg_short_seq_attention'
    tables = (cos.data_ptr(), sin.data_ptr()) if rope else ()
    fn = _build.kernel('rope_attention', name,
                       (_build.ptr,) * (4 + len(tables)) + (_build.i32,) * 8
                       + (_build.f32, _build.i32, _build.ptr, _build.i32p))
    path = ctypes.c_int(-1)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *tables, o.data_ptr(),
            B, L, H, D, *strides, int(causal), 1.0 / (D ** 0.5),
            _DTYPES[q.dtype], _build.stream(q), ctypes.byref(path))
    wrapper.launches += 1
    wrapper.tensor_core_launches += path.value == 1
    _build.check(rc, name)
    return o


fused_rope_attention.launches = 0
fused_rope_attention.tensor_core_launches = 0
short_seq_attention.launches = 0
short_seq_attention.tensor_core_launches = 0


def _backward(q, k, v, cos, sin, do, causal):
    """One call of the backward kernels (two launches, four for K1b on the
    tensor cores): (dq, dk, dv)."""
    rope = cos is not None
    B, L, H, D = q.shape
    strides = _check(q, k, v, cos, sin)
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f'do must have the shape {tuple(q.shape)}')
    # Raises where no kernel takes the shape (the CUDA-core plan is the
    # narrower); the aligned plan says what the workspaces hold.
    backward_plan(B, L, H, D, q.dtype, aligned=False)
    plan = backward_plan(B, L, H, D, q.dtype)
    do = do.to(q.dtype).contiguous()
    _build.require_cuda(q, do, contiguous=False)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    stats = torch.empty((B, H, 3, plan['stats_len']), dtype=torch.float32,
                        device=q.device)
    wrapper = fused_rope_attention_bwd if rope else short_seq_attention_bwd
    name = 'ddg_rope_attention_bwd' if rope else 'ddg_short_seq_attention_bwd'
    tables = (cos.data_ptr(), sin.data_ptr()) if rope else ()
    # K1b's rotated q and k for the tensor-core kernels (read only there).
    rot = (torch.empty((2, *q.shape), dtype=q.dtype, device=q.device)
           if rope and plan['rope'] is not None else None)
    ws = (stats.data_ptr(),) + ((None if rot is None else rot.data_ptr(),)
                                if rope else ())
    fn = _build.kernel('rope_attention_bwd', name,
                       (_build.ptr,) * (7 + len(tables) + len(ws))
                       + (_build.i32,) * 8
                       + (_build.f32, _build.i32, _build.ptr, _build.i32p))
    path = ctypes.c_int(-1)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *tables, do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *ws, B, L, H, D,
            *strides, int(causal), 1.0 / (D ** 0.5),
            _DTYPES[q.dtype], _build.stream(q), ctypes.byref(path))
    wrapper.launches += 1
    wrapper.tensor_core_launches += path.value == 1
    _build.check(rc, name)
    return dq, dk, dv


def fused_rope_attention_bwd(q, k, v, cos, sin, do, *, causal: bool = False):
    """(dq, dk, dv) of `fused_rope_attention` for the output gradient do,
    recomputed from q, k, v. On CUDA tensors one call of the K1b kernels
    (two launches) at any L; shapes no kernel takes raise."""
    if q.device.type == 'cpu':
        return fused_rope_attention_bwd_plain(q, k, v, cos, sin, do,
                                              causal=causal)
    return _backward(q, k, v, cos, sin, do, causal)


def short_seq_attention_bwd(q, k, v, do, *, causal: bool = False):
    """(dq, dk, dv) of `short_seq_attention`, recomputed from q, k, v. On
    CUDA tensors one call of K2's backward kernels (two launches) at any
    L; shapes no kernel takes raise."""
    if q.device.type == 'cpu':
        return short_seq_attention_bwd_plain(q, k, v, do, causal=causal)
    return _backward(q, k, v, None, None, do, causal)


fused_rope_attention_bwd.launches = 0
fused_rope_attention_bwd.tensor_core_launches = 0
short_seq_attention_bwd.launches = 0
short_seq_attention_bwd.tensor_core_launches = 0
