"""Online-softmax flash attention over blocks of 128 keys: the port of
`jax.experimental.pallas.ops.tpu.flash_attention.flash_attention`, the
library kernel behind the DiT's `tpu_flash_attn` route, with its three
TPU kernels: the forward (K20, `_flash_attention_impl`), the dK/dV
backward (K21, `_flash_attention_bwd_dkv`) and the dQ backward (K22,
`_flash_attention_bwd_dq`), at the block sizes the DiT gets (128 for
every block).

The function differs from `ops.attention`'s K2 where bf16 rounds. For each
query row the forward walks the key blocks in order, keeping the running
max m and sum l: per block p = exp(s - m_next) in fp32, then the
accumulator is renormalised, acc = acc * (alpha l_prev / l_next) +
(bf16(p) @ v) / l_next, so the unnormalised p is what is rounded to v's
dtype. With one key block (L = 128) the library's single-step kernel
divides p by l before the rounding instead. The backward recomputes p =
exp(s - m) * (1 / l) from the saved l and m, and with di = sum(o * do)
(fp32; the library forms it outside its kernels, K21 forms it from o's
rows and hands it to K22) forms ds = (do v^T - di) * p * scale; K21 walks
the query rows of a key block in order for dv += bf16(p)^T do and dk +=
bf16(ds)^T q, K22 the key blocks of a query block for dq += bf16(ds) k.
Scores are the fp32 q k^T times sm_scale; under `causal`, blocks wholly
above the diagonal are skipped and the rest get -0.7 * float32 max added
where the key lies past the row.

Layout is the model's (B, L, H, D): q, k and v may each have their own
token stride (views into the fused qkv projection), as `ops.attention`
takes them; the library's (B, H, L, D) swap is layout only. l, m and di
are (B, H, L) float32. On CUDA tensors each wrapper launches its kernel of
`csrc/flash_attention.cu` or raises; `flash_plan` mirrors which (bf16
rows on 16-byte boundaries: D = 64 on wgmma, D a multiple of 16 up to
48 on `mma.sync`; everything else, every
head width the library takes up to D = 512, on the CUDA cores; each
wrapper's `tensor_core_launches` counts the first two, `wgmma_launches`
the first). On CPU tensors the plain versions below run. Shapes the
library refuses raise here too, with its exception types.
"""

from __future__ import annotations

import ctypes

import torch

from ddg_tpu_torch.ops import _build

BLOCK = 128                      # every block size the DiT's call gets
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
D_MAX = 512                      # the widest head the kernels take
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shape(L: int, D: int) -> None:
    """Raise where the library refuses (B, H, L, D) at 128-blocks:
    ValueError for L under 128 or not a multiple of it, NotImplementedError
    for D over 128 that is not a multiple of 128 when there is more than
    one key block (its multi-step kernel)."""
    if L < BLOCK:
        raise ValueError(f'block_q={BLOCK} should be smaller or equal to '
                         f'q_seq_len={L}')
    if L % BLOCK:
        raise ValueError(f'kv_seq_len={L} should be divisible by '
                         f'block_k_major={BLOCK}')
    if L > BLOCK and D > BLOCK and D % BLOCK:
        raise NotImplementedError(f'head_dim={D} should be a multiple of '
                                  f'{BLOCK} if larger')


def _heads(t):
    """(B, L, H, D) -> (B, H, L, D) float32."""
    return t.transpose(1, 2).float()


def _block_scores(qr, kc, r, c, causal, sm_scale):
    """fp32 scores of query block r against key block c, (B, H, 128,
    128), scaled, with the mask value added past the diagonal."""
    s = (qr @ kc.transpose(-1, -2)) * sm_scale
    if causal and c == r:
        i = torch.arange(BLOCK, device=s.device)
        s = s + torch.where(i[None, :] <= i[:, None], 0.0, MASK_VALUE)
    return s


def _blocks(L, r, causal):
    """The key blocks query block r visits, in order."""
    return range(r + 1 if causal else L // BLOCK)


def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              sm_scale: float = 1.0):
    """The plain PyTorch version of K20: (o, l, m), o (B, L, H, D) in q's
    dtype, l and m (B, H, L) float32."""
    B, L, H, D = q.shape
    check_shape(L, D)
    dt = v.dtype
    qh, kh, vh = _heads(q), _heads(k), _heads(v)
    o = torch.empty((B, H, L, D), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    for r in range(L // BLOCK):
        rows = slice(r * BLOCK, (r + 1) * BLOCK)
        if L == BLOCK:      # the single-step kernel: normalise, then round
            s = _block_scores(qh, kh, 0, 0, causal, sm_scale)
            mr = s.amax(-1, keepdim=True)
            p = torch.exp(s - mr)
            lr = p.sum(-1, keepdim=True)
            o[:, :, rows] = (p / lr).to(dt).float() @ vh
            l[:, :, rows], m[:, :, rows] = lr[..., 0], mr[..., 0]
            continue
        acc = torch.zeros((B, H, BLOCK, D), dtype=torch.float32,
                          device=q.device)
        m_prev = torch.full((B, H, BLOCK, 1), float('-inf'),
                            device=q.device)
        l_prev = torch.zeros((B, H, BLOCK, 1), device=q.device)
        for c in _blocks(L, r, causal):
            keys = slice(c * BLOCK, (c + 1) * BLOCK)
            s = _block_scores(qh[:, :, rows], kh[:, :, keys], r, c, causal,
                              sm_scale)
            m_next = torch.maximum(m_prev, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next)
            l_corr = torch.exp(m_prev - m_next) * l_prev
            l_next = p.sum(-1, keepdim=True) + l_corr
            inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            acc = acc * (l_corr * inv)
            acc = acc + (p.to(dt).float() @ vh[:, :, keys]) * inv
            m_prev, l_prev = m_next, l_next
        o[:, :, rows] = acc
        l[:, :, rows], m[:, :, rows] = l_prev[..., 0], m_prev[..., 0]
    return o.transpose(1, 2).to(q.dtype).contiguous(), l, m


def _block_grads(qh, kh, vh, doh, l, m, di, r, c, causal, sm_scale):
    """p and ds of query block r against key block c, (B, H, 128, 128)
    fp32, as both backward kernels form them."""
    rows = slice(r * BLOCK, (r + 1) * BLOCK)
    keys = slice(c * BLOCK, (c + 1) * BLOCK)
    s = _block_scores(qh[:, :, rows], kh[:, :, keys], r, c, causal,
                      sm_scale)
    p = torch.exp(s - m[:, :, rows, None]) * (1.0 / l[:, :, rows, None])
    dp = doh[:, :, rows] @ vh[:, :, keys].transpose(-1, -2)
    ds = (dp - di[:, :, rows, None]) * p * sm_scale
    return p, ds


def flash_attention_bwd_dkv_plain(q, k, v, l, m, do, o, *,
                                  causal: bool = False,
                                  sm_scale: float = 1.0):
    """The plain PyTorch version of K21: (dk, dv, di), dk and dv in k's and
    v's dtypes, di = sum(o * do) (B, H, L) float32 (`output_grad_dot`), from
    the forward's l and m (B, H, L) float32 and its output o."""
    B, L, H, D = q.shape
    check_shape(L, D)
    di = output_grad_dot(o, do)
    n = L // BLOCK
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    dk = torch.empty((B, H, L, D), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for c in range(n):
        dk_acc = torch.zeros((B, H, BLOCK, D), device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for r in range(c if causal else 0, n):
            rows = slice(r * BLOCK, (r + 1) * BLOCK)
            p, ds = _block_grads(qh, kh, vh, doh, l, m, di, r, c, causal,
                                 sm_scale)
            dv_acc = dv_acc + (p.transpose(-1, -2).to(do.dtype).float()
                               @ doh[:, :, rows])
            dk_acc = dk_acc + (ds.transpose(-1, -2).to(do.dtype).float()
                               @ qh[:, :, rows])
        dk[:, :, c * BLOCK:(c + 1) * BLOCK] = dk_acc
        dv[:, :, c * BLOCK:(c + 1) * BLOCK] = dv_acc
    return (dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous(), di)


def flash_attention_bwd_dq_plain(q, k, v, l, m, do, di, *,
                                 causal: bool = False,
                                 sm_scale: float = 1.0):
    """The plain PyTorch version of K22: dq in q's dtype."""
    B, L, H, D = q.shape
    check_shape(L, D)
    qh, kh, vh, doh = _heads(q), _heads(k), _heads(v), _heads(do)
    dq = torch.empty((B, H, L, D), dtype=torch.float32, device=q.device)
    for r in range(L // BLOCK):
        acc = torch.zeros((B, H, BLOCK, D), device=q.device)
        for c in _blocks(L, r, causal):
            _, ds = _block_grads(qh, kh, vh, doh, l, m, di, r, c, causal,
                                 sm_scale)
            acc = acc + (ds.to(k.dtype).float()
                         @ kh[:, :, c * BLOCK:(c + 1) * BLOCK])
        dq[:, :, r * BLOCK:(r + 1) * BLOCK] = acc
    return dq.transpose(1, 2).to(q.dtype).contiguous()


# The kernels' tiles and shared memory (csrc/flash_attention.cu).
_TILE = 64 * 64 * 2              # one 64 x 64 bf16 tile in the 128-byte swizzle
_SMEM_MAX = 232448
PATHS = {2: 'wgmma', 1: 'mma.sync', 0: 'CUDA cores'}


def _launch(path, tile, step, stages, smem, threads, grid):
    return dict(path=path, tile=tile, step=step, stages=stages, smem=smem,
                threads=threads, grid=grid)


def flash_plan(B, L, H, D, dtype, aligned=True):
    """What K20, K21 and K22 launch for a (B, L, H, D) call of `dtype`
    whose rows start on 16-byte boundaries (`aligned`) or not: a dict of
    'fwd', 'dkv' and 'dq', each with path (2: wgmma, 1: mma.sync, 0: the
    CUDA cores; PATHS names them), tile (the query rows, or K21's keys, a
    block owns), step (the keys, or K21's query rows, it takes a step),
    stages (of the cp.async ring; 1: staged synchronously), smem (dynamic
    shared bytes), threads and grid. The mirror of the C library's
    `ddg_flash_attention_plan`; raises where the library refuses the shape
    (its exception types) and ValueError where no kernel takes it."""
    check_shape(L, D)
    if (D <= 0 or D > D_MAX or min(B, H) <= 0 or max(B, H) > 65535
            or dtype not in _DTYPES):
        raise ValueError(f'no flash attention kernel takes B={B}, L={L}, '
                         f'H={H}, D={D}, {dtype}: head_dim up to {D_MAX}')
    mma = dtype == torch.bfloat16 and aligned and D % 16 == 0 and D <= 64
    pad = (D + 8) * 2               # a bf16 row padded by 16 bytes
    own = 32 if D <= 256 else 16    # CUDA-core rows or keys a block
    if mma and D == 64:
        # One warpgroup of 64 query rows, its Q tile and a two-stage ring
        # of 128-key blocks (K and V: four tiles).
        fwd = _launch(2, 64, 128, 2, _TILE + 2 * 4 * _TILE, 128,
                      (L // 64, H, B))
        # One warpgroup of 64 keys, its K and V tiles and a two-stage ring
        # of (Q, dO, O tiles and 1 KB of the rows' m, l, di).
        dkv = _launch(2, 64, 64, 2, 2 * _TILE + 2 * (3 * _TILE + 1024),
                      128, (L // 64, H, B))
    elif mma:
        fwd = _launch(1, 128, 128, 2, 4 * 128 * pad, 256, (L // 128, H, B))
        dkv = _launch(1, 128, 64, 2, 2 * (2 * 64 * pad + 3 * 64 * 4), 256,
                      (L // 128, H, B))
    else:
        fwd = _launch(0, 32, 32, 1, 4 * (2 * 32 * (D + 1) + 32 * 128), 256,
                      (L // 32, H, B))
        dkv = _launch(0, own, 32, 1, 4 * (2 * own * (D + 1) + 2 * 32 * (D + 1)
                                          + 2 * own * 33 + 3 * 32),
                      256, (L // own, H, B))
    if mma and D == 64:
        # One warpgroup of 64 query rows, its Q and dO tiles and a
        # three-stage ring of 64-key (K, V) tile pairs.
        dq = _launch(2, 64, 64, 3, 2 * _TILE + 3 * 2 * _TILE, 128,
                     (L // 64, H, B))
    elif mma:
        dq = _launch(1, 128, 64, 2, 4 * 64 * pad, 256, (L // 128, H, B))
    else:
        dq = _launch(0, own, 32, 1, 4 * (2 * own * (D + 1) + 2 * 32 * (D + 1)
                                         + own * 33),
                     256, (L // own, H, B))
    plan = dict(fwd=fwd, dkv=dkv, dq=dq)
    if max(lp['smem'] for lp in plan.values()) > _SMEM_MAX:
        raise ValueError(f'no flash attention kernel fits D={D} in shared '
                         f'memory')
    return plan


def _check(q, k, v, *stats, rows=()):
    """Raise unless q, k, v (B, L, H, D), the contiguous (B, L, H, D)
    `rows` of q's dtype and the (B, H, L) fp32 `stats` are what the kernels
    take; returns q's, k's and v's token strides."""
    B, L, H, D = q.shape
    _build.require_cuda(q, k, v, *rows, *stats, contiguous=False)
    if (k.shape != q.shape or v.shape != q.shape or q.dtype not in _DTYPES
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError('q, k, v must share a float32/bfloat16 dtype and '
                         'a (B, L, H, D) shape')
    check_shape(L, D)
    if D > D_MAX or max(B, H) > 65535:
        raise ValueError(f'the flash attention kernels take head_dim up to '
                         f'{D_MAX} and B, H up to 65535, got D={D}')
    strides = tuple(t.stride(1) for t in (q, k, v))
    if any(t.stride() != (L * ts, ts, D, 1) for t, ts in zip((q, k, v),
                                                             strides)):
        raise ValueError('q, k, v must be (B, L, H, D) with dense heads')
    for t in rows:
        if (t.shape != q.shape or t.dtype != q.dtype
                or not t.is_contiguous()):
            raise ValueError(f'o and do must be contiguous {q.dtype} of '
                             f'shape {tuple(q.shape)}')
    for t in stats:
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, L)
                or not t.is_contiguous()):
            raise ValueError(f'l, m, di must be contiguous float32 of shape '
                             f'{(B, H, L)}')
    return strides


def _count(wrapper, path, rc, name):
    _build.check(rc, name)
    wrapper.launches += 1
    wrapper.tensor_core_launches += path.value >= 1
    wrapper.wgmma_launches += path.value == 2


def _call(name, ins, outs, shape, strides, causal, sm_scale, dtype, q):
    """One launch of the C entry point `name` on the pointers of `ins` then
    `outs`; returns the path it took."""
    B, L, H, D = shape
    fn = _build.kernel('flash_attention', name,
                       (_build.ptr,) * (len(ins) + len(outs))
                       + (_build.i32,) * 8
                       + (_build.f32, _build.i32, _build.ptr, _build.i32p))
    path = ctypes.c_int(-1)
    rc = fn(*(t.data_ptr() for t in (*ins, *outs)), B, L, H, D, *strides,
            int(causal), sm_scale, _DTYPES[dtype], _build.stream(q),
            ctypes.byref(path))
    return path, rc


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        sm_scale: float = 1.0):
    """K20: (o, l, m) of q, k, v (B, L, H, D); o contiguous in q's dtype,
    l and m (B, H, L) float32, saved for the backward."""
    if q.device.type == 'cpu':
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         sm_scale=sm_scale)
    B, L, H, D = q.shape
    strides = _check(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    l = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    path, rc = _call('ddg_flash_attention_fwd', (q, k, v), (o, l, m),
                     q.shape, strides, causal, sm_scale, q.dtype, q)
    _count(flash_attention_fwd, path, rc, 'ddg_flash_attention_fwd')
    return o, l, m


def flash_attention_bwd_dkv(q, k, v, l, m, do, o, *, causal: bool = False,
                            sm_scale: float = 1.0):
    """K21: (dk, dv, di), dk and dv contiguous (B, L, H, D), di = sum(o *
    do) (B, H, L) float32 for K22, from the forward's l, m and output o
    and the output gradient do (both contiguous (B, L, H, D) in q's
    dtype)."""
    if q.device.type == 'cpu':
        return flash_attention_bwd_dkv_plain(q, k, v, l, m, do, o,
                                             causal=causal,
                                             sm_scale=sm_scale)
    B, L, H, D = q.shape
    strides = _check(q, k, v, l, m, rows=(do, o))
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    di = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    path, rc = _call('ddg_flash_attention_bwd_dkv', (q, k, v, l, m, do, o),
                     (dk, dv, di), q.shape, strides, causal, sm_scale,
                     q.dtype, q)
    _count(flash_attention_bwd_dkv, path, rc, 'ddg_flash_attention_bwd_dkv')
    return dk, dv, di


def flash_attention_bwd_dq(q, k, v, l, m, do, di, *, causal: bool = False,
                           sm_scale: float = 1.0):
    """K22: dq, contiguous (B, L, H, D), from the forward's l, m, the
    output gradient do (contiguous, q's dtype) and K21's di."""
    if q.device.type == 'cpu':
        return flash_attention_bwd_dq_plain(q, k, v, l, m, do, di,
                                            causal=causal, sm_scale=sm_scale)
    strides = _check(q, k, v, l, m, di, rows=(do,))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    path, rc = _call('ddg_flash_attention_bwd_dq', (q, k, v, l, m, do, di),
                     (dq,), q.shape, strides, causal, sm_scale, q.dtype, q)
    _count(flash_attention_bwd_dq, path, rc, 'ddg_flash_attention_bwd_dq')
    return dq


for _fn in (flash_attention_fwd, flash_attention_bwd_dkv,
            flash_attention_bwd_dq):
    _fn.launches = 0
    _fn.tensor_core_launches = 0
    _fn.wgmma_launches = 0


def output_grad_dot(o, do):
    """di = sum(o * do) over D in fp32, (B, H, L): the library's glue
    between its forward and its backward kernels, here the plain K21's
    (on the card K21 forms it; `calls` counts the calls)."""
    output_grad_dot.calls += 1
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


output_grad_dot.calls = 0


class _FlashAttention(torch.autograd.Function):
    """K20 with K21 (which forms di) and K22 as its backward; saves q, k,
    v, o, l and m."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, l, m = flash_attention_fwd(q, k, v, causal=causal,
                                      sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dk, dv, di = flash_attention_bwd_dkv(q, k, v, l, m, do, o, **kw)
        dq = flash_attention_bwd_dq(q, k, v, l, m, do, di, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, sm_scale: float = 1.0):
    """softmax(q k^T sm_scale) v in the library's block order (K20),
    differentiable in q, k, v (K21, K22). q, k, v: (B, L, H, D) with dense
    heads, each with its own token stride. Returns a contiguous (B, L, H,
    D). Without gradients the forward runs as it is, outside autograd."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, sm_scale)
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]
