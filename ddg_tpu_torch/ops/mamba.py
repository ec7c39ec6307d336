"""The DiMamba kernels (port of `ddg_tpu/ops/selective_scan_pallas.py`'s
forward, K14, and `ddg_tpu/ops/mamba_block_pallas.py`'s forward, K18).

`ssm_scan` (K14) is the gated selective scan, in fp32:

    h_t = exp(delta_t A) h_{t-1} + (delta_t u_t) B_t     (h_{-1} = 0)
    y_t = (C_t . h_t + D u_t) * silu(z_t)

with A round-tripped as -exp(log(-A)), as the TPU call hands its kernel
log(-A); y is written in u's dtype. It also gives the entry state of each
chunk of `chunk` rows, h0s (B, n_chunks, N, d) float32.

`mamba_inner` (K18) is one direction of the fused Mamba block, with the
rounding points of the TPU kernel's `_recompute_front` (compute dtype cd):

    x, z  = (h @ W_in) rounded to cd                  (fp32 accumulation)
    xc    = ((x_{t-K+1} w_0 + x_{t-K+2} w_1) + ...) + b   every op in cd
    u     = xc silu'd in fp32, rounded to cd
    dt_lr, B, C = (u @ W_x) rounded to cd, then fp32
    delta = softplus(dt_lr @ W_dt + b_dt)             fp32 products
    y     = ssm_scan(u, delta, A, B, C, D, z), rounded to cd
    out   = (y @ W_out) rounded to cd

The arguments follow the JAX functions (`mamba_inner_pallas`,
`selective_scan_pallas`): weights in flax's (in, out) layout, A (d, N),
conv_w (K, 1, d). The TPU schedule knobs (`seg`, `scan_impl`, tiles,
`interpret`) have no counterpart. On CUDA tensors each call runs
`csrc/mamba.cu` (K18: in_proj, conv + x_proj + dt_proj, the three scan
passes and out_proj, six launches; K14: the three scan passes) and adds
one to the wrapper's `launches`; on CPU tensors the plain versions below
run instead. Inference only: the VJPs (K15, K19) come with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ddg_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# What the kernels hold in registers and shared memory.
_MAX_STATE = 16
_CONV_TAPS = 4                  # d_conv of every DiMamba configuration
_MAX_RANK = 32
_MAX_INNER = 1024


def softplus(x):
    """log(1 + exp(x)) as jax.nn.softplus forms it (logaddexp(x, 0))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def scan_chunks(u, delta, A, B, C, chunk: int):
    """The selective scan in fp32, chunk-parallel as the kernel runs it.

    u, delta: (Bt, L, d); A: (d, N); B, C: (Bt, L, N), all fp32. Pass 1
    runs every chunk from a zero state, keeping its end state and the
    product of its a_t; pass 2 chains those into each chunk's entry
    state; pass 3 reruns each chunk from its entry state and reads it out
    through C. Rows past L (the last chunk's padding) have delta = 0:
    a = 1, b = 0. Returns (C . h (Bt, L, d), h0s (Bt, n_chunks, N, d))."""
    Bt, L, d = u.shape
    nc = -(-L // chunk)
    pad = nc * chunk - L

    def split(x):
        x = F.pad(x, (0, 0, 0, pad))
        return x.reshape(Bt, nc, chunk, x.shape[-1])

    dt, dtu, Bs, Cs = (split(t) for t in (delta, delta * u, B, C))

    def step(h, j):
        a = torch.exp(dt[:, :, j, :, None] * A)            # (Bt, nc, d, N)
        return a, a * h + dtu[:, :, j, :, None] * Bs[:, :, j, None, :]

    h = torch.zeros((Bt, nc, d, A.shape[1]), dtype=torch.float32,
                    device=u.device)
    p = torch.ones_like(h)
    for j in range(chunk):
        a, h = step(h, j)
        p = p * a
    e = torch.zeros_like(h[:, 0])
    entries = []
    for c in range(nc):
        entries.append(e)
        e = p[:, c] * e + h[:, c]
    h = torch.stack(entries, dim=1)
    h0s = h.transpose(2, 3).contiguous()
    ys = []
    for j in range(chunk):
        _, h = step(h, j)
        ys.append((h * Cs[:, :, j, None, :]).sum(-1))
    y = torch.stack(ys, dim=2).reshape(Bt, nc * chunk, d)[:, :L]
    return y, h0s


def _gate(y_scan, u32, D, z):
    z32 = z.float()
    return (y_scan + D.float() * u32) * (z32 * torch.sigmoid(z32))


def _round_trip(A):
    """-exp(log(-A)): the TPU calls hand their kernels log(-A)."""
    return -torch.exp(torch.log(-A.float()))


def ssm_scan_plain(u, delta, A, B, C, D, z, *, chunk: int = 128,
                   return_h0s: bool = False):
    """Plain PyTorch version of `ssm_scan`."""
    u32 = u.float()
    y, h0s = scan_chunks(u32, delta.float(), _round_trip(A), B.float(),
                         C.float(), chunk)
    y = _gate(y, u32, D, z).to(u.dtype)
    return (y, h0s) if return_h0s else y


def _row_stride(t, name):
    """The row stride of a (Bt, L, n) tensor whose rows are evenly spaced
    and whose columns are contiguous (a view into a wider projection)."""
    Bt, L, n = t.shape
    ld = t.stride(1)
    if t.stride(2) != 1 or t.stride(0) != L * ld or ld < n:
        raise ValueError(f'{name}: rows must be evenly spaced with '
                         f'contiguous columns, got strides {t.stride()}')
    return ld


def _scan_buffers(u, d, N, chunk):
    Bt, L = u.shape[:2]
    nc = -(-L // chunk)
    return [torch.empty((Bt, nc, N, d), dtype=torch.float32, device=u.device)
            for _ in range(3)]     # chunk products, chunk end states, h0s


def ssm_scan(u, delta, A, B, C, D, z, *, chunk: int = 128,
             return_h0s: bool = False):
    """Gated selective scan, K14 (`selective_scan_pallas`'s arguments).

    u, z: (Bt, L, d); delta: (Bt, L, d) float32; A: (d, N) (= -exp(A_log));
    B, C: (Bt, L, N); D: (d,). u, z, B and C share one dtype (float32 or
    bfloat16) and may be views with evenly spaced rows (slices of a wider
    projection); on the card N <= 16 and d <= 1024. Returns y (Bt, L, d)
    in u's dtype, and with `return_h0s` also the chunk entry states
    (Bt, ceil(L / chunk), N, d) float32."""
    if u.device.type == 'cpu':
        return ssm_scan_plain(u, delta, A, B, C, D, z, chunk=chunk,
                              return_h0s=return_h0s)
    _build.require_cuda(u, delta, A, B, C, D, z, contiguous=False)
    Bt, L, d = u.shape
    N = A.shape[1]
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype for t in (z, B, C)):
        raise ValueError('u, z, B and C must share one dtype, float32 or '
                         'bfloat16')
    if (delta.dtype != torch.float32 or A.dtype != torch.float32
            or D.dtype != torch.float32):
        raise ValueError('delta, A and D must be float32')
    if (tuple(A.shape) != (d, N) or tuple(D.shape) != (d,)
            or not A.is_contiguous() or not D.is_contiguous()
            or not delta.is_contiguous() or z.shape != u.shape
            or delta.shape != u.shape or B.shape != (Bt, L, N)
            or C.shape != B.shape):
        raise ValueError('ssm_scan: inconsistent shapes or layouts')
    if not 0 < N <= _MAX_STATE or d > _MAX_INNER or chunk <= 0:
        raise ValueError(f'ssm_scan: N={N} (<= {_MAX_STATE}), d={d} '
                         f'(<= {_MAX_INNER}) and chunk > 0 on the card')
    ld_bc = _row_stride(B, 'B')
    if _row_stride(C, 'C') != ld_bc:
        raise ValueError('B and C must share their row stride')
    y = torch.empty((Bt, L, d), dtype=u.dtype, device=u.device)
    prod, end, h0s = _scan_buffers(u, d, N, chunk)
    fn = _build.kernel('mamba', 'ddg_ssm_scan',
                       (_build.ptr, _build.i32, _build.ptr, _build.ptr,
                        _build.ptr, _build.i32, _build.ptr, _build.i32)
                       + (_build.ptr,) * 6 + (_build.i32,) * 6
                       + (_build.ptr,))
    rc = fn(u.data_ptr(), _row_stride(u, 'u'), delta.data_ptr(),
            B.data_ptr(), C.data_ptr(), ld_bc, z.data_ptr(),
            _row_stride(z, 'z'), A.data_ptr(), D.data_ptr(), y.data_ptr(),
            prod.data_ptr(), end.data_ptr(), h0s.data_ptr(), Bt, L, d, N,
            chunk, _DTYPES[u.dtype], _build.stream(u))
    ssm_scan.launches += 1
    _build.check(rc, 'ddg_ssm_scan')
    return (y, h0s) if return_h0s else y


ssm_scan.launches = 0


def _conv_taps(x, conv_w, conv_b):
    """Causal depthwise conv in x's dtype, taps summed from the oldest:
    ((x_{t-K+1} w_0 + x_{t-K+2} w_1) + ...) + b, each op rounded."""
    K = conv_w.shape[0]
    L = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    w = conv_w.reshape(K, -1).to(x.dtype)
    acc = xp[:, 0:L] * w[0]
    for j in range(1, K):
        acc = acc + xp[:, j:j + L] * w[j]
    return acc + conv_b.to(x.dtype)


def _mm(a, w, dtype):
    """a @ w with fp32 products and sums, rounded to `dtype`."""
    return (a.float() @ w.float()).to(dtype)


def mamba_inner_plain(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A, D, W_out,
                      *, d_state: int, dt_rank: int, chunk: int = 128,
                      compute_dtype=torch.bfloat16, return_h0s: bool = False):
    """Plain PyTorch version of `mamba_inner`."""
    cd = compute_dtype
    d = W_in.shape[1] // 2
    R, N = dt_rank, d_state
    hc = h.to(cd)
    x = _mm(hc, W_in[:, :d].to(cd), cd)
    z = _mm(hc, W_in[:, d:].to(cd), cd)
    xc32 = _conv_taps(x, conv_w, conv_b).float()
    u = (xc32 * torch.sigmoid(xc32)).to(cd)
    x_dbl = _mm(u, W_x.to(cd), cd).float()
    dt_lr, Bc, Cc = x_dbl[..., :R], x_dbl[..., R:R + N], x_dbl[..., R + N:]
    delta = softplus(dt_lr @ W_dt.float() + b_dt.float())
    u32 = u.float()
    y, h0s = scan_chunks(u32, delta, _round_trip(A), Bc, Cc, chunk)
    y = _gate(y, u32, D, z).to(cd)
    out = _mm(y, W_out.to(cd), cd)
    return (out, h0s) if return_h0s else out


def mamba_inner(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A, D, W_out, *,
                d_state: int, dt_rank: int, chunk: int = 128,
                compute_dtype=torch.bfloat16, return_h0s: bool = False):
    """Fused Mamba direction, K18 (`mamba_inner_pallas`'s arguments):
    out_proj(scan(conv_silu(in_proj(h)))).

    h: (Bt, L, H); W_in: (H, 2 d) (x | z columns); conv_w: (K, 1, d);
    conv_b: (d,); W_x: (d, dt_rank + 2 d_state) (dt | B | C columns);
    W_dt: (dt_rank, d); b_dt: (d,); A: (d, d_state) (= -exp(A_log)); D:
    (d,); W_out: (d, H). L must be a multiple of `chunk`. Returns (Bt, L,
    H) in compute_dtype (float32 or bfloat16), and with `return_h0s` the
    scan's chunk entry states. On the card the weights are read in torch's
    (out, in) layout: pass W_in, W_x, W_dt and W_out as transposed views of
    contiguous Linear weights, or they are copied per call; H, d and the
    row length of h must be multiples of 8 (16 for d in bfloat16),
    d_state <= 16, dt_rank <= 32, d_conv = 4."""
    Bt, L, H = h.shape
    d = W_in.shape[1] // 2
    K = conv_w.shape[0]
    R, N = dt_rank, d_state
    if L % chunk:
        raise ValueError(f'L={L} must be divisible by chunk={chunk}')
    if (tuple(W_in.shape) != (H, 2 * d) or tuple(conv_w.shape) != (K, 1, d)
            or tuple(W_x.shape) != (d, R + 2 * N)
            or tuple(W_dt.shape) != (R, d) or tuple(A.shape) != (d, N)
            or tuple(W_out.shape) != (d, H)):
        raise ValueError('mamba_inner: inconsistent weight shapes')
    if h.device.type == 'cpu':
        return mamba_inner_plain(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt,
                                 A, D, W_out, d_state=d_state,
                                 dt_rank=dt_rank, chunk=chunk,
                                 compute_dtype=compute_dtype,
                                 return_h0s=return_h0s)
    cd = compute_dtype
    if cd not in _DTYPES:
        raise ValueError('compute_dtype must be float32 or bfloat16')
    if (H % 8 or d % (16 if cd == torch.bfloat16 else 8) or d > _MAX_INNER
            or not 0 < N <= _MAX_STATE or not 0 < R <= _MAX_RANK
            or K != _CONV_TAPS):
        raise ValueError(f'mamba_inner: H={H}, d={d}, d_state={N}, '
                         f'dt_rank={R} or d_conv={K} outside what the '
                         'kernel takes')
    hc = h.to(cd).contiguous()
    w_in = W_in.to(cd).t().contiguous()                  # (2d, H)
    w_x = W_x.to(cd).t().contiguous()                    # (R + 2N, d)
    w_dt = W_dt.float().t().contiguous()                 # (d, R)
    w_out = W_out.to(cd).t().contiguous()                # (H, d)
    cw = conv_w.to(cd).reshape(K, d).contiguous()
    cb = conv_b.to(cd).contiguous()
    b_dt, A, D = (t.float().contiguous() for t in (b_dt, A, D))
    _build.require_cuda(hc, w_in, w_x, w_dt, w_out, cw, cb, b_dt, A, D)
    dev = h.device
    xz = torch.empty((Bt, L, 2 * d), dtype=cd, device=dev)
    u = torch.empty((Bt, L, d), dtype=cd, device=dev)
    x_dbl = torch.empty((Bt, L, R + 2 * N), dtype=cd, device=dev)
    delta = torch.empty((Bt, L, d), dtype=torch.float32, device=dev)
    y = torch.empty((Bt, L, d), dtype=cd, device=dev)
    out = torch.empty((Bt, L, H), dtype=cd, device=dev)
    prod, end, h0s = _scan_buffers(u, d, N, chunk)
    fn = _build.kernel('mamba', 'ddg_mamba_inner',
                       (_build.ptr,) * 19 + (_build.i32,) * 9 + (_build.ptr,))
    rc = fn(hc.data_ptr(), w_in.data_ptr(), cw.data_ptr(), cb.data_ptr(),
            w_x.data_ptr(), w_dt.data_ptr(), b_dt.data_ptr(), A.data_ptr(),
            D.data_ptr(), w_out.data_ptr(), xz.data_ptr(), u.data_ptr(),
            x_dbl.data_ptr(), delta.data_ptr(), prod.data_ptr(),
            end.data_ptr(), h0s.data_ptr(), y.data_ptr(), out.data_ptr(),
            Bt, L, H, d, K, R, N, chunk, _DTYPES[cd], _build.stream(h))
    mamba_inner.launches += 1
    _build.check(rc, 'ddg_mamba_inner')
    return (out, h0s) if return_h0s else out


mamba_inner.launches = 0

