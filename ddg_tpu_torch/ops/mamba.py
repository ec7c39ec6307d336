"""The DiMamba kernels (port of `ddg_tpu/ops/selective_scan_pallas.py`'s
forward and backward, K14 and K15, and their dt-lowrank variant, K16 and
K17, and of `ddg_tpu/ops/mamba_block_pallas.py`'s, K18 and K19).

`ssm_scan` (K14) is the gated selective scan, in fp32:

    h_t = exp(delta_t A) h_{t-1} + (delta_t u_t) B_t     (h_{-1} = 0)
    y_t = (C_t . h_t + D u_t) * silu(z_t)

with A round-tripped as -exp(log(-A)), as the TPU call hands its kernel
log(-A); y is written in u's dtype. It also gives the entry state of each
chunk of `chunk` rows, h0s (B, n_chunks, N, d) float32. `ssm_scan_dtlr`
(K16) is the same scan with delta = softplus(dt_lr @ W_dt + b_dt) formed
on the card from the low-rank dt_lr, once per (row, channel), into a
transient (B, L, d) float32 workspace that K14's scan reads; L must be a
multiple of the chunk.

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
`selective_scan_pallas`, `selective_scan_pallas_dtlr`): weights in flax's
(in, out) layout, A (d, N), conv_w (K, 1, d). The TPU schedule knobs
(`seg`, `scan_impl`, tiles, `interpret`) have no counterpart. On CUDA
tensors each call runs `csrc/mamba.cu` (K18: in_proj, conv + x_proj +
dt_proj, the scan, out_proj; K14: the scan, which is one launch that
walks each row in order and takes each exp(delta A) once where the batch
fills the card, else three chunk passes (from zero, their carries, again
from the carries), both in the passes' association, so a row's bits do
not depend on its batch; K16: delta, then K14's scan) and adds one to the
wrapper's `launches`; on CPU tensors the plain versions below run
instead. What the card takes is
stated by `mamba_inner_takes`, `ssm_scan_takes` and
`ssm_scan_dtlr_takes`, each naming the kernel that sets each limit: any
chunk, d_state and d_inner; any dt_rank on the dt-lowrank scans (K16's
delta kernel and K17's passes 1 and 3 stage W_dt and dt_lr in rank
tiles); on the fused block any dt_rank, d_conv <= 8, and d_inner and
hidden on the products' rows.

With gradients recorded, `ssm_scan`, `ssm_scan_dtlr` and `mamba_inner` run
through autograd Functions that save the inputs and the chunk entry states
h0s (as the TPU VJPs save (inputs, h0s)); their backwards are
`ssm_scan_bwd` (K15), `ssm_scan_dtlr_bwd` (K17) and `mamba_inner_bwd`
(K19), `csrc/mamba_bwd.cu` on the card, each with its own `launches`. K19
recomputes the front from h by K18's own launches, so the forward keeps
nothing but h and h0s; K17 forms delta again from dt_lr, and dt_proj's
adjoint inside the scan adjoint's last pass. Under
`torch.no_grad()` (sampling) the forwards run outside autograd and launch
what they did before.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ddg_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# What the kernels hold in registers and shared memory (csrc/mamba.cu,
# mamba.cuh; `chip_smoke.py` holds `_SMEM`, `scan_smem` and `_front_smem`
# against the built kernels' own sums, `ddg_smem_max`, `ddg_scan_smem`,
# `ddg_scan_bwd_smem` and `ddg_front_smem`).
_GROUP = 16                     # states a thread holds; more run in groups
_TAPS = (4, 8)                  # conv taps built; fewer are padded with zeros
_SMEM = 232448                  # shared memory a block can have
_SUB_ROWS = 64                  # rows of the adjoint's sub-chunks
# The forward scan's walk (`scan_fwd_kernel`), its larger block (fp32
# operands; 16 channels a block, tiles of 64 rows, 8 lanes a channel): two
# raw tiles of u, z and delta of the channels and B and C of 16 states,
# [row][column], and the staged tile the lanes read, a (delta, delta u)
# float2 a row and channel and a B and C float4 a row and lane.
_SCAN_CH, _SCAN_ROWS, _SCAN_LANES = 16, 64, 8
_SCAN_FWD_SMEM = (2 * _SCAN_ROWS * (2 * _SCAN_CH * 4 + _SCAN_CH * 4
                                    + 2 * _GROUP * 4)
                  + _SCAN_ROWS * (8 * _SCAN_CH + 16 * _SCAN_LANES))
_FRONT_ROWS, _FRONT_K, _XCOLS = 64, 64, 64   # the front's tile and k step
_DELTA_RANK = 360               # ranks of K16's delta kernel's rank tile
_RANK_TILE = 128                # ranks of K17's rank tile (passes 1 and 3)


def _round4(R: int) -> int:
    return -(-R // 4) * 4


def _scan_bwd_smem(chunk: int, N: int, R: int) -> tuple[int, int]:
    """(pass 1, pass 3) bytes of the adjoint (csrc `scan_bwd_smem1/3`),
    which run on sub-chunks of at most 64 rows: pass 1's C columns and
    staged 16-row segment (and, low-rank, one rank tile of the sub-chunk's
    dt_lr rows and W_dt's columns); pass 3's,
    on the sub-chunk's rows rounded up to whole 8-row segments: B and C
    columns, five values a row for the tile's 64 channels, three float4
    summaries a lane for each segment, past 16 states each row's C.h (and,
    low-rank, ddelta) for the 64 channels, and in the low-rank form one
    rank tile of W_dt's columns and the sub-chunk's dt_lr rows. A rank
    tile holds min(round4(R), 128) ranks, so no block grows past it."""
    lr = min(_round4(R), _RANK_TILE) if R else 0
    grp = N > _GROUP
    sc = min(chunk, _SUB_ROWS)
    sp = -(-sc // 8) * 8        # pass 3's rows: whole 8-row segments
    rows = sp * 64
    wt = 64 * (lr + 5)          # W_dt's columns (row stride lr + 4), b_dt
    bwd1 = 4 * (sc * _GROUP + 2 * 16 * 64 + (sc * lr + wt if R else 0))
    bwd3 = 4 * (2 * sp * _GROUP + 5 * rows + 384 * (sp // 8)
                + (rows if grp else 0)
                + ((rows if grp else 0) + wt + _SUB_ROWS * lr if R else 0))
    return bwd1, bwd3


def scan_smem(chunk: int, N: int, R: int = 0) -> int:
    """Bytes of shared memory of the largest block the scan's forward and
    adjoint launch, as csrc's `scan_fwd_smem`, `delta_smem` and
    `scan_bwd_smem1/3` count them (R > 0: the low-rank form, K16 and K17).
    The forward scan's walk is the same for any chunk, d_state and dt_rank
    (one group of 16 states of B and C, u, z and delta of its 16 channels);
    its three passes run only where the chunk fits them (csrc
    `use_passes`), else the walk;
    K16's delta kernel holds one rank tile (up to 360 ranks) of W_dt's
    columns of 128 channels and of 32 dt_lr rows. The adjoint stages one
    group of 16 states at a time, so d_state adds only its running sums
    past 16 states; K17's passes 1 and 3 also hold one rank tile of dt_lr's
    rows and W_dt's columns. So no block grows with dt_rank past its
    tile."""
    fwd = max(_SCAN_FWD_SMEM,
              4 * min(_round4(R), _DELTA_RANK) * (128 + 32) if R else 0)
    return max(fwd, *_scan_bwd_smem(chunk, N, R))


def _front_smem(esize: int) -> int:
    """Bytes of the front's shared memory (csrc `front_smem`): a 64-row
    tile of one k step of u (64 channels, rows of 72) and of W_x's 64
    columns (rows of 72 in bfloat16, 65 in float32), whatever d and
    dt_rank are."""
    wx_ld = _FRONT_K + (8 if esize == 2 else 1)
    return esize * (_FRONT_ROWS * (_FRONT_K + 8) + _XCOLS * wx_ld)


def mamba_inner_takes(H: int, d: int, N: int, R: int, K: int,
                      compute_dtype, chunk: int = 128) -> bool:
    """Whether K18 and K19 take a block of hidden H, d_inner d, d_state
    N, dt_rank R, d_conv K and scan chunk `chunk` in `compute_dtype` on the
    card, and which kernel sets each limit: H % 8 == 0 and d % 8 (16 in
    bfloat16) == 0, the products' rows (both, and the front); any dt_rank
    (the front stages dt_lr in rank tiles of 16, K19's dt_proj adjoint
    loops tiles of 64 past 64); d_conv <= 8,
    built for 4 and 8 taps (`pad_taps`; K18's front and K19's conv
    adjoint); any d_inner (the front walks it in k steps of 64 channels);
    d_state and chunk as `ssm_scan_takes` (any)."""
    return (compute_dtype in _DTYPES and H % 8 == 0
            and d % (16 if compute_dtype == torch.bfloat16 else 8) == 0
            and R > 0 and 0 < K <= _TAPS[-1]
            and _front_smem(2 if compute_dtype == torch.bfloat16 else 4)
            <= _SMEM and ssm_scan_takes(d, N, chunk))


def pad_taps(conv_w):
    """conv_w (K, 1, d) with K < 4 or 4 < K < 8 as the 4- or 8-tap weight
    of the same conv: leading zero taps, which add exact zeros to the sum
    before the first real tap, so the output is bit-identical."""
    K = conv_w.shape[0]
    taps = next((t for t in _TAPS if K <= t), K)
    return F.pad(conv_w, (0, 0, 0, 0, taps - K, 0)) if K < taps else conv_w


def ssm_scan_takes(d: int, N: int, chunk: int = 128) -> bool:
    """Whether K14 and K15 take d_inner d, d_state N and `chunk` on the
    card: any d, any d_state (one group of 16 states is staged at a time)
    and any chunk (the forward scan's shared memory is the same for every
    chunk, K15's passes work on sub-chunks of 64 rows): `scan_smem`."""
    return d > 0 and N > 0 and chunk > 0 and scan_smem(chunk, N) <= _SMEM


def ssm_scan_dtlr_takes(d: int, N: int, R: int, chunk: int = 128) -> bool:
    """Whether K16 and K17 take d_inner d, d_state N, dt_rank R and `chunk`
    on the card: any d, d_state, chunk and dt_rank >= 1, with blocks that
    fit in shared memory (`scan_smem`): K16's delta kernel and K17's
    passes 1 and 3 stage W_dt's columns and dt_lr's rows a rank tile at a
    time, so no block grows with dt_rank past one tile."""
    return (d > 0 and N > 0 and chunk > 0 and R > 0
            and scan_smem(chunk, N, R) <= _SMEM)


def softplus(x):
    """log(1 + exp(x)) as jax.nn.softplus forms it (logaddexp(x, 0))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def scan_chunks(u, delta, A, B, C, chunk: int):
    """The selective scan in fp32, chunk-parallel as the kernel runs it.

    u, delta: (Bt, L, d); A: (d, N); B, C: (Bt, L, N), all fp32. Pass 1
    runs every chunk from a zero state, keeping its end state E and its
    decay P = exp(A sum_t delta_t) (the product of its a_t, formed as the
    kernels form it); pass 2 chains those into each chunk's entry state;
    pass 3 reruns each chunk from its entry state and reads it out through
    C. Rows past L (the last chunk's padding) have delta = 0: a = 1, b = 0.
    Returns (C . h (Bt, L, d), h0s (Bt, n_chunks, N, d))."""
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
    for j in range(chunk):
        _, h = step(h, j)
    p = torch.exp(dt.sum(2)[..., None] * A)
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
    """(h0s, ysum, P, E) for the forward scan: h0s (Bt, n_chunks, N, d)
    float32; where the card runs the three passes (`ddg_scan_passes`: a
    small batch) their P and E, shaped as h0s; else, past 16 states, the
    walk's (Bt, L, d) float32 sums of C . h over the groups so far. The
    rest None."""
    Bt, L = u.shape[:2]
    nc = -(-L // chunk)
    h0s = torch.empty((Bt, nc, N, d), dtype=torch.float32, device=u.device)
    passes = _build.kernel('mamba', 'ddg_scan_passes', (_build.i32,) * 4)
    if passes(Bt, d, N, chunk):
        return h0s, None, torch.empty_like(h0s), torch.empty_like(h0s)
    ysum = (torch.empty((Bt, L, d), dtype=torch.float32, device=u.device)
            if N > _GROUP else None)
    return h0s, ysum, None, None


def _ptr(t):
    return None if t is None else t.data_ptr()


def ssm_scan(u, delta, A, B, C, D, z, *, chunk: int = 128,
             return_h0s: bool = False):
    """Gated selective scan, K14 (`selective_scan_pallas`'s arguments),
    differentiable in its seven tensors through K15 (`ssm_scan_bwd`).
    Without gradients (sampling) the forward runs as it is, outside
    autograd.

    u, z: (Bt, L, d); delta: (Bt, L, d) float32; A: (d, N) (= -exp(A_log));
    B, C: (Bt, L, N); D: (d,). u, z, B and C share one dtype (float32 or
    bfloat16) and may be views with evenly spaced rows (slices of a wider
    projection); on the card `ssm_scan_takes(d, N, chunk)`. Returns y (Bt, L, d)
    in u's dtype, and with `return_h0s` also the chunk entry states
    (Bt, ceil(L / chunk), N, d) float32."""
    if _needs_grad(u, delta, A, B, C, D, z):
        y, h0s = _SsmScan.apply(u, delta, A, B, C, D, z, chunk)
    else:
        y, h0s = _ssm_scan_fwd(u, delta, A, B, C, D, z, chunk=chunk)
    return (y, h0s) if return_h0s else y


def _ssm_scan_fwd(u, delta, A, B, C, D, z, *, chunk):
    """K14 (or its plain version on CPU tensors): (y, h0s)."""
    if u.device.type == 'cpu':
        return ssm_scan_plain(u, delta, A, B, C, D, z, chunk=chunk,
                              return_h0s=True)
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
    if not ssm_scan_takes(d, N, chunk):
        raise ValueError(f'ssm_scan: d_state={N}, chunk={chunk} outside '
                         'what the kernel takes on the card (ssm_scan_takes)')
    ld_bc = _row_stride(B, 'B')
    if _row_stride(C, 'C') != ld_bc:
        raise ValueError('B and C must share their row stride')
    y = torch.empty((Bt, L, d), dtype=u.dtype, device=u.device)
    h0s, ysum, P, E = _scan_buffers(u, d, N, chunk)
    fn = _build.kernel('mamba', 'ddg_ssm_scan',
                       (_build.ptr, _build.i32, _build.ptr, _build.ptr,
                        _build.ptr, _build.i32, _build.ptr, _build.i32)
                       + (_build.ptr,) * 7 + (_build.i32,) * 6
                       + (_build.ptr,))
    rc = fn(u.data_ptr(), _row_stride(u, 'u'), delta.data_ptr(),
            B.data_ptr(), C.data_ptr(), ld_bc, z.data_ptr(),
            _row_stride(z, 'z'), A.data_ptr(), D.data_ptr(), y.data_ptr(),
            h0s.data_ptr(), _ptr(ysum), _ptr(P), _ptr(E), Bt, L, d, N, chunk,
            _DTYPES[u.dtype], _build.stream(u))
    ssm_scan.launches += 1
    _build.check(rc, 'ddg_ssm_scan')
    return y, h0s


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
    row length of h must be multiples of 8 (16 for d in bfloat16), and
    the shape one `mamba_inner_takes` takes (d_conv 1-3 run as 4 taps and
    5-7 as 8, `pad_taps`, on every device). Differentiable in h and every weight
    through K19 (`mamba_inner_bwd`); without gradients (sampling) the
    forward runs as it is, outside autograd."""
    kw = dict(d_state=d_state, dt_rank=dt_rank, chunk=chunk,
              compute_dtype=compute_dtype)
    ws = (W_in, pad_taps(conv_w), conv_b, W_x, W_dt, b_dt, A, D, W_out)
    _check_inner(h, *ws, **kw)
    if _needs_grad(h, *ws):
        out, h0s = _MambaInner.apply(h, *ws, kw)
    else:
        out, h0s = _mamba_inner_fwd(h, *ws, **kw)
    return (out, h0s) if return_h0s else out


def _check_inner(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A, D, W_out, *,
                 d_state, dt_rank, chunk, compute_dtype):
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
        return
    if compute_dtype not in _DTYPES:
        raise ValueError('compute_dtype must be float32 or bfloat16')
    if not mamba_inner_takes(H, d, N, R, K, compute_dtype, chunk):
        raise ValueError(f'mamba_inner: H={H}, d={d}, d_state={N}, '
                         f'dt_rank={R}, d_conv={K} or chunk={chunk} outside '
                         'what the kernel takes (mamba_inner_takes)')


def _mamba_inner_fwd(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A, D, W_out,
                     *, d_state, dt_rank, chunk, compute_dtype):
    """K18 (or its plain version on CPU tensors): (out, h0s)."""
    if h.device.type == 'cpu':
        return mamba_inner_plain(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt,
                                 A, D, W_out, d_state=d_state,
                                 dt_rank=dt_rank, chunk=chunk,
                                 compute_dtype=compute_dtype,
                                 return_h0s=True)
    Bt, L, H = h.shape
    d = W_in.shape[1] // 2
    K = conv_w.shape[0]
    R, N = dt_rank, d_state
    cd = compute_dtype
    hc = h.to(cd).contiguous()
    w_in = W_in.to(cd).t().contiguous()                  # (2d, H)
    w_x = W_x.to(cd).t().contiguous()                    # (R + 2N, d)
    w_dt = W_dt.float().contiguous()                     # (R, d)
    w_out = W_out.to(cd).t().contiguous()                # (H, d)
    cw = conv_w.to(cd).reshape(K, d).contiguous()
    cb = conv_b.to(cd).contiguous()
    b_dt, A, D = (t.float().contiguous() for t in (b_dt, A, D))
    _build.require_cuda(hc, w_in, w_x, w_dt, w_out, cw, cb, b_dt, A, D)
    dev = h.device
    xz = torch.empty((Bt, L, 2 * d), dtype=cd, device=dev)
    u = torch.empty((Bt, L, d), dtype=cd, device=dev)
    x_dbl = torch.empty((Bt, L, R + 2 * N), dtype=cd, device=dev)
    y = torch.empty((Bt, L, d), dtype=cd, device=dev)
    out = torch.empty((Bt, L, H), dtype=cd, device=dev)
    delta = torch.empty((Bt, L, d), dtype=torch.float32, device=dev)
    h0s, ysum, P, E = _scan_buffers(u, d, N, chunk)
    fn = _build.kernel('mamba', 'ddg_mamba_inner',
                       (_build.ptr,) * 20 + (_build.i32,) * 9 + (_build.ptr,))
    rc = fn(hc.data_ptr(), w_in.data_ptr(), cw.data_ptr(), cb.data_ptr(),
            w_x.data_ptr(), w_dt.data_ptr(), b_dt.data_ptr(), A.data_ptr(),
            D.data_ptr(), w_out.data_ptr(), xz.data_ptr(), u.data_ptr(),
            x_dbl.data_ptr(), delta.data_ptr(), h0s.data_ptr(), _ptr(ysum),
            _ptr(P), _ptr(E), y.data_ptr(), out.data_ptr(), Bt, L, H, d, K, R,
            N, chunk,
            _DTYPES[cd], _build.stream(h))
    mamba_inner.launches += 1
    _build.check(rc, 'ddg_mamba_inner')
    return out, h0s


mamba_inner.launches = 0



# --- the backward: K15 and K19 ------------------------------------------------

# Rows between the forward-state checkpoints of the adjoint's last pass
# (the kernel's segment; the plain version keeps the same ones to bound
# its memory).
_SEG = 16


def scan_bwd_chunks(u, delta, A, B, C, D, z, g, h0s, chunk: int):
    """The adjoint of the gated selective scan in fp32, chunk-parallel as
    the kernel runs it; every input fp32, A round-tripped (d, N), g the
    gradient of the gated output. Pass 1 runs every chunk's adjoint from
    zero at its end, keeping the carry it hands left (a_t0 dh_t0) and the
    product of its a_t; pass 2 chains those right to left into each
    chunk's true incoming carry; pass 3 reruns each chunk from its entry
    state in h0s, keeping the state every `_SEG` rows, and walks each
    segment back from its checkpoint, recomputing its states. Returns
    (ddelta, du, dB, dC, y_pre, dz, dA, dD): (Bt, L, d) / (Bt, L, N),
    y_pre = C . h + D u before the gate, dA (d, N) and dD (d,) summed over
    batch and rows."""
    Bt, L, d = u.shape
    N = A.shape[1]
    nc = -(-L // chunk)
    pad = nc * chunk - L

    def split(x):
        x = F.pad(x, (0, 0, 0, pad))
        return x.reshape(Bt, nc, chunk, x.shape[-1])

    sig = torch.sigmoid(z)
    sg = z * sig
    gy = g * sg
    dt, uu, dtu, gys, Bs, Cs = (split(t) for t in
                                (delta, u, delta * u, gy, B, C))

    def a_row(j):
        return torch.exp(dt[:, :, j, :, None] * A)       # (Bt, nc, d, N)

    def w_row(j):
        return gys[:, :, j, :, None] * Cs[:, :, j, None, :]

    def h_next(h, j):
        return a_row(j) * h + dtu[:, :, j, :, None] * Bs[:, :, j, None, :]

    dh = torch.zeros((Bt, nc, d, N), dtype=torch.float32, device=u.device)
    p = torch.ones_like(dh)
    a_up = torch.ones_like(dh)
    for j in reversed(range(chunk)):
        a = a_row(j)
        dh = w_row(j) + a_up * dh
        a_up = a
        p = p * a
    left = a_up * dh
    carry = torch.zeros_like(dh[:, 0])
    carries = [None] * nc
    for c in reversed(range(nc)):
        carries[c] = carry
        carry = p[:, c] * carry + left[:, c]
    dh = torch.stack(carries, dim=1)
    del p, left, carries

    h = h0s.transpose(2, 3)
    ckpts = []
    for j in range(chunk):
        if j % _SEG == 0:
            ckpts.append(h)
        h = h_next(h, j)
    rows = {k: [None] * chunk for k in ('ddt', 'du', 'dB', 'dC', 'y')}
    dA = torch.zeros((d, N), dtype=torch.float32, device=u.device)
    a_up = torch.ones_like(dh)
    for s in reversed(range(len(ckpts))):
        j0 = s * _SEG
        hs = [ckpts[s]]
        for j in range(j0, min(chunk, j0 + _SEG)):
            hs.append(h_next(hs[-1], j))
        for j in reversed(range(j0, min(chunk, j0 + _SEG))):
            a = a_row(j)
            dh = w_row(j) + a_up * dh
            a_up = a
            h_prev, h_j = hs[j - j0], hs[j - j0 + 1]
            daa = dh * h_prev * a
            dhB = (dh * Bs[:, :, j, None, :]).sum(-1)
            rows['ddt'][j] = (daa * A).sum(-1) + dhB * uu[:, :, j]
            rows['du'][j] = dhB * dt[:, :, j] + gys[:, :, j] * D
            rows['dB'][j] = (dh * dtu[:, :, j, :, None]).sum(-2)
            rows['dC'][j] = (h_j * gys[:, :, j, :, None]).sum(-2)
            rows['y'][j] = (h_j * Cs[:, :, j, None, :]).sum(-1) \
                + D * uu[:, :, j]
            dA = dA + (daa * dt[:, :, j, :, None]).sum((0, 1))

    def join(k):
        return torch.stack(rows[k], dim=2).reshape(Bt, nc * chunk, -1)[:, :L]

    ddt, du, dB, dC, y_pre = (join(k) for k in ('ddt', 'du', 'dB', 'dC', 'y'))
    dz = g * y_pre * (sig + sg * (1.0 - sig))
    dD = (gy * u).sum((0, 1))
    return ddt, du, dB, dC, y_pre, dz, dA, dD


def ssm_scan_bwd_plain(u, delta, A, B, C, D, z, h0s, g, *, chunk: int = 128):
    """Plain PyTorch version of `ssm_scan_bwd`."""
    A_rt = _round_trip(A)
    ddt, du, dB, dC, _, dz, dA, dD = scan_bwd_chunks(
        u.float(), delta.float(), A_rt, B.float(), C.float(), D.float(),
        z.float(), g.float(), h0s, chunk)
    return (du.to(u.dtype), ddt, dB.to(B.dtype), dC.to(C.dtype),
            (dA * A_rt).t(), dz.to(z.dtype), dD)


def _conv_adjoint(dxc, conv_w):
    """dx_t = ((dxc_{t+K-1} w_0 + dxc_{t+K-2} w_1) + ...) + dxc_t w_{K-1}
    in fp32 (the TPU kernel's `_conv_adjoint` order); rows past L are 0."""
    K = conv_w.shape[0]
    L = dxc.shape[1]
    w = conv_w.reshape(K, -1).float()
    dp = F.pad(dxc, (0, 0, 0, K - 1))
    acc = dp[:, K - 1:K - 1 + L] * w[0]
    for j in range(1, K):
        acc = acc + dp[:, K - 1 - j:K - 1 - j + L] * w[j]
    return acc


def mamba_inner_bwd_plain(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A, D,
                          W_out, h0s, g, *, d_state: int, dt_rank: int,
                          chunk: int = 128, compute_dtype=torch.bfloat16):
    """Plain PyTorch version of `mamba_inner_bwd`."""
    cd = compute_dtype
    Bt, L, H = h.shape
    d = W_in.shape[1] // 2
    K = conv_w.shape[0]
    R, N = dt_rank, d_state
    f32 = torch.float32
    # The front, recomputed from h as the forward rounds it.
    hc = h.to(cd)
    x = _mm(hc, W_in[:, :d].to(cd), cd)
    z32 = _mm(hc, W_in[:, d:].to(cd), cd).float()
    xc32 = _conv_taps(x, conv_w, conv_b).float()
    sc = torch.sigmoid(xc32)
    u = (xc32 * sc).to(cd)
    x_dbl = _mm(u, W_x.to(cd), cd).float()
    lr, Bc, Cc = x_dbl[..., :R], x_dbl[..., R:R + N], x_dbl[..., R + N:]
    W_dt32 = W_dt.float()
    pre = lr @ W_dt32 + b_dt.float()
    A_rt = _round_trip(A)
    u32 = u.float()
    # out_proj's adjoint, then the scan's.
    gc = g.to(cd).float()
    dy = gc @ W_out.to(cd).float().t()
    ddt, du, dB, dC, y_pre, dz, dA, dD = scan_bwd_chunks(
        u32, softplus(pre), A_rt, Bc, Cc, D.float(), z32, dy, h0s, chunk)
    yg = (y_pre * (z32 * torch.sigmoid(z32))).to(cd).float()
    rows = lambda t: t.reshape(Bt * L, t.shape[-1])      # noqa: E731
    dW_out = rows(yg).t() @ rows(gc)
    # dt_proj's adjoint in fp32; x_proj's on the rounded gradients.
    dpre = ddt * torch.sigmoid(pre)
    dW_dt = rows(lr).t() @ rows(dpre)
    db_dt = dpre.sum((0, 1))
    dxdbl = torch.cat([dpre @ W_dt32.t(), dB, dC], dim=-1).to(cd).float()
    du = du + dxdbl @ W_x.to(cd).float().t()
    dW_x = rows(u32).t() @ rows(dxdbl)
    # The conv + SiLU adjoint, then in_proj's.
    dxc = du * (sc * (1.0 + xc32 * (1.0 - sc)))
    dconv_b = dxc.sum((0, 1))
    xp = F.pad(x, (0, 0, K - 1, 0)).float()
    dconv_w = torch.stack([(xp[:, j:j + L] * dxc).sum((0, 1))
                           for j in range(K)]).reshape(K, 1, d)
    dxz = torch.cat([_conv_adjoint(dxc, conv_w).to(cd),
                     dz.to(cd)], dim=-1).float()
    dh = (dxz @ W_in.to(cd).float().t()).to(cd)
    dW_in = rows(hc.float()).t() @ rows(dxz)
    return (dh, dW_in, dconv_w, dconv_b, dW_x, dW_dt, db_dt,
            (dA * A_rt).t(), dD, dW_out)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _grad_A(dA_log, A):
    """The gradient of A from that of log(-A) (N, d), as the JAX calls
    differentiate their log(-A).T."""
    return dA_log.t() / A


class _SsmScan(torch.autograd.Function):
    """Saves the inputs and the chunk entry states, as the TPU VJP saves
    (inputs, h0s)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, chunk):
        y, h0s = _ssm_scan_fwd(u, delta, A, B, C, D, z, chunk=chunk)
        ctx.save_for_backward(u, delta, A, B, C, D, z, h0s)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(h0s)
        return y, h0s

    @staticmethod
    def backward(ctx, g, _):
        u, delta, A, B, C, D, z, h0s = ctx.saved_tensors
        du, ddt, dB, dC, dA_log, dz, dD = ssm_scan_bwd(
            u, delta, A, B, C, D, z, h0s, g, chunk=ctx.chunk)
        return du, ddt, _grad_A(dA_log, A), dB, dC, dD, dz, None


class _MambaInner(torch.autograd.Function):
    """Saves h, the weights and the chunk entry states, as the TPU VJP
    saves (h, ws, h0s); the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A, D, W_out,
                kw):
        out, h0s = _mamba_inner_fwd(h, W_in, conv_w, conv_b, W_x, W_dt,
                                    b_dt, A, D, W_out, **kw)
        ctx.save_for_backward(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A,
                              D, W_out, h0s)
        ctx.kw = kw
        ctx.mark_non_differentiable(h0s)
        return out, h0s

    @staticmethod
    def backward(ctx, g, _):
        h, *ws, h0s = ctx.saved_tensors
        grads = mamba_inner_bwd(h, *ws, h0s, g, **ctx.kw)
        A = ws[6]
        return grads[:7] + (_grad_A(grads[7], A),) + grads[8:] + (None,)


def workspace_bytes(fn: str, *ints) -> int:
    """The bytes of workspace the C side's `<fn>_workspace` gives (needs
    the built kernels)."""
    return _build.kernel('mamba_bwd', f'{fn}_workspace',
                         (_build.i32,) * len(ints), ctypes.c_longlong)(*ints)


def _workspace(fn: str, device, *ints) -> torch.Tensor:
    """A byte workspace of the size the C side's `<fn>_workspace` gives."""
    return torch.empty((workspace_bytes(fn, *ints),), dtype=torch.uint8,
                       device=device)


def ssm_scan_bwd(u, delta, A, B, C, D, z, h0s, g, *, chunk: int = 128):
    """Backward of `ssm_scan`, K15 (`_ssm_scan_vjp_bwd`'s outputs): for
    the gradient g of y and the forward's chunk entry states h0s, returns
    (du, ddelta, dB, dC, dA_log, dz, dD): du, dB, dC and dz in their
    inputs' dtypes, ddelta float32, dA_log (N, d) the gradient of
    log(-A).T, dD (d,). On CUDA tensors one call of `csrc/mamba_bwd.cu`
    (the adjoint's three passes and the fixed-order sums of the channel
    tiles' and chunks' partials; deterministic) and one count."""
    if u.device.type == 'cpu':
        return ssm_scan_bwd_plain(u, delta, A, B, C, D, z, h0s, g,
                                  chunk=chunk)
    _build.require_cuda(u, delta, A, B, C, D, z, h0s, g, contiguous=False)
    Bt, L, d = u.shape
    N = A.shape[1]
    nc = -(-L // chunk)
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype for t in (z, B, C)):
        raise ValueError('u, z, B and C must share one dtype, float32 or '
                         'bfloat16')
    if (delta.dtype != torch.float32 or A.dtype != torch.float32
            or D.dtype != torch.float32 or h0s.dtype != torch.float32):
        raise ValueError('delta, A, D and h0s must be float32')
    if (tuple(A.shape) != (d, N) or tuple(D.shape) != (d,)
            or not A.is_contiguous() or not D.is_contiguous()
            or not delta.is_contiguous() or not h0s.is_contiguous()
            or z.shape != u.shape or delta.shape != u.shape
            or g.shape != u.shape or B.shape != (Bt, L, N)
            or C.shape != B.shape or tuple(h0s.shape) != (Bt, nc, N, d)):
        raise ValueError('ssm_scan_bwd: inconsistent shapes or layouts')
    if not ssm_scan_takes(d, N, chunk):
        raise ValueError(f'ssm_scan_bwd: d_state={N}, chunk={chunk} do not '
                         'fit the kernel\'s shared memory on the card '
                         '(ssm_scan_takes)')
    ld_bc = _row_stride(B, 'B')
    if _row_stride(C, 'C') != ld_bc:
        raise ValueError('B and C must share their row stride')
    g = g.to(u.dtype).contiguous()
    dev, f32 = u.device, torch.float32
    du, ddt, dz = (torch.empty((Bt, L, d), dtype=f32, device=dev)
                   for _ in range(3))
    dB, dC = (torch.empty((Bt, L, N), dtype=f32, device=dev)
              for _ in range(2))
    dA_log = torch.empty((N, d), dtype=f32, device=dev)
    dD = torch.empty((d,), dtype=f32, device=dev)
    ws = _workspace('ddg_ssm_scan_bwd', dev, Bt, L, d, N, chunk)
    fn = _build.kernel('mamba_bwd', 'ddg_ssm_scan_bwd',
                       (_build.ptr, _build.i32, _build.ptr, _build.ptr,
                        _build.ptr, _build.i32, _build.ptr, _build.i32)
                       + (_build.ptr,) * 12 + (_build.i32,) * 6
                       + (_build.ptr,))
    rc = fn(u.data_ptr(), _row_stride(u, 'u'), delta.data_ptr(),
            B.data_ptr(), C.data_ptr(), ld_bc, z.data_ptr(),
            _row_stride(z, 'z'), A.data_ptr(), D.data_ptr(),
            h0s.data_ptr(), g.data_ptr(), du.data_ptr(), ddt.data_ptr(),
            dz.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA_log.data_ptr(),
            dD.data_ptr(), ws.data_ptr(), Bt, L, d, N, chunk,
            _DTYPES[u.dtype], _build.stream(u))
    ssm_scan_bwd.launches += 1
    _build.check(rc, 'ddg_ssm_scan_bwd')
    return (du.to(u.dtype), ddt, dB.to(B.dtype), dC.to(C.dtype), dA_log,
            dz.to(z.dtype), dD)


ssm_scan_bwd.launches = 0


def mamba_inner_bwd(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A, D, W_out,
                    h0s, g, *, d_state: int, dt_rank: int, chunk: int = 128,
                    compute_dtype=torch.bfloat16):
    """Backward of `mamba_inner`, K19 (`_mamba_inner_bwd`): for the output
    gradient g and the forward's chunk entry states h0s, returns (dh,
    dW_in, dconv_w, dconv_b, dW_x, dW_dt, db_dt, dA_log, dD, dW_out): dh
    (Bt, L, H) in compute_dtype, the weight gradients float32 in the
    arguments' shapes (W_in's and W_x's hold the TPU call's wx | wz and
    wlr | wb | wc), dA_log (N, d) the gradient of log(-A).T. On CUDA
    tensors one call of `csrc/mamba_bwd.cu` (the front recomputed from h,
    the products on the tensor cores in bf16, the scan's adjoint, the
    weight gradients as fixed-order two-stage sums; deterministic) and
    one count. The card takes what the forward takes."""
    kw = dict(d_state=d_state, dt_rank=dt_rank, chunk=chunk,
              compute_dtype=compute_dtype)
    if h.device.type == 'cpu':
        return mamba_inner_bwd_plain(h, W_in, conv_w, conv_b, W_x, W_dt,
                                     b_dt, A, D, W_out, h0s, g, **kw)
    taps = conv_w.shape[0]
    conv_w = pad_taps(conv_w)
    _check_inner(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A, D, W_out, **kw)
    Bt, L, H = h.shape
    d = W_in.shape[1] // 2
    K = conv_w.shape[0]
    R, N = dt_rank, d_state
    nx = R + 2 * N
    nxp = -(-nx // 8) * 8
    cd = compute_dtype
    if h0s.dtype != torch.float32 or tuple(h0s.shape) != (Bt, L // chunk,
                                                          N, d):
        raise ValueError('mamba_inner_bwd: h0s must be the forward\'s '
                         f'(Bt, L / chunk, N, d) float32, got {h0s.shape}')
    hc = h.to(cd).contiguous()
    gc = g.to(cd).contiguous()
    w_in = W_in.to(cd).t().contiguous()                  # (2d, H)
    w_in_f = W_in.to(cd).contiguous()                    # (H, 2d)
    w_x = W_x.to(cd).t().contiguous()                    # (nx, d)
    w_x_f = torch.zeros((d, nxp), dtype=cd, device=h.device)
    w_x_f[:, :nx] = W_x                                  # (d, nxp)
    w_dt = W_dt.float().contiguous()                     # (R, d)
    w_out_f = W_out.to(cd).contiguous()                  # (d, H)
    cw = conv_w.to(cd).reshape(K, d).contiguous()
    cb = conv_b.to(cd).contiguous()
    b_dt, A, D, h0s = (t.float().contiguous() for t in (b_dt, A, D, h0s))
    _build.require_cuda(hc, gc, w_in, w_x, w_dt, w_out_f, cw, cb, b_dt, A, D,
                        h0s)
    dev, f32 = h.device, torch.float32
    dh = torch.empty((Bt, L, H), dtype=cd, device=dev)
    dW_in = torch.empty((H, 2 * d), dtype=f32, device=dev)
    dcw = torch.empty((K, d), dtype=f32, device=dev)
    dcb, db_dt, dD = (torch.empty((d,), dtype=f32, device=dev)
                      for _ in range(3))
    dW_x = torch.empty((d, nx), dtype=f32, device=dev)
    dW_dt = torch.empty((R, d), dtype=f32, device=dev)
    dA_log = torch.empty((N, d), dtype=f32, device=dev)
    dW_out = torch.empty((d, H), dtype=f32, device=dev)
    ints = (Bt, L, H, d, K, R, N, chunk, _DTYPES[cd])
    ws = _workspace('ddg_mamba_inner_bwd', dev, *ints)
    fn = _build.kernel('mamba_bwd', 'ddg_mamba_inner_bwd',
                       (_build.ptr,) * 25 + (_build.i32,) * 9 + (_build.ptr,))
    rc = fn(hc.data_ptr(), w_in.data_ptr(), w_in_f.data_ptr(), cw.data_ptr(),
            cb.data_ptr(), w_x.data_ptr(), w_x_f.data_ptr(), w_dt.data_ptr(),
            b_dt.data_ptr(), A.data_ptr(), D.data_ptr(), w_out_f.data_ptr(),
            h0s.data_ptr(), gc.data_ptr(), dh.data_ptr(), dW_in.data_ptr(),
            dcw.data_ptr(), dcb.data_ptr(), dW_x.data_ptr(), dW_dt.data_ptr(),
            db_dt.data_ptr(), dA_log.data_ptr(), dD.data_ptr(),
            dW_out.data_ptr(), ws.data_ptr(), *ints, _build.stream(h))
    mamba_inner_bwd.launches += 1
    _build.check(rc, 'ddg_mamba_inner_bwd')
    return (dh, dW_in, dcw[K - taps:].reshape(taps, 1, d), dcb, dW_x, dW_dt,
            db_dt, dA_log, dD, dW_out)


mamba_inner_bwd.launches = 0


# --- the dt-lowrank scan: K16 and K17 -------------------------------------------

def _dtlr_grid(L: int, chunk: int):
    if L % chunk:
        raise ValueError(
            f'dt-lowrank path requires chunk | L (got L={L}, chunk={chunk}); '
            'use ssm_scan instead')


def _delta_lr(dt_lr, W_dt, b_dt):
    """(softplus(pre), pre), pre = dt_lr @ W_dt + b_dt in fp32."""
    pre = dt_lr.float() @ W_dt.float() + b_dt.float()
    return softplus(pre), pre


def ssm_scan_dtlr_plain(u, dt_lr, W_dt, b_dt, A, B, C, D, z, *,
                        chunk: int = 128, return_h0s: bool = False):
    """Plain PyTorch version of `ssm_scan_dtlr`: `ssm_scan_plain` of
    delta = softplus(dt_lr @ W_dt + b_dt), in fp32."""
    _dtlr_grid(u.shape[1], chunk)
    delta, _ = _delta_lr(dt_lr, W_dt, b_dt)
    return ssm_scan_plain(u, delta, A, B, C, D, z, chunk=chunk,
                          return_h0s=return_h0s)


def ssm_scan_dtlr(u, dt_lr, W_dt, b_dt, A, B, C, D, z, *, chunk: int = 128,
                  return_h0s: bool = False):
    """Gated selective scan with dt_proj and softplus on the card, K16
    (`selective_scan_pallas_dtlr`'s arguments): `ssm_scan` of delta =
    softplus(dt_lr @ W_dt + b_dt), formed once per (row, channel) into a
    transient float32 workspace and never saved for the backward.
    Differentiable in its nine tensors through K17
    (`ssm_scan_dtlr_bwd`); without gradients (sampling) the forward runs as
    it is, outside autograd.

    dt_lr: (Bt, L, R), cast to float32 as the JAX call casts it; W_dt:
    (R, d); b_dt: (d,); the rest as `ssm_scan`. L must be a multiple of
    `chunk` on every device (a padded tail would carry softplus(b_dt) > 0
    into the state). On the card `ssm_scan_dtlr_takes(d, N, R, chunk)`.
    Returns y (Bt, L, d) in u's dtype, and with `return_h0s` the chunk
    entry states."""
    _dtlr_grid(u.shape[1], chunk)
    if _needs_grad(u, dt_lr, W_dt, b_dt, A, B, C, D, z):
        y, h0s = _SsmScanDtlr.apply(u, dt_lr, W_dt, b_dt, A, B, C, D, z,
                                    chunk)
    else:
        y, h0s = _ssm_scan_dtlr_fwd(u, dt_lr, W_dt, b_dt, A, B, C, D, z,
                                    chunk=chunk)
    return (y, h0s) if return_h0s else y


def _dtlr_operands(u, dt_lr, W_dt, b_dt, A, B, C, D, z, chunk, name):
    """Checks for the card and the operands in the kernels' layouts:
    (dt_lr fp32 with its row stride, W_dt (R, d), b_dt, A, D fp32
    contiguous, the B/C row stride)."""
    Bt, L, d = u.shape
    N, R = A.shape[1], dt_lr.shape[-1]
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype for t in (z, B, C)):
        raise ValueError('u, z, B and C must share one dtype, float32 or '
                         'bfloat16')
    if (tuple(A.shape) != (d, N) or tuple(D.shape) != (d,)
            or tuple(W_dt.shape) != (R, d) or tuple(b_dt.shape) != (d,)
            or tuple(dt_lr.shape) != (Bt, L, R) or z.shape != u.shape
            or B.shape != (Bt, L, N) or C.shape != B.shape):
        raise ValueError(f'{name}: inconsistent shapes')
    if not ssm_scan_dtlr_takes(d, N, R, chunk):
        raise ValueError(f'{name}: d_state={N}, dt_rank={R}, chunk={chunk} '
                         'outside what the kernel takes on the card (every '
                         'd_state, chunk and dt_rank >= 1: '
                         'ssm_scan_dtlr_takes)')
    lr = dt_lr.float()
    ld_bc = _row_stride(B, 'B')
    if _row_stride(C, 'C') != ld_bc:
        raise ValueError('B and C must share their row stride')
    return (lr, _row_stride(lr, 'dt_lr'), W_dt.float().contiguous(),
            b_dt.float().contiguous(), A.float().contiguous(),
            D.float().contiguous(), ld_bc)


def _ssm_scan_dtlr_fwd(u, dt_lr, W_dt, b_dt, A, B, C, D, z, *, chunk):
    """K16 (or its plain version on CPU tensors): (y, h0s)."""
    if u.device.type == 'cpu':
        return ssm_scan_dtlr_plain(u, dt_lr, W_dt, b_dt, A, B, C, D, z,
                                   chunk=chunk, return_h0s=True)
    _build.require_cuda(u, dt_lr, W_dt, b_dt, A, B, C, D, z,
                        contiguous=False)
    Bt, L, d = u.shape
    N, R = A.shape[1], dt_lr.shape[-1]
    lr, ld_lr, w_dt, b_dt, A, D, ld_bc = _dtlr_operands(
        u, dt_lr, W_dt, b_dt, A, B, C, D, z, chunk, 'ssm_scan_dtlr')
    y = torch.empty((Bt, L, d), dtype=u.dtype, device=u.device)
    delta = torch.empty((Bt, L, d), dtype=torch.float32, device=u.device)
    h0s, ysum, P, E = _scan_buffers(u, d, N, chunk)
    fn = _build.kernel('mamba', 'ddg_ssm_scan_dtlr',
                       (_build.ptr, _build.i32, _build.ptr, _build.i32)
                       + (_build.ptr,) * 5
                       + (_build.i32, _build.ptr, _build.i32)
                       + (_build.ptr,) * 7 + (_build.i32,) * 7
                       + (_build.ptr,))
    rc = fn(u.data_ptr(), _row_stride(u, 'u'), lr.data_ptr(), ld_lr,
            w_dt.data_ptr(), b_dt.data_ptr(), delta.data_ptr(), B.data_ptr(),
            C.data_ptr(), ld_bc, z.data_ptr(), _row_stride(z, 'z'),
            A.data_ptr(), D.data_ptr(), y.data_ptr(), h0s.data_ptr(),
            _ptr(ysum), _ptr(P), _ptr(E), Bt, L, d, N, R, chunk,
            _DTYPES[u.dtype], _build.stream(u))
    ssm_scan_dtlr.launches += 1
    _build.check(rc, 'ddg_ssm_scan_dtlr')
    return y, h0s


ssm_scan_dtlr.launches = 0


def ssm_scan_dtlr_bwd_plain(u, dt_lr, W_dt, b_dt, A, B, C, D, z, h0s, g, *,
                            chunk: int = 128):
    """Plain PyTorch version of `ssm_scan_dtlr_bwd`: `ssm_scan_bwd_plain`
    on delta = softplus(pre), then dt_proj's adjoint in fp32, written out
    (dpre = ddelta sigmoid(pre), ddt_lr = dpre W_dt^T, dW_dt = dt_lr^T
    dpre, db_dt = sum of dpre)."""
    _dtlr_grid(u.shape[1], chunk)
    delta, pre = _delta_lr(dt_lr, W_dt, b_dt)
    du, ddt, dB, dC, dA_log, dz, dD = ssm_scan_bwd_plain(
        u, delta, A, B, C, D, z, h0s, g, chunk=chunk)
    dpre = ddt * torch.sigmoid(pre)
    R, d = W_dt.shape
    rows = dt_lr.float().reshape(-1, R)
    dp = dpre.reshape(-1, d)
    return (du, dpre @ W_dt.float().t(), rows.t() @ dp, dp.sum(0), dB, dC,
            dA_log, dz, dD)


def ssm_scan_dtlr_bwd(u, dt_lr, W_dt, b_dt, A, B, C, D, z, h0s, g, *,
                      chunk: int = 128):
    """Backward of `ssm_scan_dtlr`, K17 (`_ssm_scan_dtlr_bwd`'s outputs):
    for the gradient g of y and the forward's chunk entry states h0s,
    returns (du, ddt_lr, dW_dt, db_dt, dB, dC, dA_log, dz, dD): du, dB, dC
    and dz in their inputs' dtypes, ddt_lr (Bt, L, R), dW_dt (R, d) and
    db_dt float32, dA_log (N, d) the gradient of log(-A).T, dD (d,). On
    CUDA tensors one call of `csrc/mamba_bwd.cu` (the scan's adjoint with
    delta formed in the kernel and dt_proj's adjoint inside its last pass,
    then the fixed-order sums of the partials; deterministic) and one
    count."""
    if u.device.type == 'cpu':
        return ssm_scan_dtlr_bwd_plain(u, dt_lr, W_dt, b_dt, A, B, C, D, z,
                                       h0s, g, chunk=chunk)
    _dtlr_grid(u.shape[1], chunk)
    _build.require_cuda(u, dt_lr, W_dt, b_dt, A, B, C, D, z, h0s, g,
                        contiguous=False)
    Bt, L, d = u.shape
    N, R = A.shape[1], dt_lr.shape[-1]
    lr, ld_lr, w_dt, b_dt, A32, D32, ld_bc = _dtlr_operands(
        u, dt_lr, W_dt, b_dt, A, B, C, D, z, chunk, 'ssm_scan_dtlr_bwd')
    if (h0s.dtype != torch.float32 or not h0s.is_contiguous()
            or tuple(h0s.shape) != (Bt, L // chunk, N, d)
            or g.shape != u.shape):
        raise ValueError('ssm_scan_dtlr_bwd: h0s must be the forward\'s '
                         f'(Bt, L / chunk, N, d) float32, got {h0s.shape}')
    g = g.to(u.dtype).contiguous()
    dev, f32 = u.device, torch.float32
    du, dz = (torch.empty((Bt, L, d), dtype=f32, device=dev)
              for _ in range(2))
    dlr = torch.empty((Bt, L, R), dtype=f32, device=dev)
    dW = torch.empty((R, d), dtype=f32, device=dev)
    db, dD = (torch.empty((d,), dtype=f32, device=dev) for _ in range(2))
    dB, dC = (torch.empty((Bt, L, N), dtype=f32, device=dev)
              for _ in range(2))
    dA_log = torch.empty((N, d), dtype=f32, device=dev)
    ws = _workspace('ddg_ssm_scan_dtlr_bwd', dev, Bt, L, d, N, R, chunk)
    fn = _build.kernel('mamba_bwd', 'ddg_ssm_scan_dtlr_bwd',
                       (_build.ptr, _build.i32, _build.ptr, _build.i32,
                        _build.ptr, _build.ptr, _build.ptr, _build.ptr,
                        _build.i32, _build.ptr, _build.i32)
                       + (_build.ptr,) * 14 + (_build.i32,) * 7
                       + (_build.ptr,))
    rc = fn(u.data_ptr(), _row_stride(u, 'u'), lr.data_ptr(), ld_lr,
            w_dt.data_ptr(), b_dt.data_ptr(), B.data_ptr(), C.data_ptr(),
            ld_bc, z.data_ptr(), _row_stride(z, 'z'), A32.data_ptr(),
            D32.data_ptr(), h0s.data_ptr(), g.data_ptr(), du.data_ptr(),
            dlr.data_ptr(), dW.data_ptr(), db.data_ptr(), dz.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dA_log.data_ptr(), dD.data_ptr(),
            ws.data_ptr(), Bt, L, d, N, R, chunk, _DTYPES[u.dtype],
            _build.stream(u))
    ssm_scan_dtlr_bwd.launches += 1
    _build.check(rc, 'ddg_ssm_scan_dtlr_bwd')
    return (du.to(u.dtype), dlr, dW, db, dB.to(B.dtype), dC.to(C.dtype),
            dA_log, dz.to(z.dtype), dD)


ssm_scan_dtlr_bwd.launches = 0


class _SsmScanDtlr(torch.autograd.Function):
    """Saves (u, dt_lr, W_dt, b_dt, A, B, C, z, D, h0s), as the TPU VJP
    `_ssm_scan_dtlr_fwd` saves them; delta is never saved."""

    @staticmethod
    def forward(ctx, u, dt_lr, W_dt, b_dt, A, B, C, D, z, chunk):
        y, h0s = _ssm_scan_dtlr_fwd(u, dt_lr, W_dt, b_dt, A, B, C, D, z,
                                    chunk=chunk)
        ctx.save_for_backward(u, dt_lr, W_dt, b_dt, A, B, C, z, D, h0s)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(h0s)
        return y, h0s

    @staticmethod
    def backward(ctx, g, _):
        u, dt_lr, W_dt, b_dt, A, B, C, z, D, h0s = ctx.saved_tensors
        du, dlr, dW, db, dB, dC, dA_log, dz, dD = ssm_scan_dtlr_bwd(
            u, dt_lr, W_dt, b_dt, A, B, C, D, z, h0s, g, chunk=ctx.chunk)
        return (du, dlr.to(dt_lr.dtype), dW.to(W_dt.dtype),
                db.to(b_dt.dtype), _grad_A(dA_log, A), dB, dC, dD, dz, None)
