"""adaLN chains of the DiT block (port of `ddg_tpu/ops/adaln_pallas.py`):

    ln_modulate:          h = LN(x) * w * (1 + scale) + shift
    gate_res_ln_modulate: x' = skip + gate * y
                          h  = LN(x') * w * (1 + scale) + shift

LN uses one-pass fp32 moments, the variance clamped at 0, eps 1e-5, and a
scale-only weight. Both chains are differentiable: as the JAX custom VJPs
do, the backward recomputes the LN statistics from the saved x (the
rounded x' for the residual form) and returns the row grads in the row
dtype, dw in fp32 and the conditioning grads in their own dtype. On CUDA
tensors each forward is one launch of `csrc/adaln.cu` (`fwd_plan` mirrors
`ln_modulate`'s grid) and each backward one call of its backward there
(three launches: the rows, the conditioning sums, dw; `bwd_plan` mirrors
their grid); on CPU tensors the plain versions below run instead.
"""

from __future__ import annotations

import torch

from ddg_tpu_torch.ops import _build

_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _modulate32(x32, w, shift, scale):
    """LN(x32) * w * (1 + scale) + shift in fp32, one-pass moments."""
    m1 = x32.mean(-1, keepdim=True)
    m2 = (x32 * x32).mean(-1, keepdim=True)
    r = torch.rsqrt((m2 - m1 * m1).clamp_min(0.0) + _EPS)
    xn = (x32 - m1) * r
    return (xn * (w.float() * (1.0 + scale.float()[:, None]))
            + shift.float()[:, None])


def ln_modulate_plain(x, w, shift, scale):
    """Plain PyTorch version of `ln_modulate`."""
    return _modulate32(x.float(), w, shift, scale).to(x.dtype)


def gate_res_ln_modulate_plain(y, skip, gate, w, shift, scale):
    """Plain PyTorch version of `gate_res_ln_modulate`; h normalises the
    unrounded fp32 x'."""
    x32 = skip.float() + gate.float()[:, None] * y.float()
    return (x32.to(y.dtype),
            _modulate32(x32, w, shift, scale).to(y.dtype))


def _mod_bwd32(x32, w, scale, dh32):
    """The shared backward of h = LN(x) * w * (1 + scale) + shift in fp32
    (`_mod_bwd`): (dx_ln, dw, dshift, dscale)."""
    m1 = x32.mean(-1, keepdim=True)
    m2 = (x32 * x32).mean(-1, keepdim=True)
    r = torch.rsqrt((m2 - m1 * m1).clamp_min(0.0) + _EPS)
    xn = (x32 - m1) * r
    w32 = w.float()
    sc = scale.float()
    s_dhxn = (dh32 * xn).sum(1)
    dw = (s_dhxn * (1.0 + sc)).sum(0)
    dxn = dh32 * (w32 * (1.0 + sc[:, None]))
    md = dxn.mean(-1, keepdim=True)
    mdx = (dxn * xn).mean(-1, keepdim=True)
    return r * (dxn - md - xn * mdx), dw, dh32.sum(1), s_dhxn * w32


def ln_modulate_bwd_plain(x, w, scale, dh):
    """Plain PyTorch version of `ln_modulate_bwd`."""
    dx, dw, dshift, dscale = _mod_bwd32(x.float(), w, scale, dh.float())
    return (dx.to(x.dtype), dw, dshift.to(scale.dtype),
            dscale.to(scale.dtype))


def gate_res_ln_modulate_bwd_plain(x_new, y, gate, w, scale, dx, dh):
    """Plain PyTorch version of `gate_res_ln_modulate_bwd`."""
    dx_ln, dw, dshift, dscale = _mod_bwd32(x_new.float(), w, scale,
                                           dh.float())
    dx_tot = dx.float() + dx_ln
    dgate = (dx_tot * y.float()).sum(1)
    dy = dx_tot * gate.float()[:, None]
    return (dy.to(y.dtype), dx_tot.to(y.dtype), dgate.to(gate.dtype), dw,
            dshift.to(scale.dtype), dscale.to(scale.dtype))


def _conds(x, *conds):
    """(B, D) conditioning views sharing one row stride (the chunks of the
    adaLN projection), as the kernel reads them; else contiguous copies."""
    dtype, shape = x.dtype, (x.shape[0], x.shape[2])
    if any(tuple(c.shape) != shape for c in conds):
        raise ValueError(f'gate/shift/scale must have shape {shape}')
    if any(c.dtype != dtype for c in conds):
        raise TypeError(f'gate/shift/scale must have the rows\' dtype '
                        f'{dtype}')
    stride = conds[0].stride(0)
    if not all(c.stride(1) == 1 and c.stride(0) == stride
               and c.data_ptr() % 16 == 0 for c in conds):
        conds = tuple(c.contiguous() for c in conds)
        stride = conds[0].stride(0)
    return conds, stride


def _check(x, w, *rows):
    _build.require_cuda(x, w, *rows)
    if any(t.data_ptr() % 16 for t in (x, w, *rows)):
        raise ValueError('the adaLN kernels read 16-byte vectors: rows and '
                         'weight must start 16-byte aligned')
    if tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f'weight must have shape ({x.shape[-1]},)')
    if x.dtype not in _DTYPES or w.dtype != torch.float32:
        raise TypeError(f'adaLN kernels take float32/bfloat16 rows and a '
                        f'float32 weight, got {x.dtype} and {w.dtype}')
    if x.shape[-1] % (16 // x.element_size()):
        raise ValueError('the row width must fill whole 16-byte vectors')


class _LnModulate(torch.autograd.Function):
    """Saves x, w and scale (shift's grad needs only dh)."""

    @staticmethod
    def forward(ctx, x, w, shift, scale):
        ctx.save_for_backward(x, w, scale)
        return _ln_modulate_fwd(x, w, shift, scale)

    @staticmethod
    def backward(ctx, dh):
        x, w, scale = ctx.saved_tensors
        return ln_modulate_bwd(x, w, scale, dh)


class _GateResLnModulate(torch.autograd.Function):
    """Saves x' (as rounded), y, gate, w and scale."""

    @staticmethod
    def forward(ctx, y, skip, gate, w, shift, scale):
        x_new, h = _gate_res_ln_modulate_fwd(y, skip, gate, w, shift, scale)
        ctx.save_for_backward(x_new, y, gate, w, scale)
        return x_new, h

    @staticmethod
    def backward(ctx, dx, dh):
        x_new, y, gate, w, scale = ctx.saved_tensors
        if dx is None:
            dx = torch.zeros_like(x_new)
        if dh is None:
            dh = torch.zeros_like(x_new)
        return gate_res_ln_modulate_bwd(x_new, y, gate, w, scale, dx, dh)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ln_modulate(x, w, shift, scale):
    """h = LN(x) * w * (1 + scale[:, None]) + shift[:, None],
    differentiable in every input. x: (B, L, D); w: (D,) float32;
    shift/scale: (B, D). Without gradients (sampling) the forward runs
    as it is, outside autograd."""
    if _needs_grad(x, w, shift, scale):
        return _LnModulate.apply(x, w, shift, scale)
    return _ln_modulate_fwd(x, w, shift, scale)


# K3's launch (csrc/adaln.cu, `fwd_plan`): blocks of R rows of one batch
# row, R the longest of 128, 64 and 32 that still gives 256 blocks (else
# 32); a row to a team of warps, a lane holding up to 4 16-byte vectors of
# it; 8 warps a block up to teams of 8 warps, one team of up to 32 warps
# past that.
_FWD_TILES = (128, 64, 32)
_FWD_MIN_BLOCKS = 256
_FWD_WARPS = 8
_LANE_VECS = 4


def fwd_plan(B: int, L: int, D: int, esize: int) -> dict:
    """K3's launch for (B, L, D) rows of `esize`-byte elements (csrc
    `ddg_adaln_fwd_plan`; `chip_smoke.py` holds the two equal): a block per
    (b, tile of `rows` rows), `blocks` in all; a row to a team of
    `warps_per_row` warps, lane t of it holding 16-byte vectors t, t + 32
    warps_per_row, ... (`vectors_per_lane`); `teams` teams a block of
    `threads` threads taking its rows in turns; `hold`: 1 where the block
    keeps w (1 + scale) and shift in registers (teams of up to 8 warps),
    0 where it reads them again for each row."""
    N = 16 // esize
    nvec = D // N
    rows = next((r for r in _FWD_TILES[:-1]
                 if B * -(-L // r) >= _FWD_MIN_BLOCKS), _FWD_TILES[-1])
    warps = -(-nvec // (32 * _LANE_VECS))
    hold = warps <= _FWD_WARPS
    teams = _FWD_WARPS // warps if hold else 1
    tiles = -(-L // rows)
    return dict(rows=rows, tiles=tiles, blocks=B * tiles,
                warps_per_row=warps,
                vectors_per_lane=-(-nvec // (32 * warps)), teams=teams,
                threads=teams * warps * 32, hold=int(hold))


def _ln_modulate_fwd(x, w, shift, scale):
    if x.device.type == 'cpu':
        return ln_modulate_plain(x, w, shift, scale)
    B, L, D = x.shape
    _check(x, w)
    (shift, scale), cs = _conds(x, shift, scale)
    _build.require_cuda(x, shift, scale, contiguous=False)
    h = torch.empty_like(x)
    fn = _build.kernel('adaln', 'ddg_ln_modulate',
                       (_build.ptr,) * 5 + (_build.i32,) * 5 + (_build.ptr,))
    rc = fn(x.data_ptr(), w.data_ptr(), shift.data_ptr(), scale.data_ptr(),
            h.data_ptr(), B * L, L, D, cs, _DTYPES[x.dtype],
            _build.stream(x))
    ln_modulate.launches += 1
    _build.check(rc, 'ddg_ln_modulate')
    return h


ln_modulate.launches = 0


def gate_res_ln_modulate(y, skip, gate, w, shift, scale):
    """x' = skip + gate[:, None] * y; h = LN(x') * w * (1 + scale[:, None])
    + shift[:, None]. Returns (x', h), both in y's dtype, differentiable
    in every input. y/skip: (B, L, D); gate/shift/scale: (B, D); w: (D,)
    float32."""
    if _needs_grad(y, skip, gate, w, shift, scale):
        return _GateResLnModulate.apply(y, skip, gate, w, shift, scale)
    return _gate_res_ln_modulate_fwd(y, skip, gate, w, shift, scale)


def _gate_res_ln_modulate_fwd(y, skip, gate, w, shift, scale):
    if y.device.type == 'cpu':
        return gate_res_ln_modulate_plain(y, skip, gate, w, shift, scale)
    B, L, D = y.shape
    _check(y, w, skip)
    if skip.dtype != y.dtype or skip.shape != y.shape:
        raise ValueError('skip and y must share a dtype and a shape')
    (gate, shift, scale), cs = _conds(y, gate, shift, scale)
    _build.require_cuda(y, gate, shift, scale, contiguous=False)
    x_new = torch.empty_like(y)
    h = torch.empty_like(y)
    fn = _build.kernel('adaln', 'ddg_gate_res_ln_modulate',
                       (_build.ptr,) * 8 + (_build.i32,) * 5 + (_build.ptr,))
    rc = fn(y.data_ptr(), skip.data_ptr(), gate.data_ptr(), w.data_ptr(),
            shift.data_ptr(), scale.data_ptr(), x_new.data_ptr(),
            h.data_ptr(), B * L, L, D, cs, _DTYPES[y.dtype],
            _build.stream(y))
    gate_res_ln_modulate.launches += 1
    _build.check(rc, 'ddg_gate_res_ln_modulate')
    return x_new, h


gate_res_ln_modulate.launches = 0


# The backward's launch (csrc/adaln.cu, `bwd_plan`): blocks of 64 rows of
# one batch row; a row to a team of warps, a lane holding up to 4 16-byte
# vectors of each row stream; 8 warps a block; the conditioning sums in
# groups of 8 batch rows.
_BWD_ROWS = 64
_BWD_WARPS = 8
_COND_GROUP = 8


def bwd_plan(B: int, L: int, D: int, esize: int, residual: bool) -> dict:
    """The backward kernels' launch for (B, L, D) rows of `esize`-byte
    elements (csrc `ddg_adaln_bwd_plan`; `chip_smoke.py` holds the two
    equal): a block per (b, tile of `rows` rows); a row to a team of
    `warps_per_row` warps, lane t of it holding 16-byte vectors t, t + 32
    warps_per_row, ... (`vectors_per_lane` of each stream); `teams` teams a
    block of `threads` threads with `smem` bytes of dynamic shared memory
    (w (1 + scale), gate for the residual form, a slice of per-column
    partials a team, P = 2 or 3 of them, and the teams' exchange slots past
    one warp); `groups` conditioning blocks of batch rows; an fp32
    workspace of `workspace` floats: the blocks' partials (P, B, tiles, D)
    and the groups' partial dw (groups, D)."""
    N = 16 // esize
    nvec = D // N
    warps = -(-nvec // (32 * _LANE_VECS))
    vecs = -(-nvec // (32 * warps))
    teams = _BWD_WARPS // warps
    S = vecs * N * 32 * warps
    P = 3 if residual else 2
    tiles, groups = -(-L // _BWD_ROWS), -(-B // _COND_GROUP)
    return dict(rows=_BWD_ROWS, tiles=tiles, groups=groups,
                warps_per_row=warps, vectors_per_lane=vecs, teams=teams,
                threads=teams * warps * 32,
                smem=4 * (S * ((2 if residual else 1) + P * teams)
                          + (teams * 4 * warps if warps > 1 else 0)),
                workspace=(P * B * tiles + groups) * D)


def _bwd_args(x, w, dh, residual, *conds):
    """Checks shared by the backward kernels; returns (dh, conds,
    cond_stride, plan, fp32 workspace) for the launch."""
    B, L, D = x.shape
    dh = dh.to(x.dtype).contiguous()
    _check(x, w, dh)
    conds, cs = _conds(x, *conds)
    _build.require_cuda(x, *conds, contiguous=False)
    if D // (16 // x.element_size()) > _BWD_WARPS * 32 * _LANE_VECS:
        raise ValueError('the adaLN backward kernels take rows of at most '
                         '1024 16-byte vectors')
    plan = bwd_plan(B, L, D, x.element_size(), residual)
    ws = torch.empty((plan['workspace'],), dtype=torch.float32,
                     device=x.device)
    return dh, conds, cs, plan, ws


def ln_modulate_bwd(x, w, scale, dh):
    """Backward of `ln_modulate` for the output gradient dh: (dx, dw,
    dshift, dscale), dx in x's dtype, dw float32, dshift/dscale (B, D)
    contiguous in scale's dtype. On CUDA tensors the kernel's three
    launches (deterministic: `bwd_plan`)."""
    if x.device.type == 'cpu':
        return ln_modulate_bwd_plain(x, w, scale, dh)
    B, L, D = x.shape
    dh, (scale,), cs, plan, ws = _bwd_args(x, w, dh, False, scale)
    dx = torch.empty_like(x)
    dw = torch.empty((D,), dtype=torch.float32, device=x.device)
    dshift, dscale = (torch.empty((B, D), dtype=x.dtype, device=x.device)
                      for _ in range(2))
    fn = _build.kernel('adaln', 'ddg_ln_modulate_bwd',
                       (_build.ptr,) * 9 + (_build.i32,) * 7 + (_build.ptr,))
    rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), dh.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), dshift.data_ptr(),
            dscale.data_ptr(), ws.data_ptr(), B, L, D, cs, plan['tiles'],
            plan['groups'], _DTYPES[x.dtype], _build.stream(x))
    ln_modulate_bwd.launches += 1
    _build.check(rc, 'ddg_ln_modulate_bwd')
    return dx, dw, dshift, dscale


ln_modulate_bwd.launches = 0


def gate_res_ln_modulate_bwd(x_new, y, gate, w, scale, dx, dh):
    """Backward of `gate_res_ln_modulate` for the output gradients (dx,
    dh) of (x', h), from the saved x': (dy, dskip, dgate, dw, dshift,
    dscale), row grads in y's dtype, dw float32, the (B, D) conditioning
    grads contiguous in gate's dtype. On CUDA tensors the kernel's three
    launches (deterministic: `bwd_plan`)."""
    if x_new.device.type == 'cpu':
        return gate_res_ln_modulate_bwd_plain(x_new, y, gate, w, scale, dx,
                                              dh)
    B, L, D = x_new.shape
    dh, (gate, scale), cs, plan, ws = _bwd_args(x_new, w, dh, True, gate,
                                                scale)
    dx = dx.to(x_new.dtype).contiguous()
    _check(x_new, w, y, dx)
    if y.dtype != x_new.dtype or y.shape != x_new.shape:
        raise ValueError("y and x' must share a dtype and a shape")
    dy, dskip = torch.empty_like(x_new), torch.empty_like(x_new)
    dw = torch.empty((D,), dtype=torch.float32, device=x_new.device)
    dgate, dshift, dscale = (torch.empty((B, D), dtype=x_new.dtype,
                                         device=x_new.device)
                             for _ in range(3))
    fn = _build.kernel('adaln', 'ddg_gate_res_ln_modulate_bwd',
                       (_build.ptr,) * 14 + (_build.i32,) * 7
                       + (_build.ptr,))
    rc = fn(x_new.data_ptr(), y.data_ptr(), gate.data_ptr(), w.data_ptr(),
            scale.data_ptr(), dx.data_ptr(), dh.data_ptr(), dy.data_ptr(),
            dskip.data_ptr(), dgate.data_ptr(), dw.data_ptr(),
            dshift.data_ptr(), dscale.data_ptr(), ws.data_ptr(), B, L, D, cs,
            plan['tiles'], plan['groups'], _DTYPES[x_new.dtype],
            _build.stream(x_new))
    gate_res_ln_modulate_bwd.launches += 1
    _build.check(rc, 'ddg_gate_res_ln_modulate_bwd')
    return dy, dskip, dgate, dw, dshift, dscale


gate_res_ln_modulate_bwd.launches = 0
