"""adaLN chains of the DiT block (port of `ddg_tpu/ops/adaln_pallas.py`,
forward only):

    ln_modulate:          h = LN(x) * w * (1 + scale) + shift
    gate_res_ln_modulate: x' = skip + gate * y
                          h  = LN(x') * w * (1 + scale) + shift

LN uses one-pass fp32 moments, the variance clamped at 0, eps 1e-5, and a
scale-only weight. On CUDA tensors each chain is one launch of
`csrc/adaln.cu`; on CPU tensors the plain versions below run instead.
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


def ln_modulate(x, w, shift, scale):
    """h = LN(x) * w * (1 + scale[:, None]) + shift[:, None].
    x: (B, L, D); w: (D,) float32; shift/scale: (B, D)."""
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
    + shift[:, None]. Returns (x', h), both in y's dtype.
    y/skip: (B, L, D); gate/shift/scale: (B, D); w: (D,) float32."""
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
