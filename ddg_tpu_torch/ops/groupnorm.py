"""GroupNorm with optional SiLU over channels-last activations (port of
`ddg_tpu/ops/groupnorm_pallas.py`, the UNet's norms):

    mean_g = E[x], var_g = max(E[x^2] - E[x]^2, 0) over (H, W, channels of g)
    y      = (x - mean_g) * (rsqrt(var_g + eps) * scale) + bias
    y      = y * sigmoid(y)                                  (act=True)

in fp32, written in `out_dtype`: flax's GroupNorm statistics, which the
TPU kernel keeps. On CUDA tensors each call is one launch of
`csrc/groupnorm.cu`: a sample's slab held in the shared memory of one
block or of a cluster of up to 16 (`plan`), x read once; a slab that 16
blocks do not hold runs a partial-sums kernel, then the normalize kernel.
On CPU tensors the plain version below runs instead. Inference only, as
the TPU kernel is.
"""

from __future__ import annotations

import functools

import torch

from ddg_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Elements of x a block of the two-kernel path covers (whole pixels).
_CHUNK_ELEMS = 8192
_MAX_GROUPS = 2048
# Channels a thread of the kernels owns (8), times its 256 threads.
_MAX_CHANNELS = 2048
# The slab path (csrc `make_plan`): blocks of a sample up to 16 (a
# cluster, non-portable past 8), x a block holds where fewer blocks cannot,
# the per-thread sums' scratch (256 threads x 8 channels, twice, fp32), the
# bulk copies' mbarriers, and the card's shared memory a block.
_MAX_CLUSTER = 16
_SLAB_BYTES = 32 << 10
_SCRATCH = 2 * 256 * 8 * 4
_MAX_PIECES = 16
_SMEM_MAX = 232448


@functools.cache
def plan(HW: int, C: int, G: int, in_size: int) -> tuple[int, int, int, int]:
    """How the card runs a call of HW pixels, C channels and G groups with
    x of `in_size` bytes an element, from the shape alone: (1, cluster,
    pixels a block, shared memory a block), a sample's slab on chip in the
    fewest blocks (a power of two up to 16) that keep each block's x within
    32 KB, or within the card's shared memory at 16; else (2, 0, 0, 0), the
    two kernels. Mirrors csrc `make_plan` (`ddg_group_norm_plan`)."""
    cs = 1
    while cs <= _MAX_CLUSTER:
        pix = -(-HW // cs)
        nbytes = pix * C * in_size
        if nbytes <= _SLAB_BYTES or cs == _MAX_CLUSTER:
            smem = -(-nbytes // 16) * 16 + _SCRATCH + 8 * G + 8 * _MAX_PIECES
            if smem <= _SMEM_MAX:
                return 1, cs, pix, smem
        cs *= 2
    return 2, 0, 0, 0


def fused_group_norm_act_plain(x, scale, bias, *, num_groups: int,
                               eps: float = 1e-6, act: bool = False,
                               out_dtype=None):
    """Plain PyTorch version of `fused_group_norm_act`."""
    N, H, W, C = x.shape
    G = num_groups
    gs = C // G
    x32 = x.float().reshape(N, H * W, G, gs)
    n = H * W * gs
    mean = x32.sum((1, 3)) / n
    var = ((x32 * x32).sum((1, 3)) / n - mean * mean).clamp_min(0.0)
    rinv = torch.rsqrt(var + eps)
    y = ((x32 - mean[:, None, :, None])
         * (rinv[:, None, :, None] * scale.float().reshape(G, gs))
         + bias.float().reshape(G, gs))
    if act:
        y = y * torch.sigmoid(y)
    return y.reshape(N, H, W, C).to(out_dtype or x.dtype)


def fused_group_norm_act(x, scale, bias, *, num_groups: int,
                         eps: float = 1e-6, act: bool = False,
                         out_dtype=None):
    """GroupNorm (+ SiLU) in one call.

    x: (N, H, W, C) float32 or bfloat16, contiguous (channels last), with
    C a multiple of 8 up to 2048 on the card; scale, bias: (C,) float32;
    C % num_groups == 0. Returns (N, H, W, C)
    in out_dtype (float32 or bfloat16; default x.dtype)."""
    if x.device.type == 'cpu':
        return fused_group_norm_act_plain(x, scale, bias,
                                          num_groups=num_groups, eps=eps,
                                          act=act, out_dtype=out_dtype)
    _build.require_cuda(x, scale, bias)
    N, H, W, C = x.shape
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError('x and out_dtype must be float32 or bfloat16')
    if (scale.dtype != torch.float32 or bias.dtype != torch.float32
            or tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,)):
        raise ValueError('scale and bias must be (C,) float32')
    if C % num_groups or not 0 < num_groups <= _MAX_GROUPS:
        raise ValueError(f'{num_groups} groups do not divide C={C} or '
                         f'exceed {_MAX_GROUPS}')
    if C % 8 or C > _MAX_CHANNELS:
        raise ValueError(f'C={C}: the kernel takes a multiple of 8 channels '
                         f'up to {_MAX_CHANNELS}')
    if x.data_ptr() % 16:
        raise ValueError('x must be 16-byte aligned')
    HW = H * W
    chunk = min(HW, max(1, _CHUNK_ELEMS // C))
    n_chunks = -(-HW // chunk)
    partial = None
    if plan(HW, C, num_groups, x.element_size())[0] == 2:
        partial = torch.empty((N, n_chunks, num_groups, 2),
                              dtype=torch.float32, device=x.device)
    y = torch.empty((N, H, W, C), dtype=out_dtype, device=x.device)
    fn = _build.kernel('groupnorm', 'ddg_group_norm',
                       (_build.ptr,) * 5 + (_build.i32,) * 6 + (_build.f32,)
                       + (_build.i32,) * 3 + (_build.ptr,))
    rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if partial is None else partial.data_ptr(), y.data_ptr(),
            N, HW, C, num_groups, chunk, n_chunks, float(eps), int(act),
            _DTYPES[x.dtype], _DTYPES[out_dtype], _build.stream(x))
    fused_group_norm_act.launches += 1
    _build.check(rc, 'ddg_group_norm')
    return y


fused_group_norm_act.launches = 0
