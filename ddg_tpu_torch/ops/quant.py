"""Dynamic int8 quantized linear and conv layers for inference (port of
`ddg_tpu/ops/quant.py`).

Symmetric absmax quantization:
  * weights per output channel (one fp32 scale per row of an (out, in)
    `nn.Linear` weight, i.e. per column of the JAX (in, out) kernel);
  * activations per token row (one fp32 scale per (..., in) row);
  * scale = where(absmax > 0, absmax, 1) / 127, codes round(x / scale)
    half to even, clipped to +-127;
  * an s8 x s8 -> s32 product, rescaled in fp32 as (acc * x_scale) *
    w_scale, then + bias in fp32, then cast to the output dtype, in that
    order.

The s32 product is one plain matrix product outside any kernel of the
port (the JAX package leaves it to XLA's `dot_general`): `torch._int_mm`,
which on the card is cuBLASLt's int8 GEMM. That call wants more than 16
rows and inner and outer sizes that are multiples of 8, so `int8_matmul`
pads with zero rows and columns (exact: zero codes add zero to an int32
sum) and slices the result.

A weight's quantization is loop-invariant: `quantized_weight` keeps the
codes and scales on the weight tensor and reuses them until the tensor's
storage or version changes (an in-place update, `load_state_dict`), as
XLA hoists it out of the JAX sampler's scan. Inference only: `DIT` and
`UNet` refuse `train=True` with `quant_int8`.

The conv (`int8_conv2d`, `QConv`, the UNet's) scales activations per sample
over (H, W, C) and weights per output channel over (kh, kw, Cin). PyTorch
has no int8 convolution on CUDA, and a float conv of the codes could
round (a sum reaches 127 x 127 x 2304, past float32's 2^24, and cuDNN may
use TF32), so the s32 convolution is an im2col of the codes (the kh x kw
shifted views concatenated along channels) times the weight codes in one
`int8_matmul`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """where(absmax > 0, absmax, 1) / 127 as an IEEE division. (PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, which
    rounds differently; a device tensor divisor divides.)"""
    return (torch.where(absmax > 0, absmax, torch.ones_like(absmax))
            / absmax.new_full((), 127.0))


def quantize_rowwise(x: torch.Tensor):
    """Symmetric int8 over the last axis: (q, scale) with x ~= q * scale,
    scale of shape x.shape[:-1] + (1,), fp32."""
    x32 = x.float()
    scale = _scale(x32.abs().amax(-1, keepdim=True))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_colwise(w: torch.Tensor):
    """Symmetric int8 per output channel of an (in, out) kernel: (q,
    scale) with w ~= q * scale, scale of shape (out,), fp32."""
    w32 = w.float()
    scale = _scale(w32.abs().amax(0))
    q = torch.clamp(torch.round(w32 / scale[None]), -127, 127).to(torch.int8)
    return q, scale


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matmul(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8 times wq_t (N, K) int8, transposed: (M, N) int32,
    through `torch._int_mm` on operands zero-padded to what it takes (M >
    16, K and N multiples of 8). wq_t may come padded already
    (`quantized_weight`): K columns up to the next multiple of 8."""
    M, K = xq.shape
    N, Kw = wq_t.shape
    Mp, Kp, Np = max(_up8(M), 24), _up8(max(K, Kw)), _up8(N)
    if (Mp, Kp) != (M, K):
        xq = F.pad(xq, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, Kw):
        wq_t = F.pad(wq_t, (0, Kp - Kw, 0, Np - N))
    acc = torch._int_mm(xq, wq_t.t())
    return acc[:M, :N] if (Mp, Np) != (M, N) else acc


def rescale(acc, x_scale, w_scale, bias, out_dtype):
    """(acc * x_scale) * w_scale + bias in fp32, cast to `out_dtype`."""
    y = acc.float() * x_scale * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_dense(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ kernel (+ bias) with both operands quantized to int8 and an
    int32 product. x: (..., in); kernel: (in, out), the JAX layout; bias:
    (out,) or None. Output in `out_dtype` (default x.dtype)."""
    xq, xs = quantize_rowwise(x)
    wq, ws = quantize_colwise(kernel)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), wq.t())
    acc = acc.reshape(*x.shape[:-1], kernel.shape[1])
    return rescale(acc, xs, ws, bias, out_dtype or x.dtype)


# How each layout of a weight tensor reads as (out, in) rows: an
# `nn.Linear` weight (out, in), a JAX-layout kernel (in, out) such as the
# UNet NiN's `W`, and a conv weight (Cout, Cin, kh, kw), whose rows run
# over (kh, kw, Cin), the order of `im2col`'s columns.
_ROWS = {
    'out_in': lambda w: w,
    'in_out': lambda w: w.t(),
    'conv': lambda w: w.permute(0, 2, 3, 1).reshape(w.shape[0], -1),
}


def quantized_weight(weight: torch.Tensor, layout: str = 'out_in'):
    """The int8 codes (out, in) and fp32 scales (out,) of a weight whose
    rows are read as `layout` says (_ROWS), quantized once and kept on the
    tensor until its storage or version changes. The codes come
    zero-padded to what `int8_matmul` takes, (out, in) rounded up to
    multiples of 8, so that no call copies them (LM1B's head has 30523
    rows; the UNet's conv_in has 27 columns)."""
    key = (layout, weight.data_ptr(), weight._version, weight.dtype,
           weight.device, tuple(weight.shape))
    hit = getattr(weight, '_ddg_int8', None)
    if hit is not None and hit[0] == key:
        return hit[1], hit[2]
    with torch.no_grad():
        rows = _ROWS[layout](weight)
        N, K = rows.shape
        q, scale = quantize_rowwise(rows)
        q = F.pad(q, (0, _up8(K) - K, 0, _up8(N) - N)).contiguous()
    weight._ddg_int8 = (key, q, scale[:, 0])
    return q, scale[:, 0]


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None,
                layout: str = 'out_in') -> torch.Tensor:
    """`int8_dense` on an (out, in) `nn.Linear` weight (or an (in, out)
    kernel with layout='in_out'), its quantization reused across calls
    (`quantized_weight`)."""
    wq, ws = quantized_weight(weight, layout)
    N = ws.shape[0]
    xq, xs = quantize_rowwise(x)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), wq)[:, :N]
    acc = acc.reshape(*x.shape[:-1], N)
    return rescale(acc, xs, ws, bias, out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# int8 convolutions (port of `ddg_tpu/ops/quant.py:104-163`)
# ---------------------------------------------------------------------------

def quantize_per_sample(x: torch.Tensor):
    """Symmetric int8 over all but the first axis of x (B, H, W, C): (q,
    scale) with x ~= q * scale, scale (B, 1, 1, 1) fp32. A conv sums over
    the spatial taps, through which per-pixel scales do not factor."""
    x32 = x.float()
    scale = _scale(x32.abs().amax(dim=(1, 2, 3), keepdim=True))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def im2col(xq: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """The (B * H' * W', kh * kw * C) patches of channels-last codes xq (B,
    H, W, C), zero-padded by `padding` on each side: for each output pixel
    the kh x kw taps in row order, each tap's C channels contiguous (the
    rows of a 'conv' layout weight)."""
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    B, H, W, C = xq.shape
    Ho, Wo = (H - kh) // stride + 1, (W - kw) // stride + 1
    taps = [xq[:, dy:dy + stride * (Ho - 1) + 1:stride,
               dx:dx + stride * (Wo - 1) + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    return torch.cat(taps, dim=-1).reshape(B * Ho * Wo, kh * kw * C)


def int8_conv_acc(xq: torch.Tensor, wq: torch.Tensor, kh: int, kw: int,
                  n_out: int, *, stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """The exact s8 x s8 -> s32 convolution of channels-last codes xq (B,
    H, W, Cin) with weight codes wq (Cout, kh * kw * Cin) in 'conv' row
    order (as `quantized_weight` pads them): (B, H', W', n_out) int32, one
    `int8_matmul` of the im2col patches."""
    B, H, W, _ = xq.shape
    Ho = (H + 2 * padding - kh) // stride + 1
    Wo = (W + 2 * padding - kw) // stride + 1
    acc = int8_matmul(im2col(xq, kh, kw, stride, padding), wq)
    return acc[:, :n_out].reshape(B, Ho, Wo, n_out)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, stride: int = 1,
                padding: int = 0,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Channels-last conv with both operands quantized to int8 and an
    int32 convolution, as `ddg_tpu.ops.quant.int8_conv`: x (B, H, W, Cin)
    with one scale per sample; a (Cout, Cin, kh, kw) `nn.Conv2d` weight
    (JAX's HWIO kernel permuted (3, 2, 0, 1)) with one scale per output
    channel over (kh, kw, Cin), its quantization reused across calls
    (`quantized_weight`); then (acc * x_scale) * w_scale + bias in fp32,
    cast to `out_dtype` (default x.dtype): (B, H', W', Cout). `padding`
    zero-pads each side (JAX's `padding=p`; 0 is 'VALID')."""
    wq, ws = quantized_weight(weight, 'conv')
    xq, xs = quantize_per_sample(x)
    acc = int8_conv_acc(xq, wq, weight.shape[2], weight.shape[3],
                        weight.shape[0], stride=stride, padding=padding)
    return rescale(acc, xs, ws, bias, out_dtype or x.dtype)


class QConv(nn.Conv2d):
    """Drop-in for the UNet's `nn.Conv2d` with int8 dynamic-quant compute
    (the JAX `QConv`): the same parameters and state-dict keys, float32
    whatever `dtype` is, as `QConv`'s flax params are; `dtype` sets the
    output dtype only (float32 when None). Its forward takes and returns
    channels-last (B, H, W, C) activations, unlike `nn.Conv2d`'s."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, bias=bias,
                         device=device, dtype=torch.float32)
        self.out_dtype = dtype or torch.float32

    def forward(self, x):
        return int8_conv2d(x, self.weight, self.bias, stride=self.stride[0],
                           padding=self.padding[0],
                           out_dtype=self.out_dtype)


class QLinear(nn.Linear):
    """Drop-in for `nn.Linear` with int8 dynamic-quant compute (the JAX
    `QDense`): the same parameters and state-dict keys, so a checkpoint of
    the float model loads unchanged. The weight and bias are float32
    whatever `dtype` is, as `QDense`'s flax params are, so the codes are
    those of the float32 weight; `dtype` sets the output dtype only
    (`QDense`'s `dtype`; float32 when None)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device=device,
                         dtype=torch.float32)
        self.out_dtype = dtype or torch.float32

    def forward(self, x):
        return int8_linear(x, self.weight, self.bias, self.out_dtype)
