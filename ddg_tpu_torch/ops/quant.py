"""Dynamic int8 quantized linear layers for inference (port of
`ddg_tpu/ops/quant.py:40-101`).

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
XLA hoists it out of the JAX sampler's scan. Inference only: `DIT`
refuses `train=True` with `quant_int8`.
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


def quantized_weight(weight: torch.Tensor):
    """The int8 codes and fp32 scales (out,) of an (out, in) `nn.Linear`
    weight, quantized once and kept on the tensor until its storage or
    version changes. The codes come zero-padded to what `int8_matmul`
    takes, (out, in) rounded up to multiples of 8, so that no call copies
    them (LM1B's head has 30523 rows)."""
    key = (weight.data_ptr(), weight._version, weight.dtype,
           weight.device, tuple(weight.shape))
    hit = getattr(weight, '_ddg_int8', None)
    if hit is not None and hit[0] == key:
        return hit[1], hit[2]
    N, K = weight.shape
    with torch.no_grad():
        q, scale = quantize_rowwise(weight)
        q = F.pad(q, (0, _up8(K) - K, 0, _up8(N) - N))
    weight._ddg_int8 = (key, q, scale[:, 0])
    return q, scale[:, 0]


def int8_linear(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """`int8_dense` on an (out, in) `nn.Linear` weight, its quantization
    reused across calls (`quantized_weight`)."""
    wq, ws = quantized_weight(weight)
    N = weight.shape[0]
    xq, xs = quantize_rowwise(x)
    acc = int8_matmul(xq.reshape(-1, x.shape[-1]), wq)[:, :N]
    acc = acc.reshape(*x.shape[:-1], N)
    return rescale(acc, xs, ws, bias, out_dtype or x.dtype)


class QLinear(nn.Linear):
    """Drop-in for `nn.Linear` with int8 dynamic-quant compute (the JAX
    `QDense`): the same parameters, dtypes and state-dict keys, so a
    checkpoint of the float model loads unchanged. The output is in the
    weight's dtype, as `nn.Linear`'s (`QDense`'s `dtype`)."""

    def forward(self, x):
        return int8_linear(x, self.weight, self.bias, self.weight.dtype)
