"""UNet denoiser for discretized images (port of `ddg_tpu/models/unet.py`,
inference, int8 inference and training).

The token interface is the JAX module's: a flat (B, C*H*W) sequence of
pixel values in CHW order goes in, (B, C*H*W, vocab_size) float32 logits of
a truncated discretized-logistic head come out in the same order. The
trunk is channels-last: activations are contiguous (B, H, W, C) tensors,
which the convolutions see as NCHW views in `torch.channels_last` memory
format, so no layout copies happen between a norm and a conv.

Submodules carry the flax module names (`conv_in`, `down_{s}_{r}.norm0`,
`down_attn_{s}_{r}.q`, `mid_res0`, `up_{s}_{r}`, `norm_out`, ...), and
`convert.unet_state_dict_from_jax` maps the JAX params onto them.

Dtypes follow the JAX module's policy: the convs, denses, NiN projections
and attention products run in `compute_dtype` and hold their weights in
it (what flax's per-call cast produces); the GroupNorms compute in fp32
and write `norm_dtype`; `norm_out`, `conv_out` and the logistic head are
fp32. Attention scores are bf16 products summed in fp32, softmax is fp32,
and the probabilities are cast to `compute_dtype` for the PV product.

`fused_norm=True` runs every GroupNorm through `ops.groupnorm` (the Hopper
kernel on CUDA tensors, its plain version on CPU tensors);
`fused_norm=False` runs the plain version everywhere, the counterpart of
flax's XLA GroupNorm.

`quant_int8=True` (inference only, as in `ddg_tpu`) runs the 3x3 convs
(conv_in, both convs of every ResBlock, the Downsample and Upsample convs:
51 at full width) through `ops.quant.QConv` and the NiN projections (the
attention's q, k, v, out and the ResBlock shortcuts: 37) through
`ops.quant.int8_linear`, with the same parameters and state-dict keys.
Those layers hold float32 weights and biases whatever `compute_dtype` is,
as the JAX params are, and write `compute_dtype`. conv_out, the time
embedding's and temb_proj's denses and the class table stay float.

`train=True` applies dropout (rate `cfg.dropout`) after `norm1`, before
`conv1`, in every ResBlock, where the JAX block has it, with masks drawn
from the `rng` generator (keep with probability 1 - p, scale by 1 / (1 -
p); the masks are not JAX's bits), and runs every GroupNorm through its
plain version under autograd, as JAX runs flax's GroupNorm when training
(the kernel has no backward).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ddg_tpu_torch.models.dit import dropout
from ddg_tpu_torch.ops import groupnorm, quant


def transformer_timestep_embedding(t: torch.Tensor, dim: int,
                                   max_positions: float = 10_000.0):
    """[sin, cos] features with a (half - 1) frequency denominator (not the
    DiT's embedding), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_positions) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    ch: int = 128
    num_res_blocks: int = 2
    num_scales: int = 4
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    input_channels: int = 3
    scale_count_to_put_attn: int = 1
    dropout: float = 0.1
    skip_rescale: bool = True
    time_scale_factor: int = 1000
    time_conditioning: bool = True
    fix_logistic: bool = False
    vocab_size: int = 256
    image_size: int = 32
    num_classes: Optional[int] = None
    compute_dtype: torch.dtype = torch.float32
    quant_int8: bool = False
    norm_dtype: torch.dtype = torch.float32
    fused_norm: bool = False
    # The JAX package's interpret switch, kept for the config's shape: the
    # port's wrappers choose by the tensors' device, so True is refused.
    pallas_interpret: bool = False

    def __post_init__(self):
        if self.pallas_interpret:
            raise ValueError(
                'UNetConfig.pallas_interpret: the port has no interpret '
                'mode; a kernel runs its plain version on CPU tensors')

    @property
    def time_embed_dim(self) -> int:
        return self.ch

    @property
    def length(self) -> int:
        """Tokens of an image: C * H * W."""
        return self.input_channels * self.image_size ** 2


def _conv(conv: nn.Conv2d, x, *, stride: int = 1, padding: int = 1):
    """A conv on channels-last (B, H, W, C) activations, in the conv's
    dtype; returns (B, H', W', C'). A `QConv` quantizes x as it is and
    takes its own stride and padding, which are these."""
    if isinstance(conv, quant.QConv):
        return conv(x)
    x = x.to(conv.weight.dtype).permute(0, 3, 1, 2)
    return F.conv2d(x, conv.weight, conv.bias, stride, padding).permute(
        0, 2, 3, 1)


@functools.cache
def _sqrt2(dtype) -> float:
    """sqrt(2) rounded to `dtype`, as flax's np.array(sqrt(2), dtype)."""
    return torch.tensor(math.sqrt(2.0), dtype=dtype).item()


def _skip_rescale(out, enabled: bool):
    return out / _sqrt2(out.dtype) if enabled else out


class NiN(nn.Module):
    """1x1 projection x @ W + b, W stored (in, out) as flax stores it; with
    `int8`, float32 W and b and `int8_dense`'s compute, written in
    `dtype`."""

    def __init__(self, cin: int, cout: int, dtype, int8: bool = False):
        super().__init__()
        self.int8, self.dtype = int8, dtype
        pdt = torch.float32 if int8 else dtype
        self.W = nn.Parameter(torch.zeros(cin, cout, dtype=pdt))
        self.b = nn.Parameter(torch.zeros(cout, dtype=pdt))

    def forward(self, x):
        if self.int8:
            return quant.int8_linear(x, self.W, self.b, self.dtype,
                                     layout='in_out')
        return F.linear(x.to(self.W.dtype), self.W.t(), self.b)


class GNorm(nn.Module):
    """GroupNorm (+ SiLU with `act`) over channels-last activations."""

    def __init__(self, channels: int, num_groups: int, *, dtype, act=False,
                 fused=False, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.dtype, self.fused = dtype, fused

    def forward(self, x, train: bool = False):
        fn = (groupnorm.fused_group_norm_act if self.fused and not train
              else groupnorm.fused_group_norm_act_plain)
        return fn(x.contiguous(), self.scale, self.bias,
                  num_groups=self.num_groups, eps=self.eps, act=self.act,
                  out_dtype=self.dtype)


def _conv_cls(cfg: UNetConfig):
    """The 3x3 convs' class: `nn.Conv2d` or its int8 drop-in."""
    return quant.QConv if cfg.quant_int8 else nn.Conv2d


def _gnorm(cfg: UNetConfig, channels: int, act: bool, dtype=None):
    return GNorm(channels, min(channels // 4, 32),
                 dtype=dtype or cfg.norm_dtype, act=act, fused=cfg.fused_norm)


class AttnBlock(nn.Module):
    """Spatial self-attention over H*W with one head of width C."""

    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        cd, q8 = cfg.compute_dtype, cfg.quant_int8
        self.skip_rescale = cfg.skip_rescale
        self.norm = _gnorm(cfg, channels, act=False)
        self.q = NiN(channels, channels, cd, q8)
        self.k = NiN(channels, channels, cd, q8)
        self.v = NiN(channels, channels, cd, q8)
        self.out = NiN(channels, channels, cd, q8)

    def forward(self, x, train: bool = False):
        B, H, W, C = x.shape
        h = self.norm(x, train)
        q, k, v = (m(h).reshape(B, H * W, C) for m in (self.q, self.k, self.v))
        w = torch.bmm(q.float(), k.float().transpose(1, 2)) * (C ** -0.5)
        w = torch.softmax(w, dim=-1).to(v.dtype)
        h = self.out(torch.bmm(w, v).reshape(B, H, W, C))
        return _skip_rescale(x.to(h.dtype) + h, self.skip_rescale)


class ResBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int):
        super().__init__()
        cd, Conv = cfg.compute_dtype, _conv_cls(cfg)
        self.skip_rescale, self.dropout = cfg.skip_rescale, cfg.dropout
        self.norm0 = _gnorm(cfg, in_ch, act=True)
        self.conv0 = Conv(in_ch, out_ch, 3, padding=1, dtype=cd)
        if cfg.time_conditioning or cfg.num_classes is not None:
            self.temb_proj = nn.Linear(4 * cfg.time_embed_dim, out_ch,
                                       dtype=cd)
        self.norm1 = _gnorm(cfg, out_ch, act=True)
        self.conv1 = Conv(out_ch, out_ch, 3, padding=1, dtype=cd)
        if in_ch != out_ch:
            self.shortcut = NiN(in_ch, out_ch, cd, cfg.quant_int8)

    def forward(self, x, temb, train: bool = False, rng=None):
        h = _conv(self.conv0, self.norm0(x, train))
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb))[:, None, None, :]
        h = dropout(self.norm1(h, train), self.dropout, train=train,
                    generator=rng)
        h = _conv(self.conv1, h)
        if hasattr(self, 'shortcut'):
            x = self.shortcut(x)
        return _skip_rescale(x.to(h.dtype) + h, self.skip_rescale)


class Downsample(nn.Module):
    """Asymmetric (0, 1) padding of H and W, then a VALID stride-2 conv."""

    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        self.conv = _conv_cls(cfg)(channels, channels, 3, stride=2,
                                   dtype=cfg.compute_dtype)

    def forward(self, x):
        return _conv(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2,
                     padding=0)


class Upsample(nn.Module):
    """Nearest-neighbour x2, then a 3x3 conv."""

    def __init__(self, cfg: UNetConfig, channels: int):
        super().__init__()
        self.conv = _conv_cls(cfg)(channels, channels, 3, padding=1,
                                   dtype=cfg.compute_dtype)

    def forward(self, x):
        B, H, W, C = x.shape
        h = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
        return _conv(self.conv, h.reshape(B, 2 * H, 2 * W, C))


def log_minus_exp(a, b, eps: float = 1e-6):
    """log(exp(a) - exp(b)) for b < a."""
    return a + torch.log1p(-torch.exp(b - a) + eps)


def truncated_logistic_logits(mu, log_scale, *, vocab_size: int,
                              fix_logistic: bool):
    """Truncated discretized-logistic bin log-probs. mu, log_scale:
    (B, H, W, C); returns (B, C*H*W, S) float32 in flat CHW token order."""
    S = vocab_size
    mu = mu[..., None].float()
    inv_scale = torch.exp(-(log_scale[..., None].float() - 2))
    bin_width = 2.0 / S
    centers = torch.linspace(-1 + bin_width / 2, 1 - bin_width / 2, S,
                             device=mu.device)
    sig_in_left = (centers - bin_width / 2 - mu) * inv_scale
    left_logcdf = F.logsigmoid(sig_in_left)
    sig_in_right = (centers + bin_width / 2 - mu) * inv_scale
    right_logcdf = F.logsigmoid(sig_in_right)
    logits = log_minus_exp(right_logcdf, left_logcdf)
    if fix_logistic:
        logits = torch.minimum(logits, log_minus_exp(
            -sig_in_left + left_logcdf, -sig_in_right + right_logcdf))
    B, H, W, C, _ = logits.shape
    return logits.permute(0, 3, 1, 2, 4).reshape(B, C * H * W, S)


class UNet(nn.Module):
    """Denoiser: (B, C*H*W) token ids, sigma (B,), optional class ids ->
    (B, C*H*W, vocab_size) float32 logits."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        cd, ch = cfg.compute_dtype, cfg.ch
        temb_dim = 4 * cfg.time_embed_dim
        if cfg.time_conditioning:
            self.temb0 = nn.Linear(cfg.time_embed_dim, temb_dim, dtype=cd)
            self.temb1 = nn.Linear(temb_dim, temb_dim, dtype=cd)
        if cfg.num_classes is not None:
            self.cond_map = nn.Embedding(cfg.num_classes + 1, temb_dim,
                                         dtype=cd)
        self.conv_in = _conv_cls(cfg)(cfg.input_channels, ch, 3, padding=1,
                                      dtype=cd)
        attn = cfg.scale_count_to_put_attn
        cur, skips = ch, [ch]
        for s in range(cfg.num_scales):
            for r in range(cfg.num_res_blocks):
                out = ch * cfg.ch_mult[s]
                self.add_module(f'down_{s}_{r}', ResBlock(cfg, cur, out))
                cur = out
                if s == attn:
                    self.add_module(f'down_attn_{s}_{r}', AttnBlock(cfg, cur))
                skips.append(cur)
            if s != cfg.num_scales - 1:
                self.add_module(f'downsample_{s}', Downsample(cfg, cur))
                skips.append(cur)
        self.mid_res0 = ResBlock(cfg, cur, cur)
        self.mid_attn = AttnBlock(cfg, cur)
        self.mid_res1 = ResBlock(cfg, cur, cur)
        for s in reversed(range(cfg.num_scales)):
            for r in range(cfg.num_res_blocks + 1):
                out = ch * cfg.ch_mult[s]
                self.add_module(f'up_{s}_{r}',
                                ResBlock(cfg, cur + skips.pop(), out))
                cur = out
                if s == attn:
                    self.add_module(f'up_attn_{s}_{r}', AttnBlock(cfg, cur))
            if s != 0:
                self.add_module(f'upsample_{s}', Upsample(cfg, cur))
        self.norm_out = _gnorm(cfg, cur, act=True, dtype=torch.float32)
        self.conv_out = nn.Conv2d(cur, 2 * cfg.input_channels, 3, padding=1)
        self.to(memory_format=torch.channels_last)

    def forward(self, x, sigma, cond=None, x_emb=None, *, train: bool = False,
                rng=None, return_hidden_states: bool = False):
        cfg = self.cfg
        if cfg.quant_int8 and train:
            raise ValueError(
                'quant_int8 is an inference-only transform (rounding kills '
                'gradients); train with it off and turn it on for sampling')
        cd = cfg.compute_dtype
        img, C = cfg.image_size, cfg.input_channels
        B = x.shape[0]
        # flat CHW tokens -> NHWC image in [-1, 1)
        h = x.reshape(B, C, img, img).permute(0, 2, 3, 1)
        centered_x_in = 2 * (h.float() / cfg.vocab_size) - 1

        temb = None
        if cfg.time_conditioning and sigma is not None:
            temb = transformer_timestep_embedding(
                sigma * cfg.time_scale_factor, cfg.time_embed_dim)
            temb = self.temb1(F.silu(self.temb0(temb.to(cd))))
        if cond is not None:
            if cfg.num_classes is None:
                raise ValueError('Conditioning provided but num_classes is '
                                 'None')
            ce = self.cond_map(cond.long())
            temb = ce if temb is None else temb + ce

        h = _conv(self.conv_in, centered_x_in)
        hs = [h]
        attn = cfg.scale_count_to_put_attn
        for s in range(cfg.num_scales):
            for r in range(cfg.num_res_blocks):
                h = getattr(self, f'down_{s}_{r}')(h, temb, train, rng)
                if s == attn:
                    h = getattr(self, f'down_attn_{s}_{r}')(h, train)
                hs.append(h)
            if s != cfg.num_scales - 1:
                h = getattr(self, f'downsample_{s}')(h)
                hs.append(h)
        h = self.mid_res0(h, temb, train, rng)
        h = self.mid_res1(self.mid_attn(h, train), temb, train, rng)
        for s in reversed(range(cfg.num_scales)):
            for r in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, hs.pop().to(h.dtype)], dim=-1)
                h = getattr(self, f'up_{s}_{r}')(h, temb, train, rng)
                if s == attn:
                    h = getattr(self, f'up_attn_{s}_{r}')(h, train)
            if s != 0:
                h = getattr(self, f'upsample_{s}')(h)

        h = _conv(self.conv_out, self.norm_out(h, train))
        # tanh-residual mean parameterization
        mu = torch.tanh(centered_x_in + h[..., :C].float())
        logits = truncated_logistic_logits(
            mu, h[..., C:], vocab_size=cfg.vocab_size,
            fix_logistic=cfg.fix_logistic)
        if return_hidden_states:
            return logits, h
        return logits
