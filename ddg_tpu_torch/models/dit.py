"""Diffusion Transformer (DiT) denoiser and classifier (port of
`ddg_tpu/models/dit.py`, inference and training).

Parameter names are the reference torch DIT's (`vocab_embed.embedding`,
`blocks.{i}.attn_qkv.weight`, `blocks.{i}.mlp.0.weight`,
`output_layer.linear.weight`, ...), so `convert.dit_state_dict_from_jax`
and reference checkpoints load with `strict=True`.

Dtypes follow the JAX module's policy. The layers flax runs in
`compute_dtype` (adaLN projections, qkv, attention out, MLP) hold their
weights in that dtype, which is what flax's per-call cast produces; the
vocab head holds `logits_dtype`. Embeddings, the sigma and class maps, the
norm weights and the final adaLN projection stay float32: the final adaLN
weight is cast to `compute_dtype` inside the forward, as flax does, and
used in float32 by `dit_head_features`, as `ddg_tpu` does.

Attention takes the JAX block's routes in its order: `tpu_flash_attn=True`
rotates q and k in plain PyTorch and runs `ops.flash_attention` (K20, and
K21/K22 for its gradient: the port of the TPU library flash attention, with
sm_scale 1/sqrt(head_dim)); else `fused_rope_attn=True` runs
`ops.attention`'s K1 (RoPE inside the kernel); else `pallas_attention=True`
rotates q and k and runs `ops.attention`'s K2, as `ddg_tpu` runs its
short-sequence kernel; else plain PyTorch attention, which with
`attn_probs_bf16=True` is `einsum_attention` (fp32 scores and softmax, the
probabilities rounded to bf16 before PV) and with `attn_remat=True` runs
under `torch.utils.checkpoint` (recomputed in the backward).
`fused_adaln=True` runs the block-entry and attention->MLP adaLN chains and
the final norm through `ops.adaln`. On CUDA tensors these are the Hopper
kernels (forward and backward), on CPU tensors their plain versions.
`quant_int8=True` (inference only, as in `ddg_tpu`) runs the four big trunk
products and the vocab head through `ops.quant.QLinear` (int8 dynamic
quantization, same parameters and state-dict keys). Those layers hold
float32 weights and biases whatever `compute_dtype` is, as `QDense`'s
flax params are, so their codes are those of the float32 weights; their
outputs are in `compute_dtype` (the head's in `logits_dtype`). The adaLN
projections stay in `compute_dtype`. The JAX-only branch (tensor/sequence/ring
parallelism) raises NotImplementedError when set.

`train=True` applies dropout (rate `cfg.dropout`) after the attention
output projection and after the MLP, where the JAX block has it, with
masks drawn from the `rng` generator: keep with probability 1 - p and
scale by 1 / (1 - p), as flax's Dropout. The masks are not JAX's bits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ddg_tpu_torch.ops import adaln
from ddg_tpu_torch.ops import attention
from ddg_tpu_torch.ops import flash_attention
from ddg_tpu_torch.ops import quant


@dataclasses.dataclass(frozen=True)
class DITConfig:
    hidden_size: int = 768
    cond_dim: int = 128
    length: int = 1024
    n_blocks: int = 12
    n_heads: int = 12
    dropout: float = 0.1
    vocab_size: int = 258
    causal: bool = False
    use_adaLN: bool = True
    num_classes: Optional[int] = None  # +1 null class added internally
    compute_dtype: torch.dtype = torch.bfloat16
    logits_dtype: torch.dtype = torch.float32
    # The trunk's Hopper kernels; off by default, as `ddg_tpu`'s 'auto'.
    fused_rope_attn: bool = False
    fused_adaln: bool = False
    pallas_attention: bool = False
    # int8 dynamic quantization of the trunk products and the head
    # (inference only).
    quant_int8: bool = False
    # The library flash attention (K20-K22) and the plain route's knobs;
    # off by default, as `ddg_tpu`'s 'auto'.
    tpu_flash_attn: bool = False
    attn_probs_bf16: bool = False
    attn_remat: bool = False
    # Not ported: raises when set.
    tensor_axis: Optional[str] = None

    def __post_init__(self):
        if self.tensor_axis:
            raise NotImplementedError(
                'DITConfig.tensor_axis: tensor/sequence/ring parallelism '
                '(ROADMAP A.9) is not ported to ddg_tpu_torch yet')


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal features of sigma, float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def rope_cos_sin(length: int, head_dim: int, base: float = 10_000.0,
                 device=None):
    """Rotary cos/sin tables, float32, shape (L, head_dim // 2)."""
    inv_freq = 1.0 / (base ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


apply_rope = attention.apply_rope


def einsum_attention(q, k, v, *, causal: bool):
    """`ddg_tpu`'s `einsum_attention` (`attn_probs_bf16`) on (B, L, H, D):
    fp32 scores, a -1e30 causal mask, fp32 softmax, the probabilities cast
    to bf16 before PV, accumulated in fp32 and cast to v's dtype."""
    p = torch.softmax(attention._masked_scores(q.float(), k.float(), causal),
                      dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', p.to(torch.bfloat16).float(),
                        v.float()).to(v.dtype)


def dropout(x, p: float, *, train: bool, generator):
    """flax Dropout: where(keep, x / (1 - p), 0) with keep ~ Bernoulli(1 -
    p) from `generator`; the identity unless training with p > 0."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError('dropout in train mode needs a generator (rng=)')
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def modulate(x, shift, scale):
    """x * (1 + scale) + shift with (B, D) shift/scale."""
    return x * (1 + scale[:, None]) + shift[:, None]


class AdaLNLayerNorm(nn.Module):
    """LayerNorm with a learned scale only, fp32 one-pass moments
    (E[x^2] - E[x]^2, clamped at 0), eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        m1 = x32.mean(-1, keepdim=True)
        m2 = (x32 * x32).mean(-1, keepdim=True)
        var = (m2 - m1 * m1).clamp_min(0.0)
        y = (x32 - m1) * torch.rsqrt(var + 1e-5)
        return (y * self.weight).to(x.dtype)


class DDiTBlock(nn.Module):
    def __init__(self, cfg: DITConfig):
        super().__init__()
        self.cfg = cfg
        dim, dt = cfg.hidden_size, cfg.compute_dtype
        # The four big products; the adaLN projection stays a float Linear.
        Linear = quant.QLinear if cfg.quant_int8 else nn.Linear
        self.norm1 = AdaLNLayerNorm(dim)
        self.attn_qkv = Linear(dim, 3 * dim, bias=False, dtype=dt)
        self.attn_out = Linear(dim, dim, bias=False, dtype=dt)
        self.norm2 = AdaLNLayerNorm(dim)
        self.mlp = nn.Sequential(
            Linear(dim, 4 * dim, bias=True, dtype=dt),
            nn.GELU(approximate='tanh'),
            Linear(4 * dim, dim, bias=True, dtype=dt))
        if cfg.use_adaLN:
            self.adaLN_modulation = nn.Linear(cfg.cond_dim, 6 * dim,
                                              bias=True, dtype=dt)

    def forward(self, x, cos, sin, c, *, train: bool = False, rng=None):
        cfg = self.cfg
        use_adaLN = cfg.use_adaLN and c is not None
        fused_adaln = cfg.fused_adaln and use_adaLN
        if use_adaLN:
            (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
             gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)

        x_skip = x
        if fused_adaln:
            h = adaln.ln_modulate(x, self.norm1.weight, shift_msa, scale_msa)
        else:
            h = self.norm1(x)
            if use_adaLN:
                h = modulate(h, shift_msa, scale_msa)
        B, L, dim = x.shape
        H = cfg.n_heads
        qkv = self.attn_qkv(h).view(B, L, 3, H, dim // H)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cfg.tpu_flash_attn:
            attn = flash_attention.flash_attention(
                apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                causal=cfg.causal, sm_scale=1.0 / math.sqrt(dim // H))
        elif cfg.fused_rope_attn:
            attn = attention.fused_rope_attention(q, k, v, cos, sin,
                                                  causal=cfg.causal)
        elif cfg.pallas_attention:
            attn = attention.short_seq_attention(
                apply_rope(q, cos, sin), apply_rope(k, cos, sin), v,
                causal=cfg.causal)
        else:
            fn = functools.partial(
                einsum_attention if cfg.attn_probs_bf16
                else attention.attention_plain, causal=cfg.causal)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            attn = (checkpoint(fn, q, k, v, use_reentrant=False)
                    if cfg.attn_remat else fn(q, k, v))
        h = self.attn_out(attn.reshape(B, L, dim))
        h = dropout(h, cfg.dropout, train=train, generator=rng)
        if fused_adaln:
            x, h = adaln.gate_res_ln_modulate(h, x_skip, gate_msa,
                                              self.norm2.weight, shift_mlp,
                                              scale_mlp)
            x_skip = x
        else:
            if use_adaLN:
                h = gate_msa[:, None] * h
            x = x_skip + h
            x_skip = x
            h = self.norm2(x)
            if use_adaLN:
                h = modulate(h, shift_mlp, scale_mlp)
        h = dropout(self.mlp(h), cfg.dropout, train=train, generator=rng)
        if use_adaLN:
            h = gate_mlp[:, None] * h
        return x_skip + h


class EmbeddingLayer(nn.Module):
    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab_size, dim))
        bound = 1.0 / math.sqrt(dim)   # variance_scaling(1/3, fan_in)
        nn.init.uniform_(self.embedding, -bound, bound)

    def forward(self, x):
        # F.embedding's backward sums the rows of each token in segments; the
        # backward of plain indexing serialises a token's duplicates, which
        # a small vocabulary (text8's 35) has by the thousand.
        return F.embedding(x.long(), self.embedding)


class TimestepEmbedder(nn.Module):
    def __init__(self, cond_dim: int, freq_dim: int = 256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(nn.Linear(freq_dim, cond_dim), nn.SiLU(),
                                 nn.Linear(cond_dim, cond_dim))

    def forward(self, sigma):
        return self.mlp(timestep_embedding(sigma, self.freq_dim))


class LabelEmbedder(nn.Module):
    """Class embedding with the null class (index num_classes) for CFG."""

    def __init__(self, num_classes: int, cond_dim: int):
        super().__init__()
        self.embedding_table = nn.Embedding(num_classes + 1, cond_dim)

    def forward(self, cond):
        return self.embedding_table(cond.long())


class DDitFinalLayer(nn.Module):
    def __init__(self, cfg: DITConfig):
        super().__init__()
        self.norm_final = AdaLNLayerNorm(cfg.hidden_size)
        Linear = quant.QLinear if cfg.quant_int8 else nn.Linear
        self.linear = Linear(cfg.hidden_size, cfg.vocab_size,
                             dtype=cfg.logits_dtype)
        if cfg.use_adaLN:
            self.adaLN_modulation = nn.Linear(cfg.cond_dim,
                                              2 * cfg.hidden_size)


class _RopeTables:
    """The rotary tables of `cfg`'s head width, made once per (L,
    device)."""

    def rope_tables(self, length: int, device):
        key = (length, str(device))
        if key not in self._rope:
            self._rope[key] = rope_cos_sin(
                length, self.cfg.hidden_size // self.cfg.n_heads,
                device=device)
        return self._rope[key]


class DIT(_RopeTables, nn.Module):
    """Denoiser: (indices, sigma, cond, x_emb) -> logits (B, L, V).

    `skip_head` returns (trunk hidden state, conditioning vector) for the
    samplers' head shortcuts; `return_hidden_states` returns the hidden
    state beside the logits; `x_emb` bypasses the trunk.
    """

    def __init__(self, cfg: DITConfig):
        super().__init__()
        self.cfg = cfg
        self.vocab_embed = EmbeddingLayer(cfg.vocab_size, cfg.hidden_size)
        if not cfg.causal:
            self.sigma_map = TimestepEmbedder(cfg.cond_dim)
        if cfg.num_classes is not None:
            self.cond_map = LabelEmbedder(cfg.num_classes, cfg.cond_dim)
        self.blocks = nn.ModuleList(DDiTBlock(cfg)
                                    for _ in range(cfg.n_blocks))
        self.output_layer = DDitFinalLayer(cfg)
        self._rope = {}

    def forward(self, indices, sigma, cond=None, x_emb=None, *,
                train: bool = False, rng=None,
                return_hidden_states: bool = False,
                skip_head: bool = False):
        cfg = self.cfg
        if cfg.quant_int8 and train:
            raise ValueError(
                'quant_int8 is an inference-only transform (rounding kills '
                'gradients); train with it off and turn it on for sampling')
        c = None if cfg.causal else F.silu(self.sigma_map(sigma))
        if cond is not None:
            if cfg.num_classes is None:
                raise ValueError('Conditioning variable provided, but model '
                                 'was not initialized with condition '
                                 'embedding layer.')
            cond_emb = F.silu(self.cond_map(cond))
            c = cond_emb if c is None else c + cond_emb
        if c is not None:
            c = c.to(cfg.compute_dtype)

        if x_emb is None:
            x = self.vocab_embed(indices).to(cfg.compute_dtype)
            cos, sin = self.rope_tables(x.shape[1], x.device)
            for block in self.blocks:
                x = block(x, cos, sin, c, train=train, rng=rng)
        else:
            x = x_emb.to(cfg.compute_dtype)

        hidden = x
        if skip_head:
            if c is None:
                c = torch.zeros((x.shape[0], cfg.cond_dim),
                                dtype=cfg.compute_dtype, device=x.device)
            return hidden, c
        out = self.output_layer
        use_adaLN = cfg.use_adaLN and c is not None
        if use_adaLN:
            ada = out.adaLN_modulation
            shift, scale = F.linear(
                c, ada.weight.to(cfg.compute_dtype),
                ada.bias.to(cfg.compute_dtype)).chunk(2, dim=-1)
        if use_adaLN and cfg.fused_adaln:
            h = adaln.ln_modulate(x, out.norm_final.weight, shift, scale)
        else:
            h = out.norm_final(x)
            if use_adaLN:
                h = modulate(h, shift, scale)
        # The int8 head quantizes the features as they are (QDense takes
        # them uncast).
        logits = out.linear(h if cfg.quant_int8 else h.to(cfg.logits_dtype))
        if return_hidden_states:
            return logits, hidden
        return logits


POOLINGS = ('mean', 'max', 'cls', 'last', 'no_pooling', 'attention_mean')


class DITClassifier(_RopeTables, nn.Module):
    """Classifier trunk + pooling head (port of `ddg_tpu/models/dit.py:
    565-630`): (indices or one-hots, sigma, x_emb, attention_mask) ->
    float32 logits (B, num_classes), or (B, L, num_classes) under
    'no_pooling'.

    It takes token indices (B, L), or one-hot or soft inputs (B, L, V),
    embedded as `one_hot.float() @ vocab_embed.embedding`, so that the
    log-probabilities can be differentiated in the one-hots (CBG's
    first-order approximation); and `x_emb`, a hidden state that bypasses
    the trunk (NOS). With `sigma` None it conditions on sigma = 0, as the
    clean-input (eval) classifiers do. The trunk is the denoiser's
    `DDiTBlock`, so `fused_rope_attn` and `fused_adaln` reach K1 and K3/K5
    (and their backwards) as in the denoiser. Poolings: POOLINGS. The head,
    `output_layer`, is a float32 Linear on the pooled state cast to float32.

    `head_only=True` builds `output_layer` alone, for a classifier that only
    ever reads `x_emb`: the JAX NOS classifier is initialised through
    `x_emb`, so its params hold `output_layer` and nothing else, and no
    trunk is allocated here either. Its forward then requires `x_emb`.
    Parameter names: `vocab_embed.embedding`, `sigma_map.mlp.{0,2}` and
    `blocks.{i}.*` as the denoiser's, then `output_layer.{weight,bias}`.
    """

    def __init__(self, cfg: DITConfig, num_classes: int = 2,
                 pooling: str = 'mean', head_only: bool = False):
        super().__init__()
        if pooling not in POOLINGS:
            raise NotImplementedError(f'`{pooling}` method not implemented.')
        self.cfg, self.num_classes, self.pooling = cfg, num_classes, pooling
        self.head_only = head_only
        if not head_only:
            self.vocab_embed = EmbeddingLayer(cfg.vocab_size,
                                              cfg.hidden_size)
            if not cfg.causal:
                self.sigma_map = TimestepEmbedder(cfg.cond_dim)
            # A causal (FUDGE) trunk has no conditioning, so no adaLN
            # projections, as the JAX blocks create none there.
            block_cfg = dataclasses.replace(
                cfg, use_adaLN=cfg.use_adaLN and not cfg.causal)
            self.blocks = nn.ModuleList(DDiTBlock(block_cfg)
                                        for _ in range(cfg.n_blocks))
        self.output_layer = nn.Linear(cfg.hidden_size, num_classes)
        self._rope = {}

    def forward(self, indices_or_one_hots, sigma, x_emb=None,
                attention_mask=None, *, train: bool = False, rng=None):
        cfg = self.cfg
        if x_emb is not None:
            x = x_emb.to(cfg.compute_dtype)
        elif self.head_only:
            raise ValueError('a head-only classifier classifies `x_emb` '
                             'alone')
        else:
            if indices_or_one_hots.ndim == 2:
                x = self.vocab_embed(indices_or_one_hots)
            else:
                x = indices_or_one_hots.float() @ self.vocab_embed.embedding
            x = x.to(cfg.compute_dtype)
            c = None
            if not cfg.causal:
                if sigma is None:
                    sigma = torch.zeros((x.shape[0],), dtype=torch.float32,
                                        device=x.device)
                c = F.silu(self.sigma_map(sigma)).to(cfg.compute_dtype)
            cos, sin = self.rope_tables(x.shape[1], x.device)
            for block in self.blocks:
                x = block(x, cos, sin, c, train=train, rng=rng)

        if self.pooling == 'mean':
            x = x.mean(dim=1)
        elif self.pooling == 'max':
            x = x.amax(dim=1)
        elif self.pooling == 'cls':
            x = x[:, 0]
        elif self.pooling == 'last':
            x = x[:, -1]
        elif self.pooling == 'attention_mean':
            m = attention_mask[..., None].to(x.dtype)
            x = (x * m).sum(dim=1) / (m.sum(dim=1) + 1e-15)
        return self.output_layer(x.float())


def dit_head_features(cfg: DITConfig, params, hidden, c):
    """norm_final (two-pass variance) + final adaLN modulation without the
    vocab matmul. hidden: (..., D); c: (batch, cond_dim), broadcast over
    any middle dims. The final adaLN projection runs in float32 on the
    float32 weights, so the features are float32 under adaLN (as in
    `ddg_tpu`, whose bf16 x fp32 products promote)."""
    h32 = hidden.float()
    mean = h32.mean(-1, keepdim=True)
    var = h32.var(-1, unbiased=False, keepdim=True)
    h = (h32 - mean) * torch.rsqrt(var + 1e-5)
    h = (h * params['output_layer.norm_final.weight']).to(hidden.dtype)
    if cfg.use_adaLN and 'output_layer.adaLN_modulation.weight' in params:
        mod = (c.float() @ params['output_layer.adaLN_modulation.weight'].T
               + params['output_layer.adaLN_modulation.bias'])
        shift, scale = mod.chunk(2, dim=-1)
        extra = (1,) * (hidden.ndim - 2)
        shift = shift.reshape(shift.shape[0], *extra, shift.shape[-1])
        scale = scale.reshape(scale.shape[0], *extra, scale.shape[-1])
        h = h * (1 + scale) + shift
    return h


def dit_head_matmul(cfg: DITConfig, params, feats):
    """The vocab projection on head features, in `logits_dtype` (the bias
    is in that dtype too, so the logits are not promoted). Under
    `quant_int8` it is the int8 product, the bias added in fp32 before the
    cast, on the weight's quantization kept across calls."""
    dt = cfg.logits_dtype
    if cfg.quant_int8:
        return quant.int8_linear(feats, params['output_layer.linear.weight'],
                                 params['output_layer.linear.bias'],
                                 out_dtype=dt)
    return F.linear(feats.to(dt), params['output_layer.linear.weight'].to(dt),
                    params['output_layer.linear.bias'].to(dt))


def dit_head_fn(cfg: DITConfig, params, hidden_rows, c):
    """The DIT output head on gathered hidden rows (B, D), float32."""
    feats = dit_head_features(cfg, params, hidden_rows, c)
    return dit_head_matmul(cfg, params, feats).float()
