"""DiMamba: the bidirectional Mamba denoiser for long genomic sequences
(port of `ddg_tpu/models/dimamba.py`).

Block = add -> LayerNorm -> adaLN (shift, scale, gate) -> BiMamba mixer ->
gated residual; the mixer runs a forward and a flipped-sequence Mamba
direction with tied in/out projections and combines them ('add' or
'ew_multiply'). The residual stream re-accumulates on purpose: a block
returns (gate * mixer + residual, residual) and the next block adds both
again, as the reference does.

Submodules carry the flax names (`word_embeddings`, `sigma_map`,
`cond_map`, `block_{i}.norm`, `block_{i}.adaLN_modulation`,
`block_{i}.mixer.in_proj_fwd`, `block_{i}.mixer.core_fwd.A_log`,
`norm_f`, `adaLN_final`, `lm_head`), and `convert.dimamba_state_dict_from_jax`
maps the JAX params onto them.

Dtypes follow the JAX module's policy: in_proj, out_proj, x_proj, the
conv and the block adaLN projections run in `compute_dtype` and hold their
weights in it (what flax's per-call cast produces); dt_proj, A_log, D, the
LayerNorms (flax's: bias, eps 1e-6, E[x^2] - E[x]^2 variance), the final
adaLN projection and `lm_head` are float32.

A direction runs one of four routes, which `resolve_route` picks from
the configuration, L and whether the tensors are on the card, before any
launch, as the JAX module picks them:
- 'fused_block': `ops.mamba.mamba_inner`, K18. `fused_block='auto'` takes
  it where the scan kernel is on (`pallas_scan`, 'auto': on the card) and
  L and the segments fit `scan_chunk`, d_conv <= 8;
- 'scan_kernel_dtlr': with `dt_inkernel`, where the scan kernel is on, the
  fused block is not taken and L is a multiple of `scan_chunk`: the
  unfused chain (in_proj, conv, x_proj as PyTorch ops) around
  `ops.mamba.ssm_scan_dtlr`, K16, which forms delta = softplus(dt_lr W_dt
  + b_dt) inside the kernel from dt_proj's own weights;
- 'scan_kernel': the unfused chain with dt_proj and softplus as PyTorch
  ops around `ops.mamba.ssm_scan`, K14, where the scan kernel is on and
  neither route above is taken;
- 'plain_scan': the plain `selective_scan`, where the scan kernel is off.
On the card a route whose kernel does not take the shape raises, naming
what the kernel takes (`ops.mamba.mamba_inner_takes`, `ssm_scan_takes`,
`ssm_scan_dtlr_takes`); it never hands the work to the plain version. On
CPU tensors the kernels' wrappers run their plain versions, so every route
runs there. Gradients flow through every route: the kernels' autograd
wrappers backpropagate through K19 (fused block), K17 (dt-lowrank) and K15
(scan kernel), the plain scan through PyTorch's autograd, and the tied
in/out projections sum both directions' gradients. `train=True` applies
dropout (rate `cfg.dropout`) to the mixer output before the gate, with
masks from the `rng` generator, as the JAX block does. The parameter tree
is the same on every route. Not ported (they raise): `sequence_axis` and
`remat`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ddg_tpu_torch.models.dit import TimestepEmbedder, dropout
from ddg_tpu_torch.ops import mamba as mamba_ops


@dataclasses.dataclass(frozen=True)
class DiMambaConfig:
    hidden_size: int = 256
    cond_dim: int = 128
    length: int = 32768
    n_blocks: int = 8
    vocab_size: int = 16
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    bidirectional: bool = True
    bidirectional_strategy: str = 'add'
    bidirectional_weight_tie: bool = True
    tie_word_embeddings: bool = False
    num_classes: Optional[int] = None
    use_adaLN: bool = True
    scan_chunk: int = 128
    # 'auto' = the kernel when the tensors are on the card; True / False
    # force it.
    pallas_scan: str | bool = 'auto'
    dt_inkernel: bool = False
    # The TPU kernels' within-chunk schedule; the port's kernels have none.
    scan_seg: int = 64
    scan_seg_bwd: int = 64
    scan_impl: str = 'pps3'
    fused_block: str | bool = 'auto'
    # The JAX package's interpret switch, kept for the config's shape: the
    # port's wrappers choose by the tensors' device, so True is refused.
    pallas_interpret: bool = False
    dropout: float = 0.1
    remat: bool = False
    compute_dtype: torch.dtype = torch.bfloat16
    sequence_axis: Optional[str] = None
    batch_axis: str = 'data'

    def __post_init__(self):
        unported = {
            'sequence_axis': 'sequence parallelism (ROADMAP A.9)',
            'remat': 'block remat (ROADMAP A.8)',
        }
        for name, what in unported.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f'DiMambaConfig.{name}: {what} is not ported to '
                    'ddg_tpu_torch yet')
        if self.pallas_interpret:
            raise ValueError(
                'DiMambaConfig.pallas_interpret: the port has no interpret '
                'mode; a kernel runs its plain version on CPU tensors')

    @property
    def d_inner(self) -> int:
        return self.expand * self.hidden_size

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.hidden_size / 16)


def selective_scan(u, delta, A, B, C, D, z, *, chunk: int = 256):
    """The selective scan as the JAX module's plain path computes it:
    h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t, y_t = C_t . h_t + D u_t,
    out = y * silu(z), fp32 recurrence, output in u's dtype. u, delta, z:
    (B, L, d); A: (d, N); B, C: (B, L, N); D: (d,)."""
    u32 = u.float()
    y, _ = mamba_ops.scan_chunks(u32, delta.float(), A.float(), B.float(),
                                 C.float(), chunk)
    z32 = z.float()
    y = (y + D.float() * u32) * (z32 * torch.sigmoid(z32))
    return y.to(u.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm in float32: E[x^2] - E[x]^2 variance (clamped at
    0), (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


def resolve_route(cfg: DiMambaConfig, L: int, on_card: bool) -> str:
    """The route of a direction, 'fused_block', 'scan_kernel_dtlr',
    'scan_kernel' or 'plain_scan', from cfg.fused_block, cfg.pallas_scan
    ('auto' / True / False) and cfg.dt_inkernel as the JAX module resolves
    them. fused_block=True raises where the JAX constraints fail; on the
    card a route whose kernel does not take the shape raises."""
    jax_ok = (L % cfg.scan_chunk == 0
              and all(cfg.scan_chunk % s == 0 and cfg.scan_chunk // s >= 2
                      for s in (cfg.scan_seg, cfg.scan_seg_bwd))
              and cfg.d_conv <= 8)
    shape = (f'L={L}, chunk={cfg.scan_chunk}, seg={cfg.scan_seg}/'
             f'{cfg.scan_seg_bwd}, hidden={cfg.hidden_size}, '
             f'd_inner={cfg.d_inner}, d_state={cfg.d_state}, '
             f'dt_rank={cfg.dt_rank}, d_conv={cfg.d_conv}')
    scan = cfg.pallas_scan is True or (cfg.pallas_scan == 'auto' and on_card)
    if cfg.fused_block is True:
        if not jax_ok:
            raise ValueError('fused_block=True but the kernel shape '
                             f'constraints do not hold ({shape})')
        route = 'fused_block'
    elif (cfg.fused_block == 'auto' and scan
          and cfg.scan_impl in ('pps2', 'pps3') and jax_ok):
        route = 'fused_block'
    elif not scan:
        return 'plain_scan'
    elif cfg.dt_inkernel and L % cfg.scan_chunk == 0:
        route = 'scan_kernel_dtlr'
    else:
        route = 'scan_kernel'
    if not on_card:
        return route
    d, N, R, chunk = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.scan_chunk
    if route == 'fused_block' and not mamba_ops.mamba_inner_takes(
            cfg.hidden_size, d, N, R, cfg.d_conv, cfg.compute_dtype, chunk):
        raise ValueError(
            f'DiMamba: the fused block K18/K19 does not take {shape} on the '
            'card (it takes hidden % 8 == 0, d_inner % 16 == 0 in bfloat16 '
            'and % 8 in float32, d_conv <= 8: mamba_inner_takes); set '
            'fused_block=False for the unfused route')
    if route == 'scan_kernel_dtlr' and not mamba_ops.ssm_scan_dtlr_takes(
            d, N, R, chunk):
        raise ValueError(
            f'DiMamba: the dt-lowrank scan K16/K17 does not take {shape} on '
            'the card (it takes every d_state, chunk and dt_rank >= 1: '
            'ssm_scan_dtlr_takes); set dt_inkernel=False')
    if route == 'scan_kernel' and not mamba_ops.ssm_scan_takes(d, N, chunk):
        raise ValueError(
            f'DiMamba: the scan kernel K14/K15 does not take {shape} on the '
            'card (a chunk whose blocks fit in shared memory, '
            'ssm_scan_takes); set pallas_scan=False for the plain scan')
    return route


class MambaCore(nn.Module):
    """Conv + SSM core of one direction (everything between in_proj and
    out_proj): conv1d, x_proj, dt_proj, A_log, D."""

    def __init__(self, cfg: DiMambaConfig):
        super().__init__()
        self.cfg = cfg
        d, cd = cfg.d_inner, cfg.compute_dtype
        self.conv1d_kernel = nn.Parameter(torch.zeros(cfg.d_conv, 1, d,
                                                      dtype=cd))
        self.conv1d_bias = nn.Parameter(torch.zeros(d, dtype=cd))
        self.x_proj = nn.Linear(d, cfg.dt_rank + 2 * cfg.d_state,
                                bias=False, dtype=cd)
        self.dt_proj = nn.Linear(cfg.dt_rank, d)
        self.A_log = nn.Parameter(torch.zeros(d, cfg.d_state))
        self.D = nn.Parameter(torch.ones(d))

    def A(self):
        return -torch.exp(self.A_log)

    def forward(self, x, z, route: str):
        """The unfused chain on x, z (B, L, d_inner) in compute dtype, its
        scan by `route` ('scan_kernel_dtlr', 'scan_kernel' or
        'plain_scan')."""
        cfg = self.cfg
        K = cfg.d_conv
        # Causal depthwise conv from the newest tap: x w_{K-1}, then the
        # older taps 0..K-2, then the bias, each op in compute dtype.
        w = self.conv1d_kernel[:, 0]
        xp = F.pad(x, (0, 0, K - 1, 0))
        L = x.shape[1]
        acc = x * w[K - 1]
        for j in range(K - 1):
            acc = acc + xp[:, j:j + L] * w[j]
        x = acc + self.conv1d_bias
        x = x * torch.sigmoid(x)
        x_dbl = self.x_proj(x)
        R, N = cfg.dt_rank, cfg.d_state
        dt, B, C = x_dbl[..., :R], x_dbl[..., R:R + N], x_dbl[..., R + N:]
        if route == 'scan_kernel_dtlr':
            # dt_proj's weights (flax's (R, d) view) into the kernel, which
            # forms delta itself; dt_lr in fp32, as JAX casts it.
            return mamba_ops.ssm_scan_dtlr(
                x, dt.float(), self.dt_proj.weight.t(), self.dt_proj.bias,
                self.A(), B, C, self.D, z, chunk=cfg.scan_chunk)
        delta = mamba_ops.softplus(self.dt_proj(dt.float()))
        if route == 'scan_kernel':
            return mamba_ops.ssm_scan(x, delta, self.A(), B, C, self.D, z,
                                      chunk=cfg.scan_chunk)
        return selective_scan(x, delta, self.A(), B, C, self.D, z,
                              chunk=cfg.scan_chunk)


class BiMambaWrapper(nn.Module):
    """Forward + reversed Mamba with optional in/out projection tying."""

    def __init__(self, cfg: DiMambaConfig):
        super().__init__()
        self.cfg = cfg
        d, H, cd = cfg.d_inner, cfg.hidden_size, cfg.compute_dtype
        self.in_proj_fwd = nn.Linear(H, 2 * d, bias=False, dtype=cd)
        self.out_proj_fwd = nn.Linear(d, H, bias=False, dtype=cd)
        self.core_fwd = MambaCore(cfg)
        if cfg.bidirectional:
            self.core_rev = MambaCore(cfg)
            if not cfg.bidirectional_weight_tie:
                self.in_proj_rev = nn.Linear(H, 2 * d, bias=False, dtype=cd)
                self.out_proj_rev = nn.Linear(d, H, bias=False, dtype=cd)
        if cfg.bidirectional_strategy not in ('add', 'ew_multiply'):
            raise NotImplementedError(
                f'`{cfg.bidirectional_strategy}` for bi-directionality not '
                'implemented!')

    def _direction(self, h, in_proj, core, out_proj, route):
        cfg = self.cfg
        if route == 'fused_block':
            # Weights as flax's (in, out) views of the Linear weights: the
            # kernel reads them in place.
            return mamba_ops.mamba_inner(
                h, in_proj.weight.t(), core.conv1d_kernel, core.conv1d_bias,
                core.x_proj.weight.t(), core.dt_proj.weight.t(),
                core.dt_proj.bias, core.A(), core.D, out_proj.weight.t(),
                d_state=cfg.d_state, dt_rank=cfg.dt_rank,
                chunk=cfg.scan_chunk, compute_dtype=cfg.compute_dtype)
        x, z = in_proj(h).chunk(2, dim=-1)
        return out_proj(core(x, z, route))

    def forward(self, h):
        cfg = self.cfg
        route = resolve_route(cfg, h.shape[1], h.is_cuda)
        out = self._direction(h, self.in_proj_fwd, self.core_fwd,
                              self.out_proj_fwd, route)
        if not cfg.bidirectional:
            return out
        tied = cfg.bidirectional_weight_tie
        out_r = self._direction(
            torch.flip(h, (1,)),
            self.in_proj_fwd if tied else self.in_proj_rev, self.core_rev,
            self.out_proj_fwd if tied else self.out_proj_rev, route)
        out_r = torch.flip(out_r, (1,))
        if cfg.bidirectional_strategy == 'add':
            return out + out_r
        return out * out_r


class DiMambaBlock(nn.Module):
    """Add -> LayerNorm -> adaLN modulate -> mixer -> gated residual."""

    def __init__(self, cfg: DiMambaConfig):
        super().__init__()
        self.cfg = cfg
        self.norm = LayerNorm(cfg.hidden_size)
        if cfg.use_adaLN:
            self.adaLN_modulation = nn.Linear(cfg.cond_dim,
                                              3 * cfg.hidden_size,
                                              dtype=cfg.compute_dtype)
        self.mixer = BiMambaWrapper(cfg)

    def forward(self, hidden_states, residual, c, train=False, rng=None):
        cfg = self.cfg
        residual = (hidden_states + residual if residual is not None
                    else hidden_states).float()
        h = self.norm(residual).to(cfg.compute_dtype)
        gate = None
        if cfg.use_adaLN and c is not None:
            shift, scale, gate = self.adaLN_modulation(c).chunk(3, dim=-1)
            h = h * (1 + scale[:, None]) + shift[:, None]
        h = self.mixer(h)
        if gate is not None:
            h = dropout(h, cfg.dropout, train=train, generator=rng)
            h = gate[:, None] * h + residual.to(h.dtype)
        return h, residual


class DiMamba(nn.Module):
    """Denoiser: (indices, sigma, cond, x_emb) -> logits (B, L, V)."""

    def __init__(self, cfg: DiMambaConfig):
        super().__init__()
        self.cfg = cfg
        self.sigma_map = TimestepEmbedder(cfg.cond_dim)
        if cfg.num_classes is not None:
            self.cond_map = nn.Embedding(cfg.num_classes + 1, cfg.cond_dim)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        for i in range(cfg.n_blocks):
            self.add_module(f'block_{i}', DiMambaBlock(cfg))
        self.norm_f = LayerNorm(cfg.hidden_size)
        if cfg.use_adaLN:
            self.adaLN_final = nn.Linear(cfg.cond_dim, 2 * cfg.hidden_size)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, indices, sigma, cond=None, x_emb=None, *,
                train: bool = False, rng=None,
                return_hidden_states: bool = False):
        cfg = self.cfg
        cd = cfg.compute_dtype
        c = None
        if sigma is not None:
            c = F.silu(self.sigma_map(sigma))
        if cond is not None:
            if cfg.num_classes is None:
                raise ValueError('Conditioning provided but num_classes is '
                                 'None')
            ce = F.silu(self.cond_map(cond.long()))
            c = ce if c is None else c + ce
        if c is not None:
            c = c.to(cd)
        if x_emb is None:
            h = self.word_embeddings(indices.long()).to(cd)
        else:
            h = x_emb.to(cd)
        residual = None
        for i in range(cfg.n_blocks):
            h, residual = getattr(self, f'block_{i}')(h, residual, c, train,
                                                      rng)
        final = h + residual.to(h.dtype) if residual is not None else h
        final = self.norm_f(final)
        if cfg.use_adaLN and c is not None:
            shift, scale = self.adaLN_final(c.float()).chunk(2, dim=-1)
            final = final * (1 + scale[:, None]) + shift[:, None]
        if cfg.tie_word_embeddings:
            logits = final @ self.word_embeddings.weight.T
        else:
            logits = self.lm_head(final)
        if return_hidden_states:
            return logits, final
        return logits
