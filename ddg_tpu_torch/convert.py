"""Weights carried into the port's `DIT` (port of
`ddg_tpu/convert.py:136-218`), `UNet` and `DiMamba`.

`dit_state_dict_from_jax` turns a `ddg_tpu` DIT params tree (numpy
arrays, flax names) into a state dict in the reference torch naming,
which `ddg_tpu_torch.models.dit.DIT` loads with `strict=True`.
`make_reference_dit_state_dict` makes seeded random weights in that
naming, for runs that have no checkpoint (`causal=True`: an AR DiT's,
without the sigma map).
`dit_classifier_state_dict_from_jax` and
`make_reference_dit_classifier_state_dict` do the same for the port's
`DITClassifier` (the trunk named as the DIT's; flax's `output_layer`
Dense -> `output_layer.{weight,bias}`), full or head-only.

Name mapping (flax -> reference torch):
  vocab_embed                     -> vocab_embed.embedding
  sigma_map/mlp{1,2}              -> sigma_map.mlp.{0,2}
  cond_map/embedding              -> cond_map.embedding_table.weight
  block_N/{norm1,norm2}/weight    -> blocks.N.{norm1,norm2}.weight
  block_N/{attn_qkv,attn_out}     -> blocks.N.{attn_qkv,attn_out}
  block_N/{mlp_in,mlp_out}        -> blocks.N.mlp.{0,2}
  block_N/adaLN_modulation        -> blocks.N.adaLN_modulation
  norm_final/weight               -> output_layer.norm_final.weight
  output_linear                   -> output_layer.linear
  final_adaLN                     -> output_layer.adaLN_modulation
Flax Dense kernels are (in, out); torch Linear weights (out, in).

`unet_state_dict_from_jax` turns a `ddg_tpu` UNet params tree into the
state dict of `ddg_tpu_torch.models.unet.UNet`, whose submodules carry
the flax names (no reference torch UNet checkpoint exists), with layout
transposes only: conv kernels (kh, kw, in, out) -> (out, in, kh, kw),
Dense kernels (in, out) -> Linear (out, in), Embed tables, NiN `W` (in,
out) and `b`, and GroupNorm `scale`/`bias` as they are.
`make_unet_state_dict` makes seeded random weights from the JAX
initializers.

`dimamba_params_from_reference` turns a reference DiMamba state dict into
a `ddg_tpu` DiMamba params tree (a copy of `ddg_tpu/convert.py:228-315`,
tied in/out projections and `core_rev` included), and
`dimamba_state_dict_from_jax` turns that tree into the state dict of
`ddg_tpu_torch.models.dimamba.DiMamba` (flax names; kernels transposed,
`embedding` -> `weight`, `sigma_map/mlp{1,2}` -> `sigma_map.mlp.{0,2}`).
`make_reference_dimamba_state_dict` makes seeded random weights in the
reference layout, with a class table of `num_classes + 1` rows.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import numpy as np
import torch


def _T(x):
    """A flax Dense kernel (in, out) as a torch Linear weight (out, in)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, dtype=np.float32).T))


def _A(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense_from_jax(s, prefix, p, bias=True):
    s[prefix + '.weight'] = _T(p['kernel'])
    if bias:
        s[prefix + '.bias'] = _A(p['bias'])


def _dit_trunk_from_jax(s, params, n_blocks: int):
    """The embedding, the sigma and class maps and the blocks of a DIT or
    DITClassifier params tree into `s`."""
    s['vocab_embed.embedding'] = _A(params['vocab_embed'])
    if 'sigma_map' in params:
        _dense_from_jax(s, 'sigma_map.mlp.0', params['sigma_map']['mlp1'])
        _dense_from_jax(s, 'sigma_map.mlp.2', params['sigma_map']['mlp2'])
    if 'cond_map' in params:
        s['cond_map.embedding_table.weight'] = _A(
            params['cond_map']['embedding'])
    for i in range(n_blocks):
        b = params[f'block_{i}']
        p = f'blocks.{i}.'
        s[p + 'norm1.weight'] = _A(b['norm1']['weight'])
        s[p + 'norm2.weight'] = _A(b['norm2']['weight'])
        _dense_from_jax(s, p + 'attn_qkv', b['attn_qkv'], bias=False)
        _dense_from_jax(s, p + 'attn_out', b['attn_out'], bias=False)
        _dense_from_jax(s, p + 'mlp.0', b['mlp_in'])
        _dense_from_jax(s, p + 'mlp.2', b['mlp_out'])
        if 'adaLN_modulation' in b:
            _dense_from_jax(s, p + 'adaLN_modulation',
                            b['adaLN_modulation'])


def dit_state_dict_from_jax(params, *, n_blocks: int
                            ) -> Dict[str, torch.Tensor]:
    """`ddg_tpu` DIT params (nested dict of arrays) -> float32 torch state
    dict in the reference naming."""
    s: Dict[str, torch.Tensor] = {}
    _dit_trunk_from_jax(s, params, n_blocks)
    s['output_layer.norm_final.weight'] = _A(params['norm_final']['weight'])
    _dense_from_jax(s, 'output_layer.linear', params['output_linear'])
    if 'final_adaLN' in params:
        _dense_from_jax(s, 'output_layer.adaLN_modulation',
                        params['final_adaLN'])
    return s


def dit_classifier_state_dict_from_jax(params, *, n_blocks: int
                                       ) -> Dict[str, torch.Tensor]:
    """`ddg_tpu` DITClassifier params -> float32 state dict of
    `models.dit.DITClassifier`: the trunk named as `dit_state_dict_from_jax`
    names it, then flax's `output_layer` Dense -> `output_layer.{weight,
    bias}`. A head-only tree (the JAX NOS classifier, initialised through
    `x_emb`: `output_layer` alone) gives the state dict of
    `DITClassifier(..., head_only=True)` and takes n_blocks=0."""
    s: Dict[str, torch.Tensor] = {}
    if 'vocab_embed' in params:
        _dit_trunk_from_jax(s, params, n_blocks)
    elif n_blocks:
        raise ValueError(f'a head-only classifier tree has no blocks, got '
                         f'n_blocks={n_blocks}')
    _dense_from_jax(s, 'output_layer', params['output_layer'])
    return s


def _normal(rng: np.random.RandomState):
    """N(0, 0.02^2) float32 arrays of a given shape, drawn from `rng`."""
    def r(*shape):
        return rng.randn(*shape).astype(np.float32) * 0.02
    return r


def _reference_trunk(s, r, *, hidden: int, cond_dim: int, n_blocks: int,
                     vocab: int, with_cond: bool, causal: bool = False,
                     adaln: bool = True):
    """The embedding, sigma map (not in a causal trunk), class table and
    blocks (with their adaLN projections when `adaln`) of seeded random
    DiT weights into `s` (numpy), drawn by `r` in this order."""
    s['vocab_embed.embedding'] = r(vocab, hidden)
    if not causal:
        s['sigma_map.mlp.0.weight'] = r(cond_dim, 256)
        s['sigma_map.mlp.0.bias'] = r(cond_dim)
        s['sigma_map.mlp.2.weight'] = r(cond_dim, cond_dim)
        s['sigma_map.mlp.2.bias'] = r(cond_dim)
    if with_cond:
        s['cond_map.embedding_table.weight'] = r(3, cond_dim)
    for i in range(n_blocks):
        p = f'blocks.{i}.'
        s[p + 'norm1.weight'] = r(hidden) + 1
        s[p + 'norm2.weight'] = r(hidden) + 1
        s[p + 'attn_qkv.weight'] = r(3 * hidden, hidden)
        s[p + 'attn_out.weight'] = r(hidden, hidden)
        s[p + 'mlp.0.weight'] = r(4 * hidden, hidden)
        s[p + 'mlp.0.bias'] = r(4 * hidden)
        s[p + 'mlp.2.weight'] = r(hidden, 4 * hidden)
        s[p + 'mlp.2.bias'] = r(hidden)
        if adaln:
            s[p + 'adaLN_modulation.weight'] = r(6 * hidden, cond_dim)
            s[p + 'adaLN_modulation.bias'] = r(6 * hidden)


def make_reference_dit_state_dict(rng: np.random.RandomState, *,
                                  hidden: int, cond_dim: int,
                                  n_blocks: int, vocab: int,
                                  with_cond: bool = False,
                                  causal: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """Seeded random weights (N(0, 0.02^2), norm weights around 1) with
    the reference's names and shapes; `with_cond` adds the 3-row class
    table of a 2-class model. `causal` gives an AR DiT's: no sigma map,
    and adaLN projections only with the class table (`use_adaLN` of a
    causal model is `with_cond`)."""
    s, r = {}, _normal(rng)
    adaln = with_cond or not causal
    _reference_trunk(s, r, hidden=hidden, cond_dim=cond_dim,
                     n_blocks=n_blocks, vocab=vocab, with_cond=with_cond,
                     causal=causal, adaln=adaln)
    s['output_layer.norm_final.weight'] = r(hidden) + 1
    s['output_layer.linear.weight'] = r(vocab, hidden)
    s['output_layer.linear.bias'] = r(vocab)
    if adaln:
        s['output_layer.adaLN_modulation.weight'] = r(2 * hidden, cond_dim)
        s['output_layer.adaLN_modulation.bias'] = r(2 * hidden)
    return {k: torch.from_numpy(v) for k, v in s.items()}


def make_reference_dit_classifier_state_dict(
        rng: np.random.RandomState, *, hidden: int, cond_dim: int = 0,
        n_blocks: int = 0, vocab: int = 0, num_classes: int = 2,
        head_only: bool = False, causal: bool = False
) -> Dict[str, torch.Tensor]:
    """Seeded random weights of `models.dit.DITClassifier`: the trunk as
    `make_reference_dit_state_dict` draws it (its names and order; a
    `causal` trunk has neither sigma map nor adaLN projections), then the
    class head `output_layer`; `head_only` draws the head alone (cond_dim,
    n_blocks and vocab unused)."""
    s, r = {}, _normal(rng)
    if not head_only:
        _reference_trunk(s, r, hidden=hidden, cond_dim=cond_dim,
                         n_blocks=n_blocks, vocab=vocab, with_cond=False,
                         causal=causal, adaln=not causal)
    s['output_layer.weight'] = r(num_classes, hidden)
    s['output_layer.bias'] = r(num_classes)
    return {k: torch.from_numpy(v) for k, v in s.items()}


def unet_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """`ddg_tpu` UNet params (nested dict of arrays) -> float32 torch state
    dict in the port's (flax) naming."""
    s: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, val in tree.items():
            if isinstance(val, dict):
                walk(val, prefix + name + '.')
                continue
            a = np.asarray(val, dtype=np.float32)
            if name == 'kernel':
                name = 'weight'
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            elif name == 'embedding':
                name = 'weight'
            s[prefix + name] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, '')
    return s


def make_unet_state_dict(model: torch.nn.Module, rng: np.random.RandomState
                         ) -> Dict[str, torch.Tensor]:
    """Seeded random float32 weights for `model` (a port `UNet`), drawn as
    the JAX module initialises them: NiN `W` from variance_scaling(0.1,
    fan_avg, uniform), the attention `out` projection at scale 1e-10;
    convs and denses lecun_normal (truncated normal); the class table
    normal with variance 1 / width; GroupNorm scales one; biases zero."""
    def lecun(shape, fan_in):
        """Normal truncated at two standard deviations, rescaled to
        variance 1 / fan_in."""
        a = rng.standard_normal(shape)
        out = np.abs(a) > 2
        while out.any():
            a[out] = rng.standard_normal(int(out.sum()))
            out = np.abs(a) > 2
        return a * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)

    s = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith('.W'):
            scale = 1e-10 if name.endswith('out.W') else 0.1
            limit = math.sqrt(3 * scale / ((shape[0] + shape[1]) / 2))
            a = rng.uniform(-limit, limit, shape)
        elif name == 'cond_map.weight':
            a = rng.standard_normal(shape) / math.sqrt(shape[1])
        elif name.endswith('.weight'):
            a = lecun(shape, int(np.prod(shape[1:])))
        elif name.endswith('.scale'):
            a = np.ones(shape)
        else:
            a = np.zeros(shape)
        s[name] = torch.from_numpy(a.astype(np.float32))
    return s


def dimamba_params_from_reference(state: Dict, *, n_blocks: int,
                                  bidirectional: bool = True,
                                  weight_tie: bool = True) -> Dict:
    """Reference DiMamba state dict (numpy arrays) -> `ddg_tpu` DiMamba
    params tree. In/out projections are shared across directions when
    `weight_tie`; each direction keeps its own conv/x_proj/dt_proj/A/D."""
    s = {re.sub(r'^backbone\.', '', k): v for k, v in state.items()}

    def T(x):
        return np.ascontiguousarray(np.asarray(x).T)

    def core(p):
        return {
            # torch Conv1d (d, 1, K) -> lax 'LIO' (K, 1, d)
            'conv1d_kernel': np.ascontiguousarray(
                np.transpose(s[p + 'conv1d.weight'], (2, 1, 0))),
            'conv1d_bias': s[p + 'conv1d.bias'],
            'x_proj': {'kernel': T(s[p + 'x_proj.weight'])},
            'dt_proj': {'kernel': T(s[p + 'dt_proj.weight']),
                        'bias': s[p + 'dt_proj.bias']},
            'A_log': s[p + 'A_log'],
            'D': s[p + 'D'],
        }

    def dense(p, bias=True):
        out = {'kernel': T(s[p + '.weight'])}
        if bias:
            out['bias'] = s[p + '.bias']
        return out

    bb = 'model.bimamba.backbone.'
    params: Dict = {'word_embeddings': {
        'embedding': s[bb + 'embeddings.word_embeddings.weight']}}
    if 'sigma_map.mlp.0.weight' in s:
        params['sigma_map'] = {'mlp1': dense('sigma_map.mlp.0'),
                               'mlp2': dense('sigma_map.mlp.2')}
    if 'cond_map.embedding_table.weight' in s:
        params['cond_map'] = {
            'embedding': s['cond_map.embedding_table.weight']}
    for i in range(n_blocks):
        p = bb + f'layers.{i}.'
        mixer = {'in_proj_fwd': dense(p + 'mixer.mamba_fwd.in_proj', False),
                 'out_proj_fwd': dense(p + 'mixer.mamba_fwd.out_proj',
                                       False),
                 'core_fwd': core(p + 'mixer.mamba_fwd.')}
        if bidirectional:
            mixer['core_rev'] = core(p + 'mixer.mamba_rev.')
            if not weight_tie:
                mixer['in_proj_rev'] = dense(p + 'mixer.mamba_rev.in_proj',
                                             False)
                mixer['out_proj_rev'] = dense(
                    p + 'mixer.mamba_rev.out_proj', False)
        block = {'norm': {'scale': s[p + 'norm.weight'],
                          'bias': s[p + 'norm.bias']},
                 'mixer': mixer}
        if p + 'adaLN_modulation.weight' in s:
            block['adaLN_modulation'] = dense(p + 'adaLN_modulation')
        params[f'block_{i}'] = block
    params['norm_f'] = {'scale': s[bb + 'norm_f.weight'],
                        'bias': s[bb + 'norm_f.bias']}
    if bb + 'adaLN_modulation_final.weight' in s:
        params['adaLN_final'] = dense(bb + 'adaLN_modulation_final')
    if 'model.lm_head.weight' in s:
        w = s['model.lm_head.weight']
        params['lm_head'] = {'kernel': T(w),
                             'bias': np.zeros(w.shape[0], np.float32)}
    return params


def dimamba_state_dict_from_jax(params, *, n_blocks: int
                                ) -> Dict[str, torch.Tensor]:
    """`ddg_tpu` DiMamba params (nested dict of arrays) -> float32 torch
    state dict of the port's `DiMamba`."""
    blocks = sum(k.startswith('block_') for k in params)
    if blocks != n_blocks:
        raise ValueError(f'the params hold {blocks} blocks, not {n_blocks}')
    renames = {'mlp1': 'mlp.0', 'mlp2': 'mlp.2'}
    s: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, val in tree.items():
            if isinstance(val, dict):
                walk(val, prefix + renames.get(name, name) + '.')
                continue
            a = np.asarray(val, dtype=np.float32)
            if name == 'kernel':
                name, a = 'weight', a.T
            elif name == 'embedding':
                name = 'weight'
            s[prefix + name] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, '')
    return s


def make_reference_dimamba_state_dict(rng: np.random.RandomState, *,
                                      hidden: int, cond_dim: int,
                                      n_blocks: int, vocab: int,
                                      d_state: int = 16, d_conv: int = 4,
                                      expand: int = 2,
                                      num_classes: Optional[int] = None,
                                      bidirectional: bool = True,
                                      weight_tie: bool = True) -> Dict:
    """Seeded random weights with the reference DiMamba's names and shapes
    (numpy arrays, N(0, 0.05^2); norm weights around 1, dt biases in
    [-4, -2), A_log the S4D init, D around 1; the adaLN projections are
    drawn too, so every block's gate is non-zero); `num_classes` adds its
    class table with the null row."""
    d_inner = expand * hidden
    dt_rank = math.ceil(hidden / 16)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32) * 0.05

    s: Dict = {}
    s['sigma_map.mlp.0.weight'] = r(cond_dim, 256)
    s['sigma_map.mlp.0.bias'] = r(cond_dim)
    s['sigma_map.mlp.2.weight'] = r(cond_dim, cond_dim)
    s['sigma_map.mlp.2.bias'] = r(cond_dim)
    if num_classes is not None:
        s['cond_map.embedding_table.weight'] = r(num_classes + 1, cond_dim)
    bb = 'model.bimamba.backbone.'
    s[bb + 'embeddings.word_embeddings.weight'] = r(vocab, hidden)

    def core(p):
        s[p + 'conv1d.weight'] = r(d_inner, 1, d_conv)
        s[p + 'conv1d.bias'] = r(d_inner)
        s[p + 'x_proj.weight'] = r(dt_rank + 2 * d_state, d_inner)
        s[p + 'dt_proj.weight'] = r(d_inner, dt_rank)
        s[p + 'dt_proj.bias'] = rng.rand(d_inner).astype(np.float32) * 2 - 4
        s[p + 'A_log'] = np.log(np.broadcast_to(
            np.arange(1, d_state + 1, dtype=np.float32),
            (d_inner, d_state))).copy()
        s[p + 'D'] = np.ones(d_inner, np.float32) + r(d_inner)

    for i in range(n_blocks):
        p = bb + f'layers.{i}.'
        s[p + 'norm.weight'] = r(hidden) + 1
        s[p + 'norm.bias'] = r(hidden)
        s[p + 'adaLN_modulation.weight'] = r(3 * hidden, cond_dim)
        s[p + 'adaLN_modulation.bias'] = r(3 * hidden)
        s[p + 'mixer.mamba_fwd.in_proj.weight'] = r(2 * d_inner, hidden)
        s[p + 'mixer.mamba_fwd.out_proj.weight'] = r(hidden, d_inner)
        core(p + 'mixer.mamba_fwd.')
        if bidirectional:
            core(p + 'mixer.mamba_rev.')
            for name, shape in (('in_proj', (2 * d_inner, hidden)),
                                ('out_proj', (hidden, d_inner))):
                s[p + f'mixer.mamba_rev.{name}.weight'] = (
                    s[p + f'mixer.mamba_fwd.{name}.weight'] if weight_tie
                    else r(*shape))
    s[bb + 'norm_f.weight'] = r(hidden) + 1
    s[bb + 'norm_f.bias'] = r(hidden)
    s[bb + 'adaLN_modulation_final.weight'] = r(2 * hidden, cond_dim)
    s[bb + 'adaLN_modulation_final.bias'] = r(2 * hidden)
    s['model.lm_head.weight'] = r(vocab, hidden)
    return s
