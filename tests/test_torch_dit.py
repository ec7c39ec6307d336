"""The port's DiT (`ddg_tpu_torch.models.dit`) against `ddg_tpu`'s flax
DIT on the same weights, carried across by `convert.
dit_state_dict_from_jax`: float32 logits to the 1e-3 per-step bar of
BASELINE.md, with the fused flags off on both sides and on on both sides
(JAX's adaLN kernels in interpret mode; the port's plain versions on the
CPU). The trunk-only outputs and the head functions are compared too."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu import convert as jconvert
from ddg_tpu.models import dit as jdit
from ddg_tpu.ops import attention_pallas as jap
from ddg_tpu_torch import convert as tconvert
from ddg_tpu_torch.models import DIT, DITConfig, make_model_apply
from ddg_tpu_torch.models import dit as tdit

torch.set_num_threads(1)
HID, COND, NB, NH, L, V, NC = 128, 32, 2, 2, 16, 37, 2
ATOL = 1e-3


def jax_cfg(**kw):
    return jdit.DITConfig(hidden_size=HID, cond_dim=COND, length=L,
                          n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                          num_classes=NC, compute_dtype=jnp.float32, **kw)


def torch_cfg(**kw):
    return DITConfig(hidden_size=HID, cond_dim=COND, length=L, n_blocks=NB,
                     n_heads=NH, vocab_size=V, num_classes=NC,
                     compute_dtype=torch.float32, **kw)


@pytest.fixture(scope='module')
def weights():
    """JAX-initialised params, perturbed by seeded noise: flax zero-inits
    the adaLN projections and the vocab head, which would make the logits
    trivially zero."""
    x = jnp.zeros((1, L), jnp.int32)
    params = jdit.DIT(jax_cfg()).init(
        jax.random.PRNGKey(0), x, jnp.ones((1,)),
        jnp.zeros((1,), jnp.int32))['params']
    r = np.random.RandomState(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * r.randn(*p.shape).astype(np.float32),
        params)
    return params


@pytest.fixture(scope='module')
def inputs():
    r = np.random.RandomState(2)
    return (r.randint(0, V, (3, L)).astype(np.int32),
            r.uniform(0, 2, 3).astype(np.float32),
            np.array([0, 1, NC], np.int32))      # NC is the null class


def torch_model(weights, **kw):
    m = DIT(torch_cfg(**kw))
    m.load_state_dict(tconvert.dit_state_dict_from_jax(weights,
                                                       n_blocks=NB),
                      strict=True)
    return m.eval()


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


FLAGS = {
    'unfused': (dict(fused_adaln=False, fused_rope_attn=False),
                dict(fused_adaln=False, fused_rope_attn=False)),
    'fused': (dict(fused_adaln='interpret', fused_rope_attn=True),
              dict(fused_adaln=True, fused_rope_attn=True)),
}


@pytest.mark.parametrize('flags', list(FLAGS))
def test_logits_match_jax(weights, inputs, flags):
    jkw, tkw = FLAGS[flags]
    x, sigma, cond = inputs
    want = jdit.DIT(jax_cfg(**jkw)).apply(
        {'params': weights}, jnp.asarray(x), jnp.asarray(sigma),
        jnp.asarray(cond))
    assert float(jnp.abs(want).max()) > 0.1      # not trivially zero
    m = torch_model(weights, **tkw)
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(sigma),
                torch.from_numpy(cond))
    close(got, want)


@pytest.mark.parametrize('flags', list(FLAGS))
def test_trunk_and_head_functions_match_jax(weights, inputs, flags):
    jkw, tkw = FLAGS[flags]
    x, sigma, cond = inputs
    jc = jax_cfg(**jkw)
    jh, jcv = jdit.DIT(jc).apply({'params': weights}, jnp.asarray(x),
                                 jnp.asarray(sigma), jnp.asarray(cond),
                                 skip_head=True)
    m = torch_model(weights, **tkw)
    apply_fn = make_model_apply(m)
    th, tcv = apply_fn(apply_fn.params, torch.from_numpy(x),
                       torch.from_numpy(sigma), torch.from_numpy(cond),
                       skip_head=True)
    close(th, jh)
    close(tcv, jcv)
    p = apply_fn.params
    jf = jdit.dit_head_features(jc, weights, jh, jcv)
    tf = tdit.dit_head_features(m.cfg, p, th, tcv)
    close(tf, jf)
    close(tdit.dit_head_matmul(m.cfg, p, tf),
          jdit.dit_head_matmul(jc, weights, jf))
    rows = np.array([3, 0, L - 1])
    close(tdit.dit_head_fn(m.cfg, p, th[torch.arange(3), rows], tcv),
          jdit.dit_head_fn(jc, weights, jh[jnp.arange(3), rows], jcv))


def test_return_hidden_states(weights, inputs):
    x, sigma, cond = inputs
    jl, jh = jdit.DIT(jax_cfg()).apply(
        {'params': weights}, jnp.asarray(x), jnp.asarray(sigma),
        jnp.asarray(cond), return_hidden_states=True)
    apply_fn = make_model_apply(torch_model(weights))
    tl, th = apply_fn(apply_fn.params, torch.from_numpy(x),
                      torch.from_numpy(sigma), torch.from_numpy(cond),
                      return_hidden_states=True)
    close(tl, jl)
    close(th, jh)


def test_model_apply_with_other_params(weights, inputs):
    """A params dict other than the module's own runs through
    functional_call and gives what loading those weights gives."""
    x, sigma, cond = inputs
    m = torch_model(weights)
    apply_fn = make_model_apply(m)
    other = {k: v * 1.5 for k, v in apply_fn.params.items()}
    got = apply_fn(other, torch.from_numpy(x), torch.from_numpy(sigma),
                   torch.from_numpy(cond))
    m2 = DIT(m.cfg)
    m2.load_state_dict(other, strict=True)
    with torch.no_grad():
        want = m2(torch.from_numpy(x), torch.from_numpy(sigma),
                  torch.from_numpy(cond))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # In train mode (dropout 0.1) the other dict runs with gradients,
    # which reach every one of its tensors.
    other = {k: v.detach().clone().requires_grad_()
             for k, v in other.items()}
    out = apply_fn(other, torch.from_numpy(x), torch.from_numpy(sigma),
                   torch.from_numpy(cond), train=True,
                   rng=torch.Generator().manual_seed(0))
    assert out.requires_grad and out.shape == want.shape
    out.sum().backward()
    assert all(v.grad is not None for v in other.values())


def test_state_dict_conversion_matches_export(weights):
    """The port's own copy of `export_dit_params`, and of the seeded
    reference weights, give the JAX package's arrays."""
    ours = tconvert.dit_state_dict_from_jax(weights, n_blocks=NB)
    theirs = jconvert.export_dit_params(weights, n_blocks=NB)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    kw = dict(hidden=HID, cond_dim=COND, n_blocks=NB, vocab=V,
              with_cond=True)
    ours = tconvert.make_reference_dit_state_dict(np.random.RandomState(3),
                                                  **kw)
    theirs = jconvert.make_reference_dit_state_dict(
        np.random.RandomState(3), **kw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])
    DIT(torch_cfg()).load_state_dict(ours, strict=True)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        torch_cfg(tensor_axis='model')
    assert dataclasses.replace(torch_cfg(), fused_adaln=True).fused_adaln


def test_short_seq_attention_logits_match_jax(weights, inputs, monkeypatch):
    """`pallas_attention=True` builds and runs RoPE then K2 (its plain
    version on the CPU); JAX runs its short-sequence Pallas kernel in
    interpret mode. Float32 logits to the same bar."""
    monkeypatch.setattr(jap, 'short_seq_attention', functools.partial(
        jap.short_seq_attention, interpret=True))
    x, sigma, cond = inputs
    want = jdit.DIT(jax_cfg(pallas_attention=True)).apply(
        {'params': weights}, jnp.asarray(x), jnp.asarray(sigma),
        jnp.asarray(cond))
    m = torch_model(weights, pallas_attention=True)
    assert m.cfg.pallas_attention and not m.cfg.fused_rope_attn
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(sigma),
                torch.from_numpy(cond))
    close(got, want)
