"""The port's KV-cache decode (`ddg_tpu_torch.models.dit_decode`) against
`ddg_tpu.models.dit_decode` and against the port's own causal forward, on
a tiny causal DiT (hidden 64, 2 blocks of 2 heads, L=24, V=12), the JAX
weights seeded, perturbed and carried into the port by
`convert.dit_state_dict_from_jax`.

- float32, with and without a class (adaLN), the float and the int8
  cache, the first half of the positions through a 16-row window: the
  logits of every step equal JAX's to 1e-4 (abs and rel); the float
  cache equals JAX's to 1e-5 (the port's is heads-major: permuted before
  the comparison); the int8 codes equal JAX's except where x / scale lies
  within float error of a half (at most 0.1% of them, and those by one
  code), the scales to 1e-5 relative (an ulp of k moves its absmax);
- the decode equals the port's full causal forward at every position to
  `tests/test_dit_decode.py`'s bar (atol 2e-4, rtol 1e-3); the int8 cache
  stays within 2% of the logits' span of it, JAX's bar;
- bfloat16: the logits within 2% of their span of JAX's bf16 decode (both
  round the same weights; the order of their sums differs), and the
  dense weights cast once (`precast`) give bit-identical logits;
- `_quant_row` and `_rope_at` against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.models import dit as jdit
from ddg_tpu.models import dit_decode as jdec
from ddg_tpu_torch.convert import dit_state_dict_from_jax
from ddg_tpu_torch.models import DIT, DITConfig, make_model_apply
from ddg_tpu_torch.models import dit_decode as tdec

torch.set_num_threads(1)
HID, COND, NB, NH, L, V, B = 64, 32, 2, 2, 24, 12, 3
WINDOW = 16


def jax_cfg(cond, dtype=jnp.float32):
    return jdit.DITConfig(hidden_size=HID, cond_dim=COND, length=L,
                          n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                          causal=True, use_adaLN=cond,
                          num_classes=2 if cond else None,
                          compute_dtype=dtype)


def torch_cfg(cond, dtype=torch.float32):
    return DITConfig(hidden_size=HID, cond_dim=COND, length=L, n_blocks=NB,
                     n_heads=NH, dropout=0.0, vocab_size=V, causal=True,
                     use_adaLN=cond, num_classes=2 if cond else None,
                     compute_dtype=dtype, fused_rope_attn=True,
                     fused_adaln=True)


@pytest.fixture(scope='module', params=[False, True], ids=['nocond',
                                                          'cond'])
def model(request):
    """(cond flag, JAX params, port params, tokens, classes)."""
    cond = request.param
    r = np.random.RandomState(7)
    x = r.randint(0, V, (B, L)).astype(np.int32)
    c = np.array([0, 1, 2], np.int32) if cond else None
    params = jdit.DIT(jax_cfg(cond)).init(
        jax.random.PRNGKey(0), jnp.asarray(x), None,
        None if c is None else jnp.asarray(c))['params']
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * r.randn(*p.shape)
                              .astype(np.float32)), params)
    m = DIT(torch_cfg(cond))
    m.load_state_dict(dit_state_dict_from_jax(params, n_blocks=NB),
                      strict=True)
    return cond, params, make_model_apply(m.eval()), x, c


def _window(pos):
    return WINDOW if pos < WINDOW else None


def _run_port(cfg, params, x, c, kv_int8, window=_window):
    cache = tdec.init_cache(cfg, B, kv_int8=kv_int8)
    out = []
    with torch.no_grad():
        for pos in range(L):
            logits, cache = tdec.decode_step(
                cfg, params, cache, torch.from_numpy(x[:, pos]), pos,
                cond=None if c is None else torch.from_numpy(c),
                window=window(pos))
            out.append(logits)
    return torch.stack(out, 1), cache


_jax_decode = jax.jit(jdec.decode_step, static_argnums=(0,),
                      static_argnames=('window',))


def _run_jax(cfg, params, x, c, kv_int8):
    cache = jdec.init_cache(cfg, B, kv_int8=kv_int8)
    out = []
    for pos in range(L):
        logits, cache = _jax_decode(
            cfg, params, cache, jnp.asarray(x[:, pos]), jnp.asarray(pos),
            cond=None if c is None else jnp.asarray(c), window=_window(pos))
        out.append(np.asarray(logits, np.float32))
    return np.stack(out, 1), cache


@pytest.mark.parametrize('kv_int8', [False, True], ids=['float', 'int8'])
def test_decode_matches_jax(model, kv_int8):
    cond, jparams, tapply, x, c = model
    got, tcache = _run_port(torch_cfg(cond), tapply.params, x, c, kv_int8)
    want, jcache = _run_jax(jax_cfg(cond), jparams, x, c, kv_int8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    for name in ('k', 'v'):
        t = tcache[name].permute(0, 1, 3, 2, 4).numpy()
        j = np.asarray(jcache[name])
        if not kv_int8:
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
            continue
        diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (
            name, diff.max(), (diff > 0).mean())
        np.testing.assert_allclose(
            tcache[name + '_s'].permute(0, 1, 3, 2).numpy(),
            np.asarray(jcache[name + '_s']), rtol=1e-5, atol=0)


def test_decode_matches_full_forward(model):
    cond, _, tapply, x, c = model
    tc = None if c is None else torch.from_numpy(c)
    full = tapply(tapply.params, torch.from_numpy(x), None, tc)
    got, _ = _run_port(torch_cfg(cond), tapply.params, x, c, False)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-4,
                               rtol=1e-3)
    got8, _ = _run_port(torch_cfg(cond), tapply.params, x, c, True)
    for pos in range(L):
        ref = full[:, pos]
        err = (got8[:, pos] - ref).abs().max().item()
        span = ref.abs().max().item()
        assert err < 0.02 * span, (pos, err, span)


def test_window_does_not_change_logits(model):
    cond, _, tapply, x, c = model
    cfg = torch_cfg(cond)
    a, _ = _run_port(cfg, tapply.params, x, c, False)
    b, _ = _run_port(cfg, tapply.params, x, c, False, window=lambda p: None)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tdec.decode_step(cfg, tapply.params, tdec.init_cache(cfg, B),
                         torch.zeros(B, dtype=torch.int32), WINDOW,
                         window=WINDOW)


def test_bf16_decode_close_to_jax_and_precast_exact(model):
    cond, jparams, _, x, c = model
    tcfg = torch_cfg(cond, torch.bfloat16)
    m = DIT(tcfg)
    m.load_state_dict(dit_state_dict_from_jax(jparams, n_blocks=NB),
                      strict=True)
    params = make_model_apply(m.eval()).params
    got, _ = _run_port(tcfg, params, x, c, False)
    pre, _ = _run_port(tcfg, tdec.precast(tcfg, params), x, c, False)
    torch.testing.assert_close(got, pre, rtol=0, atol=0)
    want, _ = _run_jax(jax_cfg(cond, jnp.bfloat16), jparams, x, c, False)
    span = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() < 0.02 * span


def test_quant_row_and_rope_match_jax():
    r = np.random.RandomState(3)
    x = (r.randn(4, 3, 64) * r.uniform(0.01, 10, (4, 3, 1))).astype(
        np.float32)
    x[0, 0] = 0.0
    q, s = tdec._quant_row(torch.from_numpy(x))
    jq, js = jdec._quant_row(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    for pos in (0, 5, L - 1):
        cos, sin = tdec._rope_at(pos, 32, L, 'cpu')
        jc, js_ = jdec._rope_at(jnp.asarray(pos), 32)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(sin.numpy(), np.asarray(js_), atol=1e-6)


def test_cache_layout():
    cfg = dataclasses.replace(torch_cfg(True), length=8)
    c = tdec.init_cache(cfg, 5)
    assert c['k'].shape == (NB, 5, NH, 8, HID // NH)
    assert c['k'].dtype == torch.float32
    c8 = tdec.init_cache(cfg, 5, kv_int8=True)
    assert c8['v'].dtype == torch.int8 and c8['v_s'].shape == (NB, 5, NH, 8)
