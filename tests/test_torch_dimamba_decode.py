"""The port's stateful DiMamba decode (`ddg_tpu_torch.models.
dimamba_decode`) against `ddg_tpu.models.dimamba_decode` and against the
port's own unidirectional forward, float32, on a tiny DiMamba (hidden 32,
2 blocks, d_state 4, d_conv 4, L=20 over scan chunks of 8, V=12), the JAX
weights seeded, perturbed by 0.05 and carried into the port by
`convert.dimamba_state_dict_from_jax`.

- the logits of every step equal JAX's decode to 1e-4 (abs and rel), with
  and without a class, and so do the conv and SSM states after the last
  step;
- the decode equals the port's full unidirectional forward at every
  position to `tests/test_dimamba_decode.py`'s bar (atol 2e-3, rtol 1e-2;
  the decode's norms take eps 1e-5 where the model's take flax's 1e-6),
  with and without a class;
- `ar_sample` through the decode (unguided without a class, D-CFG at
  gamma 2 with 2B decode rows with one) gives JAX's tokens from JAX's
  noise wherever the top-two perturbed scores differ by more than 1e-4,
  and warns that `ar_kv_int8` has no effect; a bidirectional model is
  refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu import samplers as JS
from ddg_tpu.diffusion import DiffusionSpec as JSpec
from ddg_tpu.models import dimamba as jdm
from ddg_tpu.models import dimamba_decode as jdec
from ddg_tpu.models import make_model_apply as j_model_apply
from ddg_tpu.ops import sampling as jsampling
from ddg_tpu.ops.noise_schedules import LogLinearNoise as JLogLinear
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.convert import dimamba_state_dict_from_jax
from ddg_tpu_torch.diffusion import DiffusionSpec as TSpec
from ddg_tpu_torch.models import DiMamba, DiMambaConfig, make_model_apply
from ddg_tpu_torch.models import dimamba_decode as tdec
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise as TLogLinear

torch.set_num_threads(1)
KW = dict(hidden_size=32, cond_dim=16, length=20, n_blocks=2, vocab_size=12,
          d_state=4, d_conv=4, scan_chunk=8, bidirectional=False,
          dropout=0.0)
B, MARGIN = 3, 1e-4
KEY = jax.random.PRNGKey(4)


@pytest.fixture(scope='module', params=[False, True], ids=['nocond',
                                                          'cond'])
def model(request):
    """(JAX cfg, JAX params, port cfg, port apply, tokens, classes)."""
    cond = request.param
    extra = dict(use_adaLN=cond, num_classes=3 if cond else None)
    jcfg = jdm.DiMambaConfig(**KW, **extra, compute_dtype=jnp.float32)
    tcfg = DiMambaConfig(**KW, **extra, compute_dtype=torch.float32)
    r = np.random.RandomState(9)
    x = r.randint(0, 12, (B, 20)).astype(np.int32)
    c = np.array([0, 2, 3], np.int32) if cond else None
    # Initialised with a sigma so that the sigma map exists (the port's
    # model always holds one); the AR forward and decode pass none.
    params = jdm.DiMamba(jcfg).init(
        KEY, jnp.asarray(x), jnp.ones((B,)),
        None if c is None else jnp.asarray(c))['params']
    params = jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * r.randn(*p.shape)
                              .astype(np.float32)), params)
    m = DiMamba(tcfg)
    m.load_state_dict(dimamba_state_dict_from_jax(params, n_blocks=2),
                      strict=True)
    return jcfg, params, tcfg, make_model_apply(m.eval()), x, c


def _port_decode(tcfg, tapply, x, c):
    params = tdec.precast(tapply.params)
    cache = tdec.init_cache(tcfg, B)
    out = []
    with torch.no_grad():
        for pos in range(x.shape[1]):
            logits, cache = tdec.decode_step(
                tcfg, params, cache, torch.from_numpy(x[:, pos]),
                cond=None if c is None else torch.from_numpy(c))
            out.append(logits)
    return torch.stack(out, 1), cache


def test_decode_matches_jax(model):
    jcfg, jparams, tcfg, tapply, x, c = model
    got, tcache = _port_decode(tcfg, tapply, x, c)
    step = jax.jit(jdec.decode_step, static_argnums=(0,))
    cache = jdec.init_cache(jcfg, B)
    want = []
    for pos in range(x.shape[1]):
        logits, cache = step(jcfg, jparams, cache, jnp.asarray(x[:, pos]),
                             cond=None if c is None else jnp.asarray(c))
        want.append(np.asarray(logits))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-4,
                               atol=1e-4)
    for name in ('conv', 'ssm'):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(cache[name]), rtol=1e-4,
                                   atol=1e-5)


def test_decode_matches_full_forward(model):
    _, _, tcfg, tapply, x, c = model
    full = tapply(tapply.params, torch.from_numpy(x), None,
                  None if c is None else torch.from_numpy(c))
    got, _ = _port_decode(tcfg, tapply, x, c)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-3,
                               rtol=1e-2)


def _noise(shape):
    return torch.from_numpy(np.array(jsampling.gumbel_noise_like(
        jax.random.split(KEY)[0], shape, dtype=jnp.float32)))


def test_ar_sample_matches_jax(model, monkeypatch):
    """Unguided on the model without classes, D-CFG on the other."""
    jcfg, jparams, tcfg, tapply, _, c = model
    guided = c is not None
    kw = dict(method='cfg', gamma=2.0)
    spec = dict(diffusion='absorbing_state', parameterization='ar',
                vocab_size=12, mask_index=3,
                num_classes=3 if c is not None else None)
    want = np.asarray(JS.ar_sample(
        JSpec(noise=JLogLinear(), **spec), JS.SamplerSpec(),
        j_model_apply(jdm.DiMamba(jcfg)), jparams, KEY, batch_size=B,
        length=20, bos_token_id=2,
        guidance=JS.GuidanceSpec(**kw) if guided else None,
        cond=jnp.asarray(c) if guided else None, decode_cfg=jcfg))
    seen = []
    real = TS._ar_token

    def token(sampler, log_probs, noise):
        seen.append((log_probs + noise).clone())
        return real(sampler, log_probs, noise)

    monkeypatch.setattr(TS, '_ar_noise', lambda s, g, shape: _noise(shape))
    monkeypatch.setattr(TS, '_ar_token', token)
    with pytest.warns(UserWarning, match='no KV cache'):
        got = TS.ar_sample(
            TSpec(noise=TLogLinear(), **spec),
            TS.SamplerSpec(ar_kv_int8=True),
            tapply, tapply.params, torch.Generator(), batch_size=B,
            length=20, bos_token_id=2,
            guidance=TS.GuidanceSpec(**kw) if guided else None,
            cond=torch.from_numpy(c) if guided else None,
            decode_cfg=tcfg).numpy()
    for b in range(B):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            top2 = seen[diff[0] - 1][b].topk(2).values
            assert (top2[0] - top2[1]).item() <= MARGIN, (b, diff[0])
    assert (got == want).all(axis=1).mean() >= 2 / 3


def test_bidirectional_refused(model):
    _, _, tcfg, tapply, _, _ = model
    cfg = dataclasses.replace(tcfg, bidirectional=True)
    with pytest.raises(ValueError, match='unidirectional'):
        tdec.decode_step(cfg, tapply.params, tdec.init_cache(cfg, 1),
                         torch.zeros(1, dtype=torch.int32))
