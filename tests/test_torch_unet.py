"""The port's UNet (`ddg_tpu_torch.models.unet`) and the image serving slice
against `ddg_tpu` on the same weights, carried across by
`convert.unet_state_dict_from_jax`, at `bench.py --unet --quick`'s size
(ch 16, one res block, 2 scales, 8 x 8 x 3 images: L=192, V=256).

- float32 logits equal the flax UNet's to the 1e-3 per-step bar of
  BASELINE.md, with the fused GroupNorm off on both sides and on on both
  sides (JAX's kernel in interpret mode, the port's plain version), with
  the relative 5e-3 that `tests/test_convert_parity_unet.py` allows the
  logistic head's tail: log1p(-exp(b - a) + 1e-6) with b ~ a cancels, so
  a one-ulp difference in exp near 1 moves a tail logit near log(1e-6) by
  up to a few 1e-3 relative. The trunk's output (the head's input) is
  held to 1e-4 abs;
- the bf16 trunk stays close to float32, as `tests/test_unet.py` asks of
  JAX;
- one fused D-CFG step (gamma 2) through the port's `_cfg_step` gives JAX's
  tokens (its UNet + `fused_uniform_cfg_sample` in interpret mode) from the
  same x_t, sigma and Gumbel noise, wherever the top-two perturbed scores
  differ by more than 1e-4;
- whole sampling loops through `entry.unet_flagship(tiny=True)` return
  tokens in [0, 256);
- training the int8 model raises, as the interpret switch does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.models import make_model_apply as j_make_apply
from ddg_tpu.models import unet as junet
from ddg_tpu.ops import fused_sampling as jfs
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.convert import unet_state_dict_from_jax
from ddg_tpu_torch.diffusion import DiffusionSpec as TSpec
from ddg_tpu_torch.entry import unet_flagship
from ddg_tpu_torch.models import UNet, UNetConfig, make_model_apply
from ddg_tpu_torch.ops import fused_sampling as tfs
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise as TLogLinear

torch.set_num_threads(1)
IMG, V, NC = 8, 256, 10
L = 3 * IMG * IMG
GAMMA = 2.0
ATOL = 1e-3
SMALL = dict(ch=16, num_res_blocks=1, num_scales=2, ch_mult=(1, 1),
             image_size=IMG, num_classes=NC, dropout=0.0)
JCFG = junet.UNetConfig(**SMALL, compute_dtype=jnp.float32)
TCFG = UNetConfig(**SMALL, compute_dtype=torch.float32)


@pytest.fixture(scope='module')
def params():
    """JAX-initialised params, perturbed by seeded noise: flax zero-inits
    the biases and (near) the attention output projection."""
    x = jnp.zeros((1, L), jnp.int32)
    p = jax.jit(junet.UNet(JCFG).init)(
        jax.random.PRNGKey(0), x, jnp.ones((1,)),
        jnp.zeros((1,), jnp.int32))['params']
    r = np.random.RandomState(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * r.randn(*a.shape).astype(np.float32),
        p)


@pytest.fixture(scope='module')
def inputs():
    r = np.random.RandomState(2)
    return (r.randint(0, V, (3, L)).astype(np.int32),
            r.uniform(0, 1, 3).astype(np.float32),
            np.array([0, 7, NC], np.int32))     # NC is the null class


def port_model(params, **kw):
    m = UNet(dataclasses.replace(TCFG, **kw))
    m.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    return m.eval()


@pytest.fixture(scope='module')
def jax_logits(params, inputs):
    """JAX's float32 (logits, trunk output) with the fused GroupNorm off
    and on."""
    out = {}
    for fused in (False, True):
        model = junet.UNet(dataclasses.replace(
            JCFG, fused_norm=fused, pallas_interpret=fused))
        fn = jax.jit(lambda p, x, s, c: model.apply(
            {'params': p}, x, s, c, return_hidden_states=True))
        out[fused] = tuple(np.asarray(a) for a in fn(params, *inputs))
    return out


def test_converter_maps_every_param(params):
    sd = unet_state_dict_from_jax(params)
    m = UNet(TCFG)
    assert set(sd) == set(m.state_dict())
    m.load_state_dict(sd, strict=True)
    k = np.asarray(params['down_0_0']['conv0']['kernel'])      # (3, 3, i, o)
    np.testing.assert_array_equal(
        m.down_0_0.conv0.weight.detach().numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(m.temb0.weight.detach().numpy(),
                                  np.asarray(params['temb0']['kernel']).T)
    np.testing.assert_array_equal(m.down_attn_1_0.q.W.detach().numpy(),
                                  np.asarray(params['down_attn_1_0']['q']['W']))
    np.testing.assert_array_equal(m.cond_map.weight.detach().numpy(),
                                  np.asarray(params['cond_map']['embedding']))


@pytest.mark.parametrize('fused_norm', [False, True], ids=['xla_gn', 'fused_gn'])
def test_float32_logits_match_jax(params, inputs, jax_logits, fused_norm):
    m = port_model(params, fused_norm=fused_norm)
    with torch.no_grad():
        got, hidden = m(*(torch.from_numpy(a) for a in inputs),
                        return_hidden_states=True)
    want, want_hidden = jax_logits[fused_norm]
    assert got.dtype == torch.float32 and got.shape == (3, L, V)
    assert want.std() > 1.0           # the logits vary: the test has teeth
    np.testing.assert_allclose(hidden.numpy(), want_hidden, atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=5e-3)


def test_bf16_trunk_close_to_float32(params, inputs):
    """As tests/test_unet.py holds the JAX bf16 policy: the per-position TV
    between the two softmaxes, mean under 0.03 and p95 under 0.08."""
    args = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        ref = port_model(params)(*args)
        got = port_model(params, compute_dtype=torch.bfloat16,
                         fused_norm=True)(*args)
    assert got.dtype == torch.float32
    tv = (ref.softmax(-1) - got.softmax(-1)).abs().sum(-1) / 2
    assert tv.mean() < 0.03 and torch.quantile(tv, 0.95) < 0.08, tv.mean()


def test_fused_cfg_step_matches_jax(params, monkeypatch):
    B = 2
    r = np.random.RandomState(3)
    xt = r.randint(0, V, (B, L)).astype(np.int32)
    sigma = r.uniform(0.1, 2.0, B).astype(np.float32)
    mct = (1 - np.exp(-sigma)).astype(np.float32)
    mcs = (0.6 * mct).astype(np.float32)
    cond = np.array([3, 8], np.int32)
    g = r.gumbel(size=(B, L, V)).astype(np.float32)

    # JAX: the UNet at 2B on [cond; null], bf16 logits, the Pallas kernel.
    japply = j_make_apply(junet.UNet(JCFG))
    fwd = jax.jit(lambda p, x, s, c: japply(p, x, s, c, None, train=False,
                                            rng=None))
    logits = fwd(params, jnp.concatenate([xt, xt]),
                 jnp.concatenate([sigma, sigma]),
                 jnp.concatenate([cond, np.full_like(cond, NC)])
                 ).astype(jnp.bfloat16)
    want = jfs.fused_uniform_cfg_sample(
        5, jnp.asarray(xt), logits[:B], logits[B:], GAMMA,
        jnp.asarray(1 - mct), jnp.asarray(1 - mcs), vocab_size=V,
        interpret=True, gumbel=jnp.asarray(g))

    # The port's own step, its fused branch forced on the CPU (the kernel's
    # plain version runs), the same noise handed to it.
    seen = {}

    def with_noise(seed, xt_, lc, lu, gamma, a_t, a_s, *, vocab_size):
        seen['args'] = (lc, lu, a_t, a_s)
        return tfs.fused_uniform_cfg_sample(seed, xt_, lc, lu, gamma, a_t,
                                            a_s, vocab_size=vocab_size,
                                            gumbel=torch.from_numpy(g))
    monkeypatch.setattr(TS, '_fused_ok',
                        lambda spec, sampler, guidance, xt: sampler.fused)
    monkeypatch.setattr(TS, 'fused_uniform_cfg_sample', with_noise)
    spec = TSpec(diffusion='uniform', parameterization='d3pm',
                 noise=TLogLinear(), vocab_size=V, mask_index=-1,
                 num_classes=NC, time_conditioning=True)
    tapply = make_model_apply(port_model(params, fused_norm=True))
    t = torch.from_numpy
    got, _ = TS._cfg_step(
        spec, TS.SamplerSpec(fused=True, use_cache=False),
        TS.GuidanceSpec(method='cfg', gamma=GAMMA), tapply, tapply.params,
        torch.Generator().manual_seed(0), t(xt), t(sigma),
        t(mct)[:, None, None], t(mcs)[:, None, None], t(cond), None, None)
    lc, lu, a_t, a_s = seen['args']
    assert lc.dtype == torch.bfloat16
    # The float32 bar above, plus up to two bf16 roundings (2^-7 each).
    np.testing.assert_allclose(
        torch.cat([lc, lu]).float().numpy(),
        np.asarray(logits.astype(jnp.float32)), atol=ATOL,
        rtol=5e-3 + 2 ** -6)
    scores = tfs.uniform_perturbed_scores(
        5, tfs.uniform_cfg_log_num(lc, lu, GAMMA, t(xt), a_t, a_s,
                                   vocab_size=V), vocab_size=V, gumbel=t(g))
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 1e-4
    assert decided.float().mean() > 0.9
    want = torch.from_numpy(np.array(want))
    np.testing.assert_array_equal(got[decided].numpy(),
                                  want[decided].numpy())


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
@pytest.mark.parametrize('guided', [False, True], ids=['unguided', 'dcfg'])
def test_sampling_loop_gives_pixel_tokens(fused, guided, monkeypatch):
    """`unet_flagship(tiny=True)` on the CPU: the unfused chain, and the
    fused branch forced (K9/K10's plain versions)."""
    if fused:
        monkeypatch.setattr(TS, '_fused_ok',
                            lambda spec, sampler, guidance, xt: sampler.fused)
    spec, cfg, _, apply_fn, params = unet_flagship(tiny=True, device='cpu')
    assert spec.vocab_size == 256 and spec.time_conditioning
    B = 2
    kw = {}
    if guided:
        kw = dict(guidance=TS.GuidanceSpec(method='cfg', gamma=GAMMA),
                  cond=torch.tensor([1, 9], dtype=torch.int32))
    x = TS.diffusion_sample(
        spec, TS.SamplerSpec(steps=3, use_cache=False, fused=fused),
        apply_fn, params, torch.Generator().manual_seed(4), batch_size=B,
        length=3 * cfg.image_size ** 2, **kw)
    assert x.dtype == torch.int32 and x.shape == (B, L)
    assert ((x >= 0) & (x < 256)).all()


def test_training_and_int8_raise():
    """Training the int8 model raises, as in JAX (int8 inference and
    float training are ported: `test_torch_unet_int8.py`,
    `test_torch_unet_train.py`); so does the interpret switch."""
    with pytest.raises(ValueError, match='interpret'):
        UNetConfig(pallas_interpret=True)
    m = UNet(dataclasses.replace(TCFG, quant_int8=True))
    with pytest.raises(ValueError, match='inference-only'):
        m(torch.zeros((1, L), dtype=torch.int32), torch.zeros(1), train=True,
          rng=torch.Generator())
