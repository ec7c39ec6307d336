"""The serving slice as a whole: the port's samplers against `ddg_tpu`'s on
the same DiT weights.

(a) One feature-mix D-CFG step (gamma 2) with the same Gumbel noise on
    both sides gives the same tokens wherever the top-two perturbed scores
    differ by more than 1e-4.
(b) Whole sampling loops (ancestral with and without the NFE cache, and
    first-hitting) draw the same distribution: the two-sample TV of the
    pooled token histograms stays below twice its binomial floor, and
    leftover mask tokens stay within 5 per 8K.
On the CPU the port's samplers take the unfused chain, as the JAX package
does off the TPU; the "fused" cases force the port's fused branches so
they run with the kernels' plain versions.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu import samplers as JS
from ddg_tpu.diffusion import DiffusionSpec as JSpec
from ddg_tpu.models import make_model_apply as j_make_apply
from ddg_tpu.models import dit as jdit
from ddg_tpu.ops import fused_sampling as jfs
from ddg_tpu.ops.noise_schedules import LogLinearNoise as JLogLinear
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.convert import dit_state_dict_from_jax
from ddg_tpu_torch.diffusion import DiffusionSpec as TSpec
from ddg_tpu_torch.models import DIT, DITConfig, make_model_apply
from ddg_tpu_torch.ops import fused_sampling as tfs
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise as TLogLinear

torch.set_num_threads(1)
HID, COND, NB, NH, V, NC = 128, 32, 2, 2, 37, 2
MASK = V - 1
GAMMA = 2.0
BATCH, LEN, STEPS = 256, 8, 16

JCFG = jdit.DITConfig(hidden_size=HID, cond_dim=COND, length=LEN,
                      n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                      num_classes=NC, compute_dtype=jnp.float32)
TCFG = DITConfig(hidden_size=HID, cond_dim=COND, length=LEN, n_blocks=NB,
                 n_heads=NH, vocab_size=V, num_classes=NC,
                 compute_dtype=torch.float32, fused_adaln=True,
                 fused_rope_attn=True)
JSPEC = JSpec(diffusion='absorbing_state', parameterization='subs',
              noise=JLogLinear(), vocab_size=V, mask_index=MASK,
              num_classes=NC)
TSPEC = TSpec(diffusion='absorbing_state', parameterization='subs',
              noise=TLogLinear(), vocab_size=V, mask_index=MASK,
              num_classes=NC)
GUIDE = dict(method='cfg', gamma=GAMMA)


@pytest.fixture(scope='module')
def models():
    """JAX-initialised weights perturbed by seeded noise (enough that the
    token distribution is far from uniform), on both sides."""
    params = jdit.DIT(JCFG).init(
        jax.random.PRNGKey(0), jnp.zeros((1, LEN), jnp.int32),
        jnp.ones((1,)), jnp.zeros((1,), jnp.int32))['params']
    r = np.random.RandomState(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * r.randn(*p.shape).astype(np.float32),
        params)
    m = DIT(TCFG)
    m.load_state_dict(dit_state_dict_from_jax(params, n_blocks=NB),
                      strict=True)
    return params, j_make_apply(jdit.DIT(JCFG)), make_model_apply(m.eval())


@pytest.fixture
def forced_fused(monkeypatch):
    """Run the port's fused branches on the CPU (plain kernel versions)."""
    def force(spec, sampler, guidance, xt):
        return sampler.fused
    monkeypatch.setattr(TS, '_fused_ok', force)


def test_feature_mix_step_matches_jax(models, forced_fused, monkeypatch):
    jparams, japply, tapply = models
    B = 4
    r = np.random.RandomState(2)
    x0 = r.randint(0, MASK, (B, LEN))
    xt = np.where(r.rand(B, LEN) < 0.7, MASK, x0).astype(np.int32)
    sigma = r.uniform(0.1, 2.0, B).astype(np.float32)
    mct = r.uniform(0.4, 0.9, B).astype(np.float32)
    mcs = (0.5 * mct).astype(np.float32)
    cond = np.array([0, 1, 0, 1], np.int32)
    g = r.gumbel(size=(B, LEN, V)).astype(np.float32)

    # JAX, composed as samplers._cfg_step's feature-mix path composes it.
    x2 = jnp.concatenate([xt, xt])
    c2 = jnp.concatenate([cond, jnp.full_like(cond, NC)])
    hidden2, cvec2 = japply(jparams, x2, jnp.zeros(2 * B), c2, None,
                            train=False, rng=None, skip_head=True)
    feats2 = jdit.dit_head_features(JCFG, jparams, hidden2, cvec2)
    fmix = GAMMA * feats2[:B] + (1 - GAMMA) * feats2[B:]
    logits = jdit.dit_head_matmul(JCFG, jparams, fmix.astype(feats2.dtype)
                                  ).astype(jnp.bfloat16)
    want = jfs.fused_absorbing_sample(
        5, jnp.asarray(xt), logits, jnp.asarray(mct), jnp.asarray(mcs),
        mask_index=MASK, interpret=True, gumbel=jnp.asarray(g))

    # The port's own step, with the same noise handed to its sampler.
    seen = {}

    def with_noise(seed, xt_, logits_, mct_, mcs_, *, mask_index):
        seen['logits'] = logits_
        return tfs.fused_absorbing_sample(seed, xt_, logits_, mct_, mcs_,
                                          mask_index=mask_index,
                                          gumbel=torch.from_numpy(g))
    monkeypatch.setattr(TS, 'fused_absorbing_sample', with_noise)
    t = torch.from_numpy
    with torch.no_grad():
        got, _ = TS._cfg_step(
            TSPEC, TS.SamplerSpec(fused=True, use_cache=False),
            TS.GuidanceSpec(**GUIDE), tapply, tapply.params,
            torch.Generator().manual_seed(0), t(xt), t(sigma),
            t(mct)[:, None, None], t(mcs)[:, None, None], t(cond), None,
            None, dit_cfg=TCFG)
    assert seen['logits'].dtype == torch.bfloat16
    np.testing.assert_allclose(seen['logits'].float().numpy(),
                               np.asarray(logits.astype(jnp.float32)),
                               atol=0.05, rtol=0)
    scores = tfs.perturbed_scores(5, seen['logits'].float(), t(mct), t(mcs),
                                  mask_index=MASK, gumbel=t(g))
    top2 = scores.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > 1e-4) | (t(xt) != MASK)
    assert decided.float().mean() > 0.9
    want = torch.from_numpy(np.array(want))
    np.testing.assert_array_equal(got[decided].numpy(),
                                  want[decided].numpy())


@pytest.fixture(scope='module')
def jax_tokens(models):
    """JAX's tokens for (use_cache, first_hitting), computed once each."""
    jparams, japply, _ = models
    cache = {}

    def get(use_cache, first_hitting):
        if (use_cache, first_hitting) not in cache:
            sampler = JS.SamplerSpec(steps=STEPS, use_cache=use_cache,
                                     first_hitting=first_hitting)
            run = jax.jit(lambda params, key: JS.diffusion_sample(
                JSPEC, sampler, japply, params, key, batch_size=BATCH,
                length=LEN, guidance=JS.GuidanceSpec(**GUIDE),
                cond=jnp.zeros((BATCH,), jnp.int32), dit_cfg=JCFG))
            cache[use_cache, first_hitting] = np.asarray(
                run(jparams, jax.random.PRNGKey(3)))
        return cache[use_cache, first_hitting]
    return get


def _two_sample_check(a, b):
    ha = np.bincount(a.ravel(), minlength=V) / a.size
    hb = np.bincount(b.ravel(), minlength=V) / b.size
    q = (ha + hb) / 2
    tv = 0.5 * np.abs(ha - hb).sum()
    floor = 0.5 * np.sqrt(4 * q * (1 - q) / (math.pi * a.size)).sum()
    assert tv < 2 * floor, (tv, floor)
    assert ha.max() > 2.0 / V          # far from uniform: the test has teeth
    allowed = math.ceil(5 * a.size / 8192)
    assert (a == MASK).sum() <= allowed and (b == MASK).sum() <= allowed


@pytest.mark.parametrize('mode, sampler', [
    ('unfused', 'ancestral'), ('unfused', 'ancestral_cache'),
    ('unfused', 'first_hitting'),
    # The feature-mix path and the CFG kernel's path.
    ('fused', 'ancestral'), ('fused', 'ancestral_cache')])
def test_sampling_distribution_matches_jax(models, jax_tokens, monkeypatch,
                                           mode, sampler):
    if mode == 'fused':
        monkeypatch.setattr(TS, '_fused_ok',
                            lambda spec, s, guidance, xt: s.fused)
    _, _, tapply = models
    use_cache = sampler == 'ancestral_cache'
    first_hitting = sampler == 'first_hitting'
    want = jax_tokens(use_cache, first_hitting)
    got = TS.diffusion_sample(
        TSPEC, TS.SamplerSpec(steps=STEPS, use_cache=use_cache,
                              fused=mode == 'fused',
                              first_hitting=first_hitting),
        tapply, tapply.params, torch.Generator().manual_seed(4),
        batch_size=BATCH, length=LEN, guidance=TS.GuidanceSpec(**GUIDE),
        cond=torch.zeros((BATCH,), dtype=torch.int32), dit_cfg=TCFG)
    assert got.shape == (BATCH, LEN) and got.dtype == torch.int32
    assert ((got >= 0) & (got < V)).all()
    _two_sample_check(got.numpy(), want)


def test_unported_paths_raise(models):
    _, _, tapply = models
    gen = torch.Generator().manual_seed(0)
    kw = dict(batch_size=2, length=LEN, dit_cfg=TCFG)
    with pytest.raises(NotImplementedError):
        TS.diffusion_sample(TSPEC, TS.SamplerSpec(steps=2), tapply,
                            tapply.params, gen,
                            guidance=TS.GuidanceSpec(method='fudge'), **kw)
