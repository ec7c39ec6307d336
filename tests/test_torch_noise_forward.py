"""The port's noise schedules, forward-process and sampling primitives
against the `ddg_tpu` jnp functions on the same inputs (float32, 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops import forward_process as jfp
from ddg_tpu.ops import noise_schedules as jns
from ddg_tpu.ops import sampling as jS
from ddg_tpu_torch.ops import forward_process as tfp
from ddg_tpu_torch.ops import noise_schedules as tns
from ddg_tpu_torch.ops import sampling as tS

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
SCHEDULES = ['loglinear', 'linear', 'geometric', 'cosine', 'cosinesqr']


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               **(tol or TOL))


@pytest.mark.parametrize('name', SCHEDULES)
def test_schedule_matches_jnp(name):
    kw = {'sigma_min': 1e-3, 'sigma_max': 1.0} if name == 'geometric' else {}
    js, ts = jns.get_noise(name, **kw), tns.get_noise(name, **kw)
    t = np.random.RandomState(0).uniform(0.01, 0.99, 64).astype(np.float32)
    close(ts.total_noise(torch.from_numpy(t)), js.total_noise(jnp.asarray(t)))
    close(ts.rate_noise(torch.from_numpy(t)), js.rate_noise(jnp.asarray(t)))
    sig = np.array(js.total_noise(jnp.asarray(t)))
    close(ts.inverse_total_noise(torch.from_numpy(sig)),
          js.inverse_total_noise(jnp.asarray(sig)))
    assert ts.sigma_min == pytest.approx(js.sigma_min)
    assert ts.sigma_max == pytest.approx(js.sigma_max)
    if hasattr(js, 'importance_sampling_transformation'):
        close(ts.importance_sampling_transformation(torch.from_numpy(t)),
              js.importance_sampling_transformation(jnp.asarray(t)))


def test_get_noise_rejects_unknown():
    with pytest.raises(NotImplementedError):
        tns.get_noise('nope')


def _case(seed=0, B=3, L=5, V=11, mask=10):
    r = np.random.RandomState(seed)
    logits = (r.randn(B, L, V) * 3).astype(np.float32)
    xt = np.where(r.rand(B, L) < 0.5, mask,
                  r.randint(0, V - 1, (B, L))).astype(np.int32)
    mct = r.uniform(0.4, 0.9, (B, 1, 1)).astype(np.float32)
    mcs = (mct * 0.6).astype(np.float32)
    return logits, xt, mct, mcs, mask


def test_discretize_t_and_prior():
    t = np.random.RandomState(1).uniform(0, 1, 32).astype(np.float32)
    close(tfp.discretize_t(torch.from_numpy(t), 100),
          jfp.discretize_t(jnp.asarray(t), 100))
    prior = tfp.sample_prior((2, 3), diffusion='absorbing_state',
                             mask_index=7, vocab_size=8, device='cpu')
    np.testing.assert_array_equal(
        prior.numpy(), np.asarray(jfp.sample_prior(
            jax.random.PRNGKey(0), (2, 3), diffusion='absorbing_state',
            mask_index=7, vocab_size=8)))
    assert prior.dtype == torch.int32


def test_subs_and_posteriors():
    logits, xt, mct, mcs, mask = _case()
    lt, xtt = torch.from_numpy(logits), torch.from_numpy(xt)
    sub_t = tfp.subs_parameterization(lt, xtt, mask_index=mask)
    sub_j = jfp.subs_parameterization(jnp.asarray(logits), jnp.asarray(xt),
                                      mask_index=mask)
    close(sub_t, sub_j)
    x_theta = np.exp(np.asarray(sub_j))
    close(tfp.absorbing_posterior(torch.from_numpy(x_theta),
                                  torch.from_numpy(mct),
                                  torch.from_numpy(mcs), mask_index=mask),
          jfp.absorbing_posterior(jnp.asarray(x_theta), jnp.asarray(mct),
                                  jnp.asarray(mcs), mask_index=mask))
    close(tfp.absorbing_posterior_log(sub_t, torch.from_numpy(mct),
                                      torch.from_numpy(mcs),
                                      mask_index=mask),
          jfp.absorbing_posterior_log(sub_j, jnp.asarray(mct),
                                      jnp.asarray(mcs), mask_index=mask))
    close(tfp.uniform_posterior(torch.from_numpy(x_theta), xtt,
                                1 - torch.from_numpy(mcs),
                                1 - torch.from_numpy(mct), vocab_size=11),
          jfp.uniform_posterior(jnp.asarray(x_theta), jnp.asarray(xt),
                                1 - jnp.asarray(mcs), 1 - jnp.asarray(mct),
                                vocab_size=11))


def test_copy_flags():
    logits, xt, _, _, mask = _case(seed=2)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    xtt = torch.from_numpy(xt)
    close(tfp.apply_copy_flag_probs(torch.from_numpy(probs), xtt,
                                    mask_index=mask),
          jfp.apply_copy_flag_probs(jnp.asarray(probs), jnp.asarray(xt),
                                    mask_index=mask))
    close(tfp.apply_copy_flag_log(torch.from_numpy(logits), xtt,
                                  mask_index=mask),
          jfp.apply_copy_flag_log(jnp.asarray(logits), jnp.asarray(xt),
                                  mask_index=mask))
    xs = np.random.RandomState(3).randint(0, 10, xt.shape).astype(np.int32)
    np.testing.assert_array_equal(
        tfp.apply_copy_flag_tokens(torch.from_numpy(xs), xtt,
                                   mask_index=mask).numpy(),
        np.asarray(jfp.apply_copy_flag_tokens(
            jnp.asarray(xs), jnp.asarray(xt), mask_index=mask)))


@pytest.mark.parametrize('low_conf', [False, True])
def test_sample_categorical_with_the_same_uniforms(low_conf):
    """Given JAX's own uniforms, the port picks JAX's tokens."""
    logits, _, _, _, _ = _case(seed=4, V=23)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, probs.shape, dtype=jnp.float32))
    want = jS.sample_categorical(key, jnp.asarray(probs),
                                 low_confidence_sampling=low_conf)
    got = tS.sample_categorical(torch.from_numpy(probs),
                                u=torch.from_numpy(u),
                                low_confidence_sampling=low_conf)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = np.random.RandomState(6).gumbel(size=probs.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tS.sample_token(torch.from_numpy(np.log(probs)), torch.from_numpy(g),
                        low_confidence_sampling=low_conf).numpy(),
        np.asarray(jS.sample_token(jnp.log(jnp.asarray(probs)),
                                   jnp.asarray(g),
                                   low_confidence_sampling=low_conf)))
