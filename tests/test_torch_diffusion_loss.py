"""The port's `diffusion.loss_fn` against `ddg_tpu.diffusion.loss_fn` on
the same batch, model and draw: float32 to 1e-5.

The model is a tiny table model written out in both frameworks (logits =
E[x] + sigma b + C[cond]), so that the comparison is of the loss logic
alone. The JAX draw of (t, x_t) is replayed from its own key splits
(`diffusion.py:172-196,291`) and handed to the port's loss in place of its
own draw (`sample_corruption`, swapped for the test), so the port's loss
given (t, x_t) runs on JAX's draw; the two losses agreeing is the check on
the replay too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu import diffusion as jd
from ddg_tpu.ops import forward_process as jfp
from ddg_tpu.ops import noise_schedules as jns
from ddg_tpu_torch import diffusion as td
from ddg_tpu_torch.ops import noise_schedules as tns

torch.set_num_threads(1)
B, L, V, NC = 4, 8, 12, 2
MASK = V - 1
TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    'mdlm': dict(),
    'mdlm_label_smoothing': dict(label_smoothing=0.1),
    'mdlm_change_of_variables': dict(change_of_variables=True),
    'mdlm_importance_sampling': dict(importance_sampling=True),
    'd3pm_absorbing': dict(parameterization='d3pm', T=10),
    'subs_discrete': dict(T=10),
    'd3pm_uniform': dict(diffusion='uniform', parameterization='d3pm',
                         T=10),
    'udlm': dict(diffusion='uniform', parameterization='d3pm',
                 time_conditioning=True),
    'udlm_zero_recon': dict(diffusion='uniform', parameterization='d3pm',
                            time_conditioning=True, zero_recon_loss=True),
    'ar': dict(parameterization='ar'),
    'simple_ce': dict(use_simple_ce_loss=True),
    'pad_tokens': dict(compute_loss_on_pad_tokens=True),
    'warmup': dict(noise_schedule_warmup=True, max_steps=100),
    'uniform_warmup': dict(noise_schedule_warmup=True,
                           noise_schedule_uniform_warmup=True,
                           max_steps=100),
    'cond_dropout_0': dict(num_classes=NC, cond_dropout=0.0),
    'cond_dropout_1': dict(num_classes=NC, cond_dropout=1.0),
}


@pytest.fixture(scope='module')
def data():
    r = np.random.RandomState(0)
    params = dict(E=r.randn(V, V).astype(np.float32),
                  b=r.randn(V).astype(np.float32),
                  C=r.randn(NC + 1, V).astype(np.float32))
    x0 = r.randint(0, V - 1, (B, L)).astype(np.int32)
    targets = r.randint(0, V - 1, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    mask[:, -2:] = 0.0
    cond = np.array([0, 1, 1, 0], np.int32)
    return params, x0, targets, mask, cond


def jax_apply(params, x, sigma, cond=None, x_emb=None, *, train=False,
              rng=None):
    out = params['E'][x]
    if sigma is not None:
        out = out + sigma[:, None, None] * params['b']
    if cond is not None:
        out = out + params['C'][cond][:, None, :]
    return out


def torch_apply(params, x, sigma, cond=None, x_emb=None, *, train=False,
                rng=None):
    out = params['E'][x.long()]
    if sigma is not None:
        out = out + sigma[:, None, None] * params['b']
    if cond is not None:
        out = out + params['C'][cond.long()][:, None, :]
    return out


def specs(kw):
    base = dict(diffusion='absorbing_state', parameterization='subs',
                vocab_size=V, mask_index=MASK)
    base.update(kw)
    return (jd.DiffusionSpec(noise=jns.LogLinearNoise(), **base),
            td.DiffusionSpec(noise=tns.LogLinearNoise(), **base))


def replay_corruption(spec, x0, rng, step):
    """JAX's (t, x_t): loss_fn's split, then forward_pass_diffusion's."""
    _, loss_rng, _ = jax.random.split(rng, 3)
    t_rng, q_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jfp.sample_t(t_rng, x0.shape[0], sampling_eps=spec.sampling_eps,
                     antithetic=spec.antithetic_sampling, noise=spec.noise,
                     importance_sampling=spec.importance_sampling)
    if spec.T > 0:
        t = jfp.discretize_t(t, spec.T)
    if spec.change_of_variables:
        import math
        f_t = math.log1p(-math.exp(-spec.noise.sigma_max))
        f_0 = math.log1p(-math.exp(-spec.noise.sigma_min))
        move_chance = jnp.exp(f_0 + t * (f_t - f_0))[:, None]
    else:
        move_chance = 1 - jnp.exp(-spec.noise(t)[0][:, None])
    if spec.noise_schedule_warmup and step is not None:
        move_chance = jd._move_chance_warmup(spec, move_chance, step)
    xt = jfp.q_xt(q_rng, x0, move_chance, diffusion=spec.diffusion,
                  mask_index=spec.mask_index, vocab_size=spec.vocab_size)
    return np.asarray(t), np.asarray(xt)


def use_draw(monkeypatch, t, xt):
    """Make the port's `loss_fn` take (t, xt) as its draw."""
    monkeypatch.setattr(td, 'sample_corruption',
                        lambda *a, **k: (torch.tensor(t), torch.tensor(xt)))


@pytest.mark.parametrize('case', list(CASES))
def test_loss_fn_matches_jax(data, case, monkeypatch):
    params, x0, targets, mask, cond = data
    js, ts = specs(CASES[case])
    train = True
    step = 3 if js.noise_schedule_warmup else None
    use_cond = js.num_classes is not None
    jc = jnp.asarray(cond) if use_cond else None
    tc = torch.from_numpy(cond) if use_cond else None
    rng = jax.random.PRNGKey(7)
    if js.parameterization == 'ar':
        jx0 = (jnp.asarray(x0), jnp.asarray(targets))
        tx0 = (torch.from_numpy(x0), torch.from_numpy(targets))
    else:
        jx0, tx0 = jnp.asarray(x0), torch.from_numpy(x0)
        t, xt = replay_corruption(js, jx0, rng, step)
        if js.diffusion == 'absorbing_state' and not js.noise_schedule_warmup:
            assert (xt == MASK).any() and (xt != MASK).any()
        use_draw(monkeypatch, t, xt)
    want = jd.loss_fn(js, jax_apply, {k: jnp.asarray(v)
                                      for k, v in params.items()},
                      jx0, jnp.asarray(mask), jc, rng, train=train,
                      step=step)
    got = td.loss_fn(ts, torch_apply, {k: torch.from_numpy(v)
                                       for k, v in params.items()},
                     tx0, torch.from_numpy(mask), tc,
                     torch.Generator().manual_seed(0), train=train,
                     step=step)
    for name in ('loss', 'nlls', 'token_mask', 'recon_loss',
                 'diffusion_loss', 'unroll_loss'):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)


def test_eval_loss_matches_jax_without_smoothing(data, monkeypatch):
    """train=False: label smoothing falls back to 0 and cond dropout,
    simple CE and the pad-token mean are off."""
    params, x0, _, mask, cond = data
    kw = dict(label_smoothing=0.1, use_simple_ce_loss=True,
              compute_loss_on_pad_tokens=True, num_classes=NC,
              cond_dropout=1.0)
    js, ts = specs(kw)
    rng = jax.random.PRNGKey(3)
    t, xt = replay_corruption(js, jnp.asarray(x0), rng, None)
    use_draw(monkeypatch, t, xt)
    want = jd.loss_fn(js, jax_apply, {k: jnp.asarray(v)
                                      for k, v in params.items()},
                      jnp.asarray(x0), jnp.asarray(mask), jnp.asarray(cond),
                      rng, train=False)
    got = td.loss_fn(ts, torch_apply, {k: torch.from_numpy(v)
                                       for k, v in params.items()},
                     torch.from_numpy(x0), torch.from_numpy(mask),
                     torch.from_numpy(cond), torch.Generator(), train=False)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), **TOL)
    np.testing.assert_allclose(got.nlls.numpy(), np.asarray(want.nlls), **TOL)


def test_k_step_ce_one_step_matches_jax(data):
    """With K = 1 the resampled tokens are never used, so the unrolled CE
    is exactly the one-forward NLL in both."""
    params, x0, _, _, _ = data
    js, ts = specs({})
    r = np.random.RandomState(4)
    xt = np.where(r.rand(B, L) < 0.5, MASK, x0).astype(np.int32)
    sigma = r.uniform(0.1, 2.0, (B, 1)).astype(np.float32)
    want = jd._k_step_ce(js, jax_apply, {k: jnp.asarray(v)
                                         for k, v in params.items()},
                         jnp.asarray(xt), jnp.asarray(x0), jnp.asarray(sigma),
                         1, None, 0.0, train=False,
                         rng=jax.random.PRNGKey(0))
    got = td._k_step_ce(ts, torch_apply, {k: torch.from_numpy(v)
                                          for k, v in params.items()},
                        torch.from_numpy(xt), torch.from_numpy(x0),
                        torch.from_numpy(sigma), 1, None, 0.0, train=False,
                        rng=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sample_corruption_draws_within_the_schedule():
    """The port's own draw: antithetic t covers (eps, 1) in B strata, x_t
    keeps or masks each token, and one generator seed reproduces it."""
    _, ts = specs({})
    x0 = torch.randint(0, V - 1, (64, L), generator=torch.Generator()
                       .manual_seed(1))
    t, xt = td.sample_corruption(ts, x0, torch.Generator().manual_seed(2))
    t2, xt2 = td.sample_corruption(ts, x0, torch.Generator().manual_seed(2))
    assert torch.equal(t, t2) and torch.equal(xt, xt2)
    eps_t = (t - ts.sampling_eps) / (1 - ts.sampling_eps)
    strata = torch.sort(torch.floor(eps_t * 64)).values
    assert torch.equal(strata, torch.arange(64, dtype=t.dtype))
    assert bool(((xt == x0) | (xt == MASK)).all())
    spec = dataclasses.replace(ts, T=10)
    t, _ = td.sample_corruption(spec, x0, torch.Generator().manual_seed(3))
    assert torch.allclose(t * 10, torch.round(t * 10), atol=1e-4)
