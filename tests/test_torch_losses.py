"""The port's losses (`ddg_tpu_torch.ops.losses`) against
`ddg_tpu/ops/losses.py` on the same seeded inputs, with label smoothing 0
and 0.1: float32 to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops import losses as jl
from ddg_tpu_torch.ops import losses as tl

torch.set_num_threads(1)
B, L, V, T = 3, 8, 11, 10
MASK = V - 1
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def inputs():
    r = np.random.RandomState(0)
    logits = r.randn(B, L, V).astype(np.float32) * 2
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    x0 = r.randint(0, V - 1, (B, L)).astype(np.int32)
    xt = np.where(r.rand(B, L) < 0.5, MASK, x0).astype(np.int32)
    xt_u = np.where(r.rand(B, L) < 0.5, r.randint(0, V, (B, L)),
                    x0).astype(np.int32)
    t = r.uniform(0.05, 0.95, B).astype(np.float32)
    sigma = -np.log1p(-t).astype(np.float32)
    dsigma = (1 / (1 - t)).astype(np.float32)
    mask = (r.rand(B, L) < 0.8).astype(np.float32)
    return dict(lp=lp.astype(np.float32), x0=x0, xt=xt, xt_u=xt_u, t=t,
                sigma=sigma, dsigma=dsigma, mask=mask)


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


CASES = {
    'smooth_one_hot': lambda m, d, ls: m.smooth_one_hot(d['x0'], V, ls),
    'nll_loss': lambda m, d, ls: m.nll_loss(d['lp'], d['x0'], ls),
    'd3pm_absorbing_loss': lambda m, d, ls: m.d3pm_absorbing_loss(
        d['lp'], d['xt'], d['x0'], d['t'], T=T, mask_index=MASK,
        label_smoothing=ls),
    'd3pm_uniform_loss': lambda m, d, ls: m.d3pm_uniform_loss(
        d['lp'], d['xt_u'], d['x0'], d['t'], T=T, vocab_size=V,
        label_smoothing=ls),
    'subs_continuous_weight': lambda m, d, ls: m.subs_continuous_weight(
        d['sigma'], d['dsigma']),
    'subs_continuous_loss': lambda m, d, ls: m.subs_continuous_loss(
        d['lp'], d['x0'], d['sigma'], d['dsigma'], label_smoothing=ls),
    'uniform_continuous_loss': lambda m, d, ls: m.uniform_continuous_loss(
        d['lp'], d['xt_u'], d['x0'], d['t'], vocab_size=V,
        label_smoothing=ls),
    'masked_mean_nll': lambda m, d, ls: m.masked_mean_nll(
        m.nll_loss(d['lp'], d['x0'], ls), d['mask']),
}


@pytest.mark.parametrize('ls', [0.0, 0.1])
@pytest.mark.parametrize('name', list(CASES))
def test_loss_matches_jax(inputs, name, ls):
    pairs = {k: both(v) for k, v in inputs.items()}
    want = CASES[name](jl, {k: v[0] for k, v in pairs.items()}, ls)
    got = CASES[name](tl, {k: v[1] for k, v in pairs.items()}, ls)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('ls', [0.0, 0.1])
def test_log_p_smoothed_is_the_one_hot_sum(inputs, ls):
    """The gather form equals the JAX package's (log p * one-hot) sum."""
    lp, x0 = (torch.from_numpy(inputs[k]) for k in ('lp', 'x0'))
    want = (lp * tl.smooth_one_hot(x0, V, ls)).sum(-1)
    torch.testing.assert_close(tl.log_p_smoothed(lp, x0, ls), want,
                               rtol=1e-6, atol=1e-6)
