"""The port's classifier-based guidance (D-CBG exact and first-order, NOS)
against `ddg_tpu`'s on the same weights and inputs, float32.

Weights: a tiny JAX DIT denoiser and DITClassifier (and a head-only NOS
classifier over the denoiser's hidden states), initialised from seeds and
perturbed by seeded noise, carried into the port by the converters. The
port runs with `fused_adaln` and `fused_rope_attn` (their plain versions
on CPU tensors).

(a) `classifier_log_probs_edits` (B, L, V), with a padded last chunk and
    without: 1e-4 abs.
(b) One `_cbg_step`, exact and first-order, absorbing and uniform: the
    guided probabilities to 1e-5 abs, and the tokens of one shared Gumbel
    draw identical wherever the top-two perturbed scores differ by more
    than 1e-4.
(c) One `_nos_step` with two Adagrad steps: the hidden-state delta to 1e-4
    of its largest magnitude, the guided probabilities to 1e-5, tokens as
    in (b).
(d) The whole `diffusion_sample` loop at T=3 with argmax sampling for
    cbg exact, cbg first-order and nos: identical tokens.
(e) Port only: the CBG NFE cache gives the tokens of the uncached loop and
    runs the classifier fewer times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu import samplers as JS
from ddg_tpu.diffusion import DiffusionSpec as JSpec
from ddg_tpu.models import dit as jdit
from ddg_tpu.models import make_classifier_apply as j_clf_apply
from ddg_tpu.models import make_model_apply as j_model_apply
from ddg_tpu.ops.noise_schedules import LogLinearNoise as JLogLinear
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.convert import (dit_classifier_state_dict_from_jax,
                                   dit_state_dict_from_jax)
from ddg_tpu_torch.diffusion import DiffusionSpec as TSpec
from ddg_tpu_torch.models import (DIT, DITClassifier, DITConfig,
                                  make_classifier_apply, make_model_apply)
from ddg_tpu_torch.ops import sampling as tsampling
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise as TLogLinear

torch.set_num_threads(1)
HID, COND, NB, NH, V, NC = 32, 16, 1, 2, 12, 2
B, L, CHUNK = 2, 8, 16
MASK = V - 1
MARGIN = 1e-4


def jax_cfg():
    return jdit.DITConfig(hidden_size=HID, cond_dim=COND, length=L,
                          n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                          compute_dtype=jnp.float32)


def torch_cfg():
    return DITConfig(hidden_size=HID, cond_dim=COND, length=L, n_blocks=NB,
                     n_heads=NH, dropout=0.0, vocab_size=V,
                     compute_dtype=torch.float32, fused_adaln=True,
                     fused_rope_attn=True)


def perturbed(params, seed, scale=0.1):
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p)
                              + scale * r.randn(*p.shape).astype(np.float32)),
        params)


def specs(diffusion):
    kw = dict(diffusion=diffusion, vocab_size=V, mask_index=MASK,
              parameterization=('subs' if diffusion == 'absorbing_state'
                                else 'd3pm'))
    return (JSpec(noise=JLogLinear(), **kw), TSpec(noise=TLogLinear(), **kw))


@pytest.fixture(scope='module')
def models():
    """(JAX params, JAX apply, port apply) of the denoiser, the classifier
    and the head-only NOS classifier."""
    x = jnp.zeros((1, L), jnp.int32)
    den = perturbed(jdit.DIT(jax_cfg()).init(
        jax.random.PRNGKey(0), x, jnp.ones((1,)))['params'], 1)
    clf = perturbed(jdit.DITClassifier(jax_cfg()).init(
        jax.random.PRNGKey(2), x, jnp.ones((1,)))['params'], 3)
    head = perturbed(jdit.DITClassifier(jax_cfg()).init(
        jax.random.PRNGKey(4), x, jnp.ones((1,)),
        jnp.zeros((1, L, HID)))['params'], 5, scale=1.0)
    m = DIT(torch_cfg())
    m.load_state_dict(dit_state_dict_from_jax(den, n_blocks=NB), strict=True)
    c = DITClassifier(torch_cfg())
    c.load_state_dict(dit_classifier_state_dict_from_jax(clf, n_blocks=NB),
                      strict=True)
    h = DITClassifier(torch_cfg(), head_only=True)
    h.load_state_dict(dit_classifier_state_dict_from_jax(head, n_blocks=0),
                      strict=True)
    return dict(
        den=(den, j_model_apply(jdit.DIT(jax_cfg())),
             make_model_apply(m.eval())),
        clf=(clf, j_clf_apply(jdit.DITClassifier(jax_cfg())),
             make_classifier_apply(c.eval())),
        head=(head, j_clf_apply(jdit.DITClassifier(jax_cfg())),
              make_classifier_apply(h.eval())))


def step_inputs(diffusion, seed=0):
    r = np.random.RandomState(seed)
    if diffusion == 'absorbing_state':
        x0 = r.randint(0, MASK, (B, L))
        xt = np.where(r.rand(B, L) < 0.6, MASK, x0)
    else:
        xt = r.randint(0, V, (B, L))
    sigma = r.uniform(0.3, 2.0, B).astype(np.float32)
    mct = r.uniform(0.4, 0.9, B).astype(np.float32)
    mcs = (0.6 * mct).astype(np.float32)
    u = r.rand(B, L, V).astype(np.float32)
    return xt.astype(np.int32), sigma, mct, mcs, u


@pytest.mark.parametrize('chunk', [CHUNK, 36])
def test_edit_log_probs_match_jax(models, chunk):
    """L * V = 96 edits: 6 whole chunks of 16, or 3 of 36 with 12 padded."""
    jp, japply, tapply = models['clf']
    xt, sigma, *_ = step_inputs('absorbing_state')
    want = JS.classifier_log_probs_edits(
        japply, jp, jnp.asarray(xt), jnp.asarray(sigma), 1, vocab_size=V,
        chunk=chunk)
    with torch.no_grad():
        got = TS.classifier_log_probs_edits(
            tapply, tapply.params, torch.from_numpy(xt),
            torch.from_numpy(sigma), 1, vocab_size=V, chunk=chunk)
    assert got.shape == (B, L, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # An edit to the token already there scores x_t itself.
    same = got.gather(-1, torch.from_numpy(xt).long()[..., None])[..., 0]
    np.testing.assert_allclose(same.numpy(), same[:, :1].expand(B, L),
                               atol=1e-5)


def capture_probs(monkeypatch):
    """Record each side's guided probabilities in place of sampling."""
    seen = {}

    def jax_sample(spec, sampler, key, q_xs, xt):
        seen['jax'] = np.asarray(q_xs)
        return xt

    def torch_sample(spec, sampler, generator, q_xs, xt):
        seen['torch'] = q_xs.detach().clone()
        return xt
    monkeypatch.setattr(JS, '_sample_and_copy', jax_sample)
    monkeypatch.setattr(TS, '_sample_and_copy', torch_sample)
    return seen


def hold_probs_and_tokens(seen, u):
    """The guided probabilities to 1e-5, then the tokens of both under the
    uniforms `u` (Gumbel-max in the reference's form) where decided."""
    got, want = seen['torch'], seen['jax']
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ut = torch.from_numpy(u)
    tok_t = tsampling.sample_categorical(got, u=ut)
    tok_j = tsampling.sample_categorical(torch.from_numpy(want), u=ut)
    scores = got / (1e-10 - torch.log(ut + 1e-10))
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > MARGIN
    assert decided.float().mean() > 0.9
    np.testing.assert_array_equal(tok_t[decided].numpy(),
                                  tok_j[decided].numpy())


def step_args(diffusion, seed=0):
    xt, sigma, mct, mcs, u = step_inputs(diffusion, seed)
    j = (jnp.asarray(xt), jnp.asarray(sigma),
         jnp.asarray(mct)[:, None, None], jnp.asarray(mcs)[:, None, None])
    t = (torch.from_numpy(xt), torch.from_numpy(sigma),
         torch.from_numpy(mct)[:, None, None],
         torch.from_numpy(mcs)[:, None, None])
    return j, t, u


@pytest.mark.parametrize('diffusion', ['absorbing_state', 'uniform'])
@pytest.mark.parametrize('approx', [False, True])
def test_cbg_step_matches_jax(models, monkeypatch, diffusion, approx):
    js, ts = specs(diffusion)
    jd, jda, tda = models['den']
    jc, jca, tca = models['clf']
    (jxt, jsig, jmct, jmcs), (txt, tsig, tmct, tmcs), u = step_args(
        diffusion)
    seen = capture_probs(monkeypatch)
    kw = dict(method='cbg', gamma=2.0, condition=1, use_approx=approx,
              cbg_chunk=CHUNK)
    JS._cbg_step(js, JS.SamplerSpec(use_cache=False), JS.GuidanceSpec(**kw),
                 jda, jd, jca, jc, jax.random.PRNGKey(0), jxt, jsig, jmct,
                 jmcs, None, None)
    with torch.no_grad():
        TS._cbg_step(ts, TS.SamplerSpec(use_cache=False),
                     TS.GuidanceSpec(**kw), tda, tda.params, tca,
                     tca.params, torch.Generator(), txt, tsig, tmct, tmcs,
                     None, None)
    hold_probs_and_tokens(seen, u)


@pytest.mark.parametrize('diffusion', ['absorbing_state', 'uniform'])
def test_nos_step_matches_jax(models, monkeypatch, diffusion):
    js, ts = specs(diffusion)
    jd, jda, tda = models['den']
    jh, jha, tha = models['head']
    (jxt, jsig, jmct, jmcs), (txt, tsig, tmct, tmcs), u = step_args(
        diffusion, seed=1)
    seen = capture_probs(monkeypatch)
    embs = {'jax': [], 'torch': []}

    def recording(apply, side):
        def wrapped(*args, **kwargs):
            out = apply(*args, **kwargs)
            x_emb = args[4] if len(args) > 4 else kwargs.get('x_emb')
            if kwargs.get('return_hidden_states'):
                embs[side].append(out[1])
            elif x_emb is not None and not isinstance(x_emb,
                                                      jax.core.Tracer):
                embs[side].append(x_emb)
            return out
        wrapped.params = getattr(apply, 'params', None)
        return wrapped

    kw = dict(method='nos', condition=1, num_nos_steps=2, nos_step_size=0.1,
              nos_stability_coef=0.01)
    JS._nos_step(js, JS.SamplerSpec(use_cache=False), JS.GuidanceSpec(**kw),
                 recording(jda, 'jax'), jd, jha, jh, jax.random.PRNGKey(0),
                 jxt, jsig, jmct, jmcs)
    with torch.no_grad():
        TS._nos_step(ts, TS.SamplerSpec(use_cache=False),
                     TS.GuidanceSpec(**kw), recording(tda, 'torch'),
                     tda.params, tha, tha.params, torch.Generator(), txt,
                     tsig, tmct, tmcs)
    # The trunk's hidden state first, hidden + delta last.
    jdelta = np.asarray(embs['jax'][-1]) - np.asarray(embs['jax'][0])
    tdelta = (embs['torch'][-1] - embs['torch'][0]).numpy()
    scale = np.abs(jdelta).max()
    assert scale > 1e-3
    np.testing.assert_allclose(tdelta, jdelta, rtol=0, atol=1e-4 * scale)
    hold_probs_and_tokens(seen, u)


GUIDES = {
    'cbg': dict(method='cbg', gamma=2.0, condition=1, cbg_chunk=CHUNK),
    'cbg_approx': dict(method='cbg', gamma=2.0, condition=1,
                       use_approx=True),
    'nos': dict(method='nos', condition=1, num_nos_steps=1),
}


@pytest.mark.parametrize('method', list(GUIDES))
def test_sampling_loop_matches_jax(models, method):
    js, ts = specs('absorbing_state')
    jd, jda, tda = models['den']
    jc, jca, tca = models['head' if method == 'nos' else 'clf']
    steps = 3
    want = JS.diffusion_sample(
        js, JS.SamplerSpec(steps=steps, use_cache=False,
                           argmax_sampling=True),
        jda, jd, jax.random.PRNGKey(0), batch_size=B, length=L,
        guidance=JS.GuidanceSpec(**GUIDES[method]), classifier_apply=jca,
        classifier_params=jc)
    got = TS.diffusion_sample(
        ts, TS.SamplerSpec(steps=steps, use_cache=False,
                           argmax_sampling=True),
        tda, tda.params, torch.Generator().manual_seed(0), batch_size=B,
        length=L, guidance=TS.GuidanceSpec(**GUIDES[method]),
        classifier_apply=tca, classifier_params=tca.params)
    want = np.asarray(want)
    assert (want != MASK).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_cbg_cache_same_tokens_fewer_computes(models):
    """With the classifier's time conditioning held constant (its sigma
    map's output weights zeroed, as the denoiser's sigma is zeroed by the
    spec), a step that changed nothing computes the same values, so the
    cached loop gives the uncached loop's tokens with fewer classifier
    forwards."""
    _, ts = specs('absorbing_state')
    _, _, tda = models['den']
    _, _, tca = models['clf']
    params = dict(tca.params)
    params['sigma_map.mlp.2.weight'] = torch.zeros_like(
        params['sigma_map.mlp.2.weight'])
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return tca(*args, **kwargs)

    out = {}
    for use_cache in (False, True):
        calls.clear()
        out[use_cache] = TS.diffusion_sample(
            ts, TS.SamplerSpec(steps=12, use_cache=use_cache,
                               argmax_sampling=True),
            tda, tda.params, torch.Generator().manual_seed(0),
            batch_size=B, length=L,
            guidance=TS.GuidanceSpec(**GUIDES['cbg']),
            classifier_apply=counting, classifier_params=params)
        out[use_cache, 'calls'] = len(calls)
    np.testing.assert_array_equal(out[True].numpy(), out[False].numpy())
    assert out[False, 'calls'] == 12 * (L * V // CHUNK)
    assert out[True, 'calls'] < out[False, 'calls']


def test_guidance_needs_a_classifier(models):
    """cbg and nos without a classifier, or in the first-hitting sampler,
    are refused; FUDGE and PPLM are not ported (ROADMAP A.5)."""
    _, ts = specs('absorbing_state')
    _, _, tda = models['den']
    _, _, tca = models['clf']
    for method in ('cbg', 'nos'):
        with pytest.raises(ValueError):
            TS.diffusion_sample(
                ts, TS.SamplerSpec(steps=2), tda, tda.params,
                torch.Generator(), batch_size=B, length=L,
                guidance=TS.GuidanceSpec(method=method))
    for method in ('fudge', 'pplm'):
        with pytest.raises(NotImplementedError):
            TS.diffusion_sample(
                ts, TS.SamplerSpec(steps=2), tda, tda.params,
                torch.Generator(), batch_size=B, length=L,
                guidance=TS.GuidanceSpec(method=method),
                classifier_apply=tca, classifier_params=tca.params)
    with pytest.raises(ValueError):
        TS.first_hitting_sample(
            ts, TS.SamplerSpec(first_hitting=True), tda, tda.params,
            torch.Generator(), batch_size=B, length=L,
            guidance=TS.GuidanceSpec(method='cbg'))


def test_guidance_spec_fields_match_jax():
    import dataclasses
    assert ([f.name for f in dataclasses.fields(TS.GuidanceSpec)]
            == [f.name for f in dataclasses.fields(JS.GuidanceSpec)])
    assert TS.GuidanceSpec('cbg') == TS.GuidanceSpec(
        **dataclasses.asdict(JS.GuidanceSpec('cbg')))
