"""The port's DiT classifier and classifier runtime against `ddg_tpu`'s on
the same weights and inputs, float32.

Weights: a JAX DITClassifier initialised from a seed, every parameter then
perturbed by seeded noise (the adaLN projections start at zero), carried
into the port by `convert.dit_classifier_state_dict_from_jax`. The port
runs its trunk with `fused_adaln` and `fused_rope_attn`, whose plain
versions serve CPU tensors; the JAX trunk is its unfused chain.

(a) Logits for indices, one-hots and soft inputs, and `x_emb` (on the full
    classifier and on a head-only one), for every pooling: 1e-5 abs.
(b) `classifier_loss_fn` on JAX's (t, x_t) draw, replayed from its key
    splits and handed to the port in place of its own
    (`sample_corruption`): noisy-input CE, time-dependent label smoothing,
    FUDGE per-position CE and the clean-input eval mode. Loss to 1e-5,
    every gradient to 1e-4 of its largest magnitude.
(c) One `make_classifier_train_step` update (clip, AdamW, on JAX's draw)
    with and without `frozen_keys`: the parameters after it to 1% of the
    learning rate (a first Adam step is lr g / (|g| + eps), so where |g| is
    near eps a float32 difference in g moves it by a share of lr).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu import classifier as jc
from ddg_tpu.models import dit as jdit
from ddg_tpu.models import make_classifier_apply as j_make_apply
from ddg_tpu.ops import forward_process as jfp
from ddg_tpu.ops import noise_schedules as jns
from ddg_tpu.runtime import averaging as javg
from ddg_tpu.runtime import optim as joptim
from ddg_tpu.runtime import train_state as jts
from ddg_tpu_torch import classifier as tc
from ddg_tpu_torch.convert import dit_classifier_state_dict_from_jax
from ddg_tpu_torch.models import (DITClassifier, DITConfig,
                                  make_classifier_apply)
from ddg_tpu_torch.models.dit import POOLINGS
from ddg_tpu_torch.ops import noise_schedules as tns
from ddg_tpu_torch.runtime import averaging as tavg
from ddg_tpu_torch.runtime import optim as toptim
from ddg_tpu_torch.runtime import train_state as tts

torch.set_num_threads(1)
HID, COND, NB, NH, V, NC = 32, 16, 2, 2, 12, 2
B, L = 2, 8
MASK = V - 1
TOL = dict(rtol=0, atol=1e-5)


def jax_cfg(causal=False):
    return jdit.DITConfig(hidden_size=HID, cond_dim=COND, length=L,
                          n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                          compute_dtype=jnp.float32, causal=causal)


def torch_cfg(causal=False):
    return DITConfig(hidden_size=HID, cond_dim=COND, length=L, n_blocks=NB,
                     n_heads=NH, dropout=0.0, vocab_size=V,
                     compute_dtype=torch.float32, causal=causal,
                     fused_adaln=True, fused_rope_attn=True)


def perturbed(params, seed):
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * r.randn(*p.shape).astype(np.float32),
        params)


def port(params, pooling='mean', causal=False, head_only=False):
    m = DITClassifier(torch_cfg(causal), num_classes=NC, pooling=pooling,
                      head_only=head_only)
    m.load_state_dict(dit_classifier_state_dict_from_jax(
        params, n_blocks=0 if head_only else NB), strict=True)
    return make_classifier_apply(m.eval())


@pytest.fixture(scope='module')
def weights():
    """Perturbed JAX params of the classifier (and of a causal one for
    FUDGE), and the inputs."""
    x = jnp.zeros((1, L), jnp.int32)
    full = jdit.DITClassifier(jax_cfg()).init(
        jax.random.PRNGKey(0), x, jnp.ones((1,)))['params']
    causal = jdit.DITClassifier(jax_cfg(True), pooling='no_pooling').init(
        jax.random.PRNGKey(1), x, None)['params']
    head = jdit.DITClassifier(jax_cfg()).init(
        jax.random.PRNGKey(2), x, jnp.ones((1,)),
        jnp.zeros((1, L, HID)))['params']
    assert set(head) == {'output_layer'}
    r = np.random.RandomState(3)
    ids = r.randint(0, V, (B, L)).astype(np.int32)
    soft = r.dirichlet(np.ones(V), (B, L)).astype(np.float32)
    x_emb = r.randn(B, L, HID).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[1, -3:] = 0.0
    sigma = r.uniform(0.1, 2.0, B).astype(np.float32)
    return dict(full=perturbed(full, 4), causal=perturbed(causal, 5),
                head=perturbed(head, 6), ids=ids, soft=soft, x_emb=x_emb,
                mask=mask, sigma=sigma)


def jax_logits(params, pooling, x, sigma, x_emb, mask):
    apply = j_make_apply(jdit.DITClassifier(jax_cfg(), pooling=pooling))
    return np.asarray(apply(params, x, sigma, x_emb, mask))


@pytest.mark.parametrize('pooling', POOLINGS)
@pytest.mark.parametrize('inputs', ['indices', 'one_hot', 'soft', 'x_emb'])
def test_logits_match_jax(weights, pooling, inputs):
    w = weights
    ids = w['ids']
    x = {'indices': ids, 'one_hot': np.eye(V, dtype=np.float32)[ids],
         'soft': w['soft'], 'x_emb': ids}[inputs]
    x_emb = w['x_emb'] if inputs == 'x_emb' else None
    # sigma None conditions on sigma = 0 (the eval classifiers').
    sigma = None if inputs == 'soft' else w['sigma']
    want = jax_logits(w['full'], pooling, jnp.asarray(x),
                      None if sigma is None else jnp.asarray(sigma),
                      None if x_emb is None else jnp.asarray(x_emb),
                      jnp.asarray(w['mask']))
    t = torch.from_numpy
    apply = port(w['full'], pooling)
    got = apply(apply.params, t(x), None if sigma is None else t(sigma),
                None if x_emb is None else t(x_emb), t(w['mask']))
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_head_only_classifier_matches_jax(weights):
    """The JAX NOS classifier (params: `output_layer` alone) and the port's
    head-only module, which allocates no trunk."""
    w = weights
    want = jax_logits(w['head'], 'mean', jnp.asarray(w['ids']),
                      jnp.asarray(w['sigma']), jnp.asarray(w['x_emb']), None)
    apply = port(w['head'], head_only=True)
    assert set(apply.params) == {'output_layer.weight', 'output_layer.bias'}
    got = apply(apply.params, torch.from_numpy(w['ids']),
                torch.from_numpy(w['sigma']),
                x_emb=torch.from_numpy(w['x_emb']))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError):
        apply(apply.params, torch.from_numpy(w['ids']), None)


# ---------------------------------------------------------------------------
# The loss and the train step
# ---------------------------------------------------------------------------

LOSS_CASES = {
    'noisy_ce': dict(),
    'label_smoothing': dict(use_label_smoothing=True),
    'discrete_t_uniform': dict(diffusion='uniform', T=10),
    'eval_clean': dict(is_eval_classifier=True),
    'fudge': dict(parameterization='ar', is_fudge_classifier=True),
}


def specs(kw):
    base = dict(diffusion='absorbing_state', parameterization='subs',
                vocab_size=V, mask_index=MASK, num_classes=NC,
                time_conditioning=True)
    base.update(kw)
    return (jc.ClassifierSpec(noise=jns.LogLinearNoise(), **base),
            tc.ClassifierSpec(noise=tns.LogLinearNoise(), **base))


def batch(w):
    y = np.array([0, 1], np.int32)
    return {'input_ids': w['ids'], 'attention_mask': w['mask'], 'label': y}


def replay(spec, x0, rng):
    """JAX's (t, x_t) in `classifier_loss_fn` (`t_rng, q_rng, _ =
    split(rng, 3)`), or None where the loss draws none."""
    if spec.parameterization == 'ar' or spec.is_eval_classifier:
        return None
    t_rng, q_rng, _ = jax.random.split(rng, 3)
    t = jfp.sample_t(t_rng, x0.shape[0], sampling_eps=spec.sampling_eps,
                     antithetic=spec.antithetic_sampling, noise=spec.noise,
                     importance_sampling=spec.importance_sampling)
    if spec.T > 0:
        t = jfp.discretize_t(t, spec.T)
    sigma, _ = spec.noise(t)
    xt = jfp.q_xt(q_rng, x0, 1 - jnp.exp(-sigma[:, None]),
                  diffusion=spec.diffusion, mask_index=spec.mask_index,
                  vocab_size=spec.vocab_size)
    return np.array(t), np.array(xt)


def use_draw(monkeypatch, draw):
    if draw is not None:
        t, xt = draw
        monkeypatch.setattr(tc, 'sample_corruption', lambda *a, **k: (
            torch.from_numpy(t), torch.from_numpy(xt)))


def setup_case(w, case):
    js, ts = specs(LOSS_CASES[case])
    fudge = js.is_fudge_classifier
    pooling = 'no_pooling' if fudge else 'mean'
    params = w['causal'] if fudge else w['full']
    japply = j_make_apply(jdit.DITClassifier(jax_cfg(fudge),
                                             pooling=pooling))
    return js, ts, params, japply, port(params, pooling, causal=fudge)


@pytest.mark.parametrize('case', list(LOSS_CASES))
def test_loss_and_grads_match_jax(weights, case, monkeypatch):
    w = weights
    js, ts, params, japply, tapply = setup_case(w, case)
    b = batch(w)
    rng = jax.random.PRNGKey(7)
    draw = replay(js, jnp.asarray(b['input_ids']), rng)
    if draw is not None and js.diffusion == 'absorbing_state':
        assert (draw[1] == MASK).any() and (draw[1] != MASK).any()
    use_draw(monkeypatch, draw)

    @jax.jit
    def jloss(p):
        return jc.classifier_loss_fn(js, japply, p, jax.tree.map(
            jnp.asarray, b), rng)[0]

    want, jgrads = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray,
                                                          params))
    live = tapply.params
    got, _ = tc.classifier_loss_fn(
        ts, tapply, live, {k: torch.from_numpy(v) for k, v in b.items()},
        torch.Generator().manual_seed(0), train=True)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    grads = dict(zip(live, torch.autograd.grad(got, list(live.values()))))
    want_g = dit_classifier_state_dict_from_jax(
        jax.tree.map(np.asarray, jgrads), n_blocks=NB)
    assert set(want_g) == set(grads)
    for k, g in grads.items():
        ref = want_g[k].numpy()
        scale = max(np.abs(ref).max(), 1e-30)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=k)


def test_get_log_probs_match_jax(weights):
    w = weights
    js, ts = specs({})
    japply = j_make_apply(jdit.DITClassifier(jax_cfg()))
    tapply = port(w['full'])
    want = jc.get_log_probs(js, japply, w['full'], jnp.asarray(w['ids']),
                            jnp.asarray(w['sigma'])[:, None])
    got = tc.get_log_probs(ts, tapply, tapply.params,
                           torch.from_numpy(w['ids']),
                           torch.from_numpy(w['sigma'])[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.exp().sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize('frozen', [(), ('block_0', 'vocab_embed')])
def test_train_step_matches_jax(weights, frozen, monkeypatch):
    w = weights
    js, ts, params, japply, tapply = setup_case(w, 'label_smoothing')
    b = batch(w)
    kw = dict(lr=1e-3, num_warmup_steps=0, weight_decay=0.01, grad_clip=1.0)
    jopt, topt = joptim.OptimSpec(**kw), toptim.OptimSpec(**kw)
    javg_spec = javg.AveragingSpec.ema(0.9)
    tavg_spec = tavg.AveragingSpec.ema(0.9)
    key = jax.random.PRNGKey(11)
    jstate = jts.init_train_state(key, jax.tree.map(jnp.asarray, params),
                                  jopt, javg_spec)
    _, step_rng = jax.random.split(key)
    use_draw(monkeypatch, replay(js, jnp.asarray(b['input_ids']), step_rng))
    jstep = jax.jit(jc.make_classifier_train_step(js, japply, jopt,
                                                  javg_spec, frozen))
    jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, b))

    tstate = tts.init_train_state(torch.Generator().manual_seed(0),
                                  tapply.params, topt, tavg_spec)
    tstep = tc.make_classifier_train_step(ts, tapply, topt, tavg_spec,
                                          frozen)
    tstate, tmet = tstep(tstate, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    np.testing.assert_allclose(tmet['loss'].item(), float(jmet['loss']),
                               **TOL)
    assert tmet['accuracy'].item() == float(jmet['accuracy'])
    assert tmet['lr'].item() == pytest.approx(float(jmet['lr']))
    want = dit_classifier_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params), n_blocks=NB)
    before = dit_classifier_state_dict_from_jax(params, n_blocks=NB)
    moved = 0
    for k, v in tstate.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-2 * kw['lr'], err_msg=k)
        np.testing.assert_array_equal(tapply.params[k].detach().numpy(),
                                      v.numpy())
        if k.startswith(('blocks.0.', 'vocab_embed.')) and frozen:
            # Zero gradients: AdamW's decay alone moves them.
            np.testing.assert_allclose(
                v.numpy(), before[k].numpy() * (1 - 1e-3 * 0.01),
                rtol=1e-6, err_msg=k)
        else:
            moved += int(not np.allclose(v.numpy(), before[k].numpy()
                                         * (1 - 1e-3 * 0.01)))
    assert moved > 10


def test_frozen_key_must_name_parameters(weights):
    w = weights
    _, ts = specs({})
    tapply = port(w['full'])
    with pytest.raises(ValueError):
        tc.make_classifier_train_step(ts, tapply, toptim.OptimSpec(),
                                      tavg.AveragingSpec(kind='none'),
                                      ('block_9',))


def test_accuracy():
    logits = torch.tensor([[2.0, 1.0], [0.0, 3.0], [1.0, 0.5]])
    assert tc.accuracy(logits, torch.tensor([0, 1, 1])).item() == \
        pytest.approx(2 / 3)


def test_spec_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(tc.ClassifierSpec)]
            == [f.name for f in dataclasses.fields(jc.ClassifierSpec)])
