"""The port's AR sampler (`samplers.ar_sample`: the KV-cache decode and the
full causal forward; none, D-CFG, FUDGE and PPLM) against
`ddg_tpu.samplers.ar_sample`, float32, on a tiny causal DiT denoiser
(hidden 64, 2 blocks of 2 heads, L=16, V=12, 2 classes + null) and tiny
causal DiT classifiers (one block of 2 heads; `no_pooling` at hidden 32
for FUDGE, mean pooling at the denoiser's width over its hidden state for
PPLM), the JAX
weights seeded, perturbed by 0.1 and carried over by the converters.

The port samples from JAX's noise (`_ar_noise` patched to return the
Gumbel draw JAX makes from its key). Tokens must equal JAX's wherever the
top-two perturbed scores of a step differ by more than 1e-4: a row may
differ only from a step whose two best perturbed scores (recorded from the
port's own step, on the prefix both share) lie within 1e-4, so the logits
are continuous and ties in FUDGE's top-k have probability zero.

- the KV path for none and D-CFG at gamma 0, 1 and 2 (the 2B mix), and
  with the int8 cache; the full-forward path for none and gamma 2;
- the port's KV path and full-forward path give identical tokens from one
  generator seed (none, gamma 0, 1, 2);
- the length buckets at L=160 (windows of 128 and 160 rows) give the
  tokens of `ar_buckets=1`;
- FUDGE (topk 5, gamma 1) and PPLM (two Adagrad steps) against JAX;
- `ar_kv_int8` warns on the full-forward path; unsupported guidance and
  missing inputs are refused; the AR entry points sample on the CPU.
"""

import dataclasses

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
from ddg_tpu.ops import sampling as jsampling
from ddg_tpu.ops.noise_schedules import LogLinearNoise as JLogLinear
from ddg_tpu_torch import entry
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.convert import (dit_classifier_state_dict_from_jax,
                                   dit_state_dict_from_jax)
from ddg_tpu_torch.diffusion import DiffusionSpec as TSpec
from ddg_tpu_torch.models import (DIT, DITClassifier, DITConfig,
                                  make_classifier_apply, make_model_apply)
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise as TLogLinear

torch.set_num_threads(1)
HID, COND, NB, NH, L, V, NC, B = 64, 32, 2, 2, 16, 12, 2, 4
CHID, CNB = 32, 1
MARGIN = 1e-4
KEY = jax.random.PRNGKey(3)
SPEC_KW = dict(diffusion='absorbing_state', parameterization='ar',
               vocab_size=V, mask_index=V - 1, num_classes=NC)
JSPEC = JSpec(noise=JLogLinear(), **SPEC_KW)
TSPEC = TSpec(noise=TLogLinear(), **SPEC_KW)
COND_IDS = np.array([0, 1, 1, 0], np.int32)


def jax_cfg(**kw):
    base = dict(hidden_size=HID, cond_dim=COND, length=L, n_blocks=NB,
                n_heads=NH, dropout=0.0, vocab_size=V, causal=True,
                use_adaLN=True, num_classes=NC, compute_dtype=jnp.float32)
    return jdit.DITConfig(**{**base, **kw})


def torch_cfg(**kw):
    base = dict(hidden_size=HID, cond_dim=COND, length=L, n_blocks=NB,
                n_heads=NH, dropout=0.0, vocab_size=V, causal=True,
                use_adaLN=True, num_classes=NC, compute_dtype=torch.float32,
                fused_rope_attn=True, fused_adaln=True)
    return DITConfig(**{**base, **kw})


def clf_cfgs(hidden):
    kw = dict(hidden_size=hidden, n_blocks=CNB, use_adaLN=False,
              num_classes=None)
    return jax_cfg(**kw), torch_cfg(**kw)


def perturbed(params, seed, scale=0.1):
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p)
                              + scale * r.randn(*p.shape).astype(np.float32)),
        params)


def denoiser(length=L, seed=1):
    """(JAX cfg, JAX params, JAX apply, port cfg, port apply)."""
    jcfg, tcfg = jax_cfg(length=length), torch_cfg(length=length)
    x = jnp.zeros((1, length), jnp.int32)
    p = perturbed(jdit.DIT(jcfg).init(jax.random.PRNGKey(0), x, None,
                                      jnp.zeros((1,), jnp.int32))['params'],
                  seed)
    m = DIT(tcfg)
    m.load_state_dict(dit_state_dict_from_jax(p, n_blocks=NB), strict=True)
    return jcfg, p, j_model_apply(jdit.DIT(jcfg)), tcfg, make_model_apply(
        m.eval())


@pytest.fixture(scope='module')
def models():
    jcfg, jp, japply, tcfg, tapply = denoiser()
    out = {'den': (jcfg, jp, japply, tcfg, tapply)}
    x = jnp.zeros((1, L), jnp.int32)
    # PPLM's classifier reads the denoiser's hidden state: its width.
    for name, pooling, hidden, seed in (('fudge', 'no_pooling', CHID, 5),
                                        ('pplm', 'mean', HID, 7)):
        cj, ct = clf_cfgs(hidden)
        jm = jdit.DITClassifier(cj, num_classes=2, pooling=pooling)
        p = perturbed(jm.init(jax.random.PRNGKey(seed), x, None)['params'],
                      seed + 1, scale=0.3)
        tm = DITClassifier(ct, num_classes=2, pooling=pooling)
        tm.load_state_dict(dit_classifier_state_dict_from_jax(
            p, n_blocks=CNB), strict=True)
        out[name] = (p, j_clf_apply(jm), make_classifier_apply(tm.eval()))
    return out


def jax_noise(shape):
    return np.array(jsampling.gumbel_noise_like(
        jax.random.split(KEY)[0], shape, dtype=jnp.float32))


def with_jax_noise(monkeypatch):
    """Patch the port's noise to JAX's draw and record each step's
    perturbed scores (the port's log-probs + noise)."""
    seen = []

    def noise(sampler, generator, shape):
        return torch.from_numpy(jax_noise(shape))

    def token(sampler, log_probs, noise_row):
        seen.append((log_probs + noise_row).clone())
        return real(sampler, log_probs, noise_row)
    real = TS._ar_token
    monkeypatch.setattr(TS, '_ar_noise', noise)
    monkeypatch.setattr(TS, '_ar_token', token)
    return seen


def assert_same_up_to_near_ties(got, want, seen):
    """got == want, except rows whose first difference comes at a step
    whose two best perturbed scores lie within MARGIN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and (got[:, 0] == want[:, 0]).all()
    for b in range(got.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            top2 = seen[diff[0] - 1][b].topk(2).values
            assert (top2[0] - top2[1]).item() <= MARGIN, (b, diff[0])
    assert (got == want).all(axis=1).mean() >= 0.75


CASES = {'none': None,
         'cfg0': dict(method='cfg', gamma=0.0),
         'cfg1': dict(method='cfg', gamma=1.0),
         'cfg2': dict(method='cfg', gamma=2.0)}


def _sample_pair(models, monkeypatch, case, sampler_kw, kv, jax_kw=None,
                 torch_kw=None):
    jcfg, jp, japply, tcfg, tapply = models['den']
    g = CASES[case]
    cond = COND_IDS if g else None
    kw = dict(batch_size=B, length=L, bos_token_id=0)
    want = JS.ar_sample(
        JSPEC, JS.SamplerSpec(**sampler_kw), japply, jp, KEY,
        guidance=g and JS.GuidanceSpec(**g),
        cond=None if cond is None else jnp.asarray(cond),
        decode_cfg=jcfg if kv else None, **kw, **(jax_kw or {}))
    seen = with_jax_noise(monkeypatch)
    got = TS.ar_sample(
        TSPEC, TS.SamplerSpec(**sampler_kw), tapply, tapply.params,
        torch.Generator(), guidance=g and TS.GuidanceSpec(**g),
        cond=None if cond is None else torch.from_numpy(cond),
        decode_cfg=tcfg if kv else None, **kw, **(torch_kw or {}))
    assert got.dtype == torch.int32 and got.shape == (B, L)
    assert_same_up_to_near_ties(got.numpy(), want, seen)
    return got


@pytest.mark.parametrize('case', list(CASES))
def test_kv_path_matches_jax(models, monkeypatch, case):
    """One bucket (the windows are the whole L=16 either way), but gamma 2
    with JAX's default four."""
    buckets = 4 if case == 'cfg2' else 1
    _sample_pair(models, monkeypatch, case, dict(ar_buckets=buckets),
                 kv=True)


def test_kv_int8_path_matches_jax(models, monkeypatch):
    _sample_pair(models, monkeypatch, 'cfg2',
                 dict(ar_buckets=1, ar_kv_int8=True), kv=True)


@pytest.mark.parametrize('case', ['none', 'cfg2'])
def test_full_forward_path_matches_jax(models, monkeypatch, case):
    _sample_pair(models, monkeypatch, case, {}, kv=False)


@pytest.mark.parametrize('case', list(CASES))
def test_kv_path_equals_full_forward_path(models, case):
    _, _, _, tcfg, tapply = models['den']
    g = CASES[case]
    cond = None if g is None else torch.from_numpy(COND_IDS)
    out = [TS.ar_sample(TSPEC, TS.SamplerSpec(), tapply, tapply.params,
                        torch.Generator().manual_seed(11), batch_size=B,
                        length=L, bos_token_id=2,
                        guidance=g and TS.GuidanceSpec(**g), cond=cond,
                        decode_cfg=cfg)
           for cfg in (tcfg, None)]
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    assert (out[0][:, 0] == 2).all()


def test_buckets_past_128_equal_one_bucket(monkeypatch):
    """At L=160 the four buckets read windows of 128, 128, 128 and 160
    rows; the tokens equal one bucket's (every row past the position
    carries exactly zero weight)."""
    from ddg_tpu_torch.models import dit_decode
    *_, tcfg, tapply = denoiser(length=160, seed=2)
    windows = {}
    step = dit_decode.decode_step

    def spy(*args, window=None, **kw):
        windows[window] = windows.get(window, 0) + 1
        return step(*args, window=window, **kw)

    monkeypatch.setattr(dit_decode, 'decode_step', spy)
    out = [TS.ar_sample(TSPEC, TS.SamplerSpec(ar_buckets=buckets), tapply,
                        tapply.params, torch.Generator().manual_seed(5),
                        batch_size=2, length=160, bos_token_id=0,
                        guidance=TS.GuidanceSpec(method='cfg', gamma=2.0),
                        cond=torch.tensor([0, 1], dtype=torch.int32),
                        decode_cfg=tcfg)
           for buckets in (4, 1)]
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    assert windows == {128: 119, 160: 40, None: 159}, windows


def test_fudge_matches_jax(models, monkeypatch):
    jcfg, jp, japply, _, tapply = models['den']
    cp, capply_j, capply_t = models['fudge']
    g = dict(method='fudge', topk=5, gamma=1.0, condition=1)
    kw = dict(batch_size=B, length=L, bos_token_id=0)
    want = JS.ar_sample(JSPEC, JS.SamplerSpec(), japply, jp, KEY,
                        guidance=JS.GuidanceSpec(**g),
                        classifier_apply=capply_j, classifier_params=cp,
                        **kw)
    seen = with_jax_noise(monkeypatch)
    got = TS.ar_sample(TSPEC, TS.SamplerSpec(), tapply, tapply.params,
                       torch.Generator(), guidance=TS.GuidanceSpec(**g),
                       classifier_apply=capply_t,
                       classifier_params=capply_t.params, **kw)
    assert all(s.shape == (B, 5) for s in seen)
    assert_same_up_to_near_ties(got.numpy(), want, seen)


def test_pplm_matches_jax(models, monkeypatch):
    jcfg, jp, japply, _, tapply = models['den']
    cp, capply_j, capply_t = models['pplm']
    g = dict(method='pplm', condition=1, num_pplm_steps=2,
             pplm_step_size=0.5, pplm_stability_coef=0.01)
    kw = dict(batch_size=B, length=L, bos_token_id=0)
    want = JS.ar_sample(JSPEC, JS.SamplerSpec(), japply, jp, KEY,
                        guidance=JS.GuidanceSpec(**g),
                        classifier_apply=capply_j, classifier_params=cp,
                        **kw)
    seen = with_jax_noise(monkeypatch)
    got = TS.ar_sample(TSPEC, TS.SamplerSpec(), tapply, tapply.params,
                       torch.Generator(), guidance=TS.GuidanceSpec(**g),
                       classifier_apply=capply_t,
                       classifier_params=capply_t.params, **kw)
    assert_same_up_to_near_ties(got.numpy(), want, seen)
    # The guidance moved the tokens: unguided decoding from the same noise
    # gives others.
    plain = TS.ar_sample(TSPEC, TS.SamplerSpec(), tapply, tapply.params,
                         torch.Generator(), **kw)
    assert not torch.equal(plain, got)


def test_full_forward_warns_on_int8_and_refusals(models):
    _, _, _, tcfg, tapply = models['den']
    _, _, capply = models['fudge']
    kw = dict(batch_size=2, length=6, bos_token_id=0)
    gen = torch.Generator()
    with pytest.warns(UserWarning, match='ar_kv_int8'):
        TS.ar_sample(TSPEC, TS.SamplerSpec(ar_kv_int8=True), tapply,
                     tapply.params, gen, **kw)
    with pytest.raises(NotImplementedError):
        TS.ar_sample(TSPEC, TS.SamplerSpec(), tapply, tapply.params, gen,
                     guidance=TS.GuidanceSpec(method='cbg'), **kw)
    with pytest.raises(ValueError):
        TS.ar_sample(TSPEC, TS.SamplerSpec(), tapply, tapply.params, gen,
                     guidance=TS.GuidanceSpec(method='fudge'), **kw)
    with pytest.raises(ValueError):
        TS.ar_sample(TSPEC, TS.SamplerSpec(), tapply, tapply.params, gen,
                     guidance=TS.GuidanceSpec(method='cfg'),
                     decode_cfg=tcfg, **kw)
    with pytest.raises(ValueError):
        TS.ar_sample(dataclasses.replace(TSPEC, parameterization='subs'),
                     TS.SamplerSpec(), tapply, tapply.params, gen, **kw)
    # Diffusion sampling refuses the AR guidance methods.
    with pytest.raises(NotImplementedError, match='ar_sample'):
        TS.diffusion_sample(
            dataclasses.replace(TSPEC, parameterization='subs'),
            TS.SamplerSpec(steps=2), tapply, tapply.params, gen,
            batch_size=2, length=L,
            guidance=TS.GuidanceSpec(method='fudge'), classifier_apply=capply,
            classifier_params=capply.params)


def test_sampler_spec_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(TS.SamplerSpec)]
            == [f.name for f in dataclasses.fields(JS.SamplerSpec)])
    assert TS.SamplerSpec() == TS.SamplerSpec(
        **dataclasses.asdict(JS.SamplerSpec()))


@pytest.mark.parametrize('name', ['ar_flagship', 'ar_fudge_flagship',
                                  'ar_pplm_flagship', 'dimamba_ar_flagship'])
def test_ar_entry_points_sample_on_cpu(name):
    run = getattr(entry, name)(tiny=True, device='cpu')
    n = min(run.length, 12)
    x = run.sample(torch.Generator().manual_seed(0), length=n)
    assert x.shape == (run.batch_size, n) and x.dtype == torch.int32
    assert ((x >= 0) & (x < run.cfg.vocab_size)).all()
    assert (x[:, 0] == run.bos_token_id).all()
