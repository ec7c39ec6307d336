"""The port's training runtime (`ddg_tpu_torch.runtime`, the DiT's train
mode, `entry.train_flagship`) against `ddg_tpu/runtime/*` and the JAX DiT:
schedules, clip + AdamW (optax), EMA/SWA, the fp32 DiT's loss gradients
with the fused flags on (float32, rtol 1e-4), gradient accumulation, the
eval step on the averaged weights, a run whose loss falls, dropout, and
the backward wrappers' (the DiMamba's K15 and K19 among them) refusal of
tensors that are not on the CPU or a card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddg_tpu import diffusion as jd
from ddg_tpu.models import dit as jdit
from ddg_tpu.models import make_model_apply as jax_model_apply
from ddg_tpu.ops import forward_process as jfp
from ddg_tpu.ops import noise_schedules as jns
from ddg_tpu.runtime import averaging as javg
from ddg_tpu.runtime import optim as jopt
from ddg_tpu_torch import convert as tconvert
from ddg_tpu_torch import diffusion as td
from ddg_tpu_torch.entry import train_flagship
from ddg_tpu_torch.models import DIT, DITConfig, make_model_apply
from ddg_tpu_torch.models.dit import dropout
from ddg_tpu_torch.ops import adaln, attention, mamba
from ddg_tpu_torch.ops import noise_schedules as tns
from ddg_tpu_torch.runtime import averaging as tavg
from ddg_tpu_torch.runtime import optim as topt
from ddg_tpu_torch.runtime.train_state import (init_train_state,
                                               make_eval_step,
                                               make_train_step)

torch.set_num_threads(1)
HID, COND, NB, NH, L, V = 128, 32, 2, 2, 16, 37
B = 4
MASK = V - 1


# --- schedules, optimizer, averaging ---------------------------------------

SCHEDULES = {
    'constant_warmup': jopt.OptimSpec(lr=3e-4, num_warmup_steps=10),
    'constant_no_warmup': jopt.OptimSpec(lr=1e-3, num_warmup_steps=0),
    'cosine_decay_warmup': jopt.OptimSpec(
        lr=1e-3, scheduler='cosine_decay_warmup', max_steps=100,
        warmup_frac=0.1, warmup_lr_init=1e-5, lr_min=1e-5),
}


def tspec(spec):
    return topt.OptimSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize('name', list(SCHEDULES))
def test_schedule_matches_jax(name):
    spec = SCHEDULES[name]
    want, got = jopt.make_schedule(spec), topt.make_schedule(tspec(spec))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


def test_clip_adamw_matches_optax():
    """Three updates of clip_by_global_norm + AdamW (decay 0.1, 2 warmup
    steps) on the same params and grads; the third is clipped."""
    spec = jopt.OptimSpec(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
                          num_warmup_steps=2)
    r = np.random.RandomState(0)
    params = {'a': r.randn(5, 3).astype(np.float32),
              'b': r.randn(7).astype(np.float32)}
    grads = [{k: (s * r.randn(*v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (0.1, 0.2, 5.0)]
    tx = jopt.make_optimizer(spec)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = [torch.tensor(params[k]) for k in ('a', 'b')]
    opt = topt.make_optimizer(tspec(spec), tp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.tensor(g[k]) for k in ('a', 'b')]
        norm = opt.step(tg)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        for t, k in zip(tp, ('a', 'b')):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-4, atol=1e-7)
    assert float(norm) > spec.grad_clip      # the last step was clipped


@pytest.mark.parametrize('kind', ['ema', 'ema_fixed', 'swa'])
def test_averaging_matches_jax(kind):
    spec = {'ema': javg.AveragingSpec.ema(0.999),
            'ema_fixed': javg.AveragingSpec.ema(0.9, use_num_updates=False),
            'swa': javg.AveragingSpec.swa(max_steps=12, start_pct=0.25,
                                          num_snapshots=3)}[kind]
    r = np.random.RandomState(1)
    params = {'w': r.randn(4, 3).astype(np.float32)}
    jstate = javg.init(spec, {k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = tavg.init(tavg.AveragingSpec(**dataclasses.asdict(spec)),
                       tparams)
    for _ in range(12):
        new = {k: r.randn(*v.shape).astype(np.float32)
               for k, v in params.items()}
        jstate = javg.update(spec, jstate,
                             {k: jnp.asarray(v) for k, v in new.items()})
        tavg.update(tavg.AveragingSpec(**dataclasses.asdict(spec)), tstate,
                    {k: torch.tensor(v) for k, v in new.items()})
        assert tstate.num_updates == int(jstate.num_updates)
        np.testing.assert_allclose(tstate.shadow_params['w'].numpy(),
                                   np.asarray(jstate.shadow_params['w']),
                                   rtol=1e-5, atol=1e-6)
    assert tavg.averaged_params(None, tparams) is tparams
    assert tavg.averaged_params(tstate, tparams) is tstate.shadow_params


# --- the fp32 DiT against JAX ----------------------------------------------

def jax_cfg():
    return jdit.DITConfig(hidden_size=HID, cond_dim=COND, length=L,
                          n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                          compute_dtype=jnp.float32, fused_adaln='interpret',
                          fused_rope_attn=True)


def torch_cfg(**kw):
    kw = dict(dict(dropout=0.0, fused_adaln=True, fused_rope_attn=True), **kw)
    return DITConfig(hidden_size=HID, cond_dim=COND, length=L, n_blocks=NB,
                     n_heads=NH, vocab_size=V, compute_dtype=torch.float32,
                     **kw)


@pytest.fixture(scope='module')
def weights():
    """JAX-initialised params perturbed by seeded noise (flax zero-inits
    the adaLN projections and the head)."""
    params = jax.jit(jdit.DIT(jax_cfg()).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32),
        jnp.ones((1,)))['params']
    r = np.random.RandomState(1)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * r.randn(*p.shape).astype(np.float32),
        params)


def torch_model(weights, **kw):
    m = DIT(torch_cfg(**kw))
    m.load_state_dict(tconvert.dit_state_dict_from_jax(weights, n_blocks=NB),
                      strict=True)
    return m


def specs():
    kw = dict(diffusion='absorbing_state', parameterization='subs',
              vocab_size=V, mask_index=MASK)
    return (jd.DiffusionSpec(noise=jns.LogLinearNoise(), **kw),
            td.DiffusionSpec(noise=tns.LogLinearNoise(), **kw))


def batch(seed, n=B):
    r = np.random.RandomState(seed)
    return {'input_ids': r.randint(0, V - 1, (n, L)).astype(np.int32),
            'attention_mask': np.ones((n, L), np.float32)}


def test_dit_loss_grads_match_jax(weights, monkeypatch):
    """MDLM loss and every parameter gradient of the fp32 DiT, fused flags
    on (the port's plain backwards on the CPU; JAX's adaLN kernels in
    interpret mode), on JAX's draw of (t, x_t)."""
    js, ts = specs()
    data = batch(2)
    rng = jax.random.PRNGKey(5)
    x0 = jnp.asarray(data['input_ids'])
    _, loss_rng, _ = jax.random.split(rng, 3)
    t_rng, q_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jfp.sample_t(t_rng, B, sampling_eps=js.sampling_eps)
    xt = jfp.q_xt(q_rng, x0, 1 - jnp.exp(-js.noise(t)[0][:, None]),
                  diffusion=js.diffusion, mask_index=MASK, vocab_size=V)
    apply_j = jax_model_apply(jdit.DIT(jax_cfg()))

    def jloss(p):
        return jd.loss_fn(js, apply_j, p, x0,
                          jnp.asarray(data['attention_mask']), None, rng,
                          train=True).loss

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, weights))
    want = tconvert.dit_state_dict_from_jax(
        jax.tree.map(np.asarray, want_grads), n_blocks=NB)

    m = torch_model(weights)
    apply_t = make_model_apply(m)
    assert want.keys() == apply_t.params.keys()
    # the port's loss on JAX's draw
    monkeypatch.setattr(td, 'sample_corruption', lambda *a, **k: (
        torch.tensor(np.asarray(t)), torch.tensor(np.asarray(xt))))
    out = td.loss_fn(ts, apply_t, apply_t.params,
                     torch.from_numpy(data['input_ids']),
                     torch.from_numpy(data['attention_mask']), None,
                     torch.Generator().manual_seed(0), train=True)
    names = list(apply_t.params)
    got = torch.autograd.grad(out.loss, [apply_t.params[k] for k in names])
    np.testing.assert_allclose(out.loss.item(), float(want_loss), rtol=1e-5)
    for k, g in zip(names, got):
        w = want[k].numpy()
        assert g.shape == want[k].shape, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def _setup(weights, **kw):
    m = torch_model(weights, **kw)
    return make_model_apply(m)


def test_accumulated_step_applies_the_micro_grad_average(weights):
    """accum_steps=4: the step applies exactly the average of the four
    micro-batch gradients, drawn in order from the state's generator
    (dropout on), through the same optimizer."""
    _, ts = specs()
    optim = topt.OptimSpec(lr=1e-3, num_warmup_steps=0)
    avg = tavg.AveragingSpec.ema(0.99)
    data = batch(3, 4 * B)
    split = {k: torch.from_numpy(v).reshape(4, B, L) for k, v in data.items()}

    ref = _setup(weights, dropout=0.1)
    gen = torch.Generator().manual_seed(11)
    names = list(ref.params)
    grads, losses = None, []
    for i in range(4):
        out = td.loss_fn(ts, ref, ref.params, split['input_ids'][i],
                         split['attention_mask'][i], None, gen, train=True,
                         step=0)
        g = torch.autograd.grad(out.loss, [ref.params[k] for k in names])
        grads = list(g) if grads is None else [a + b
                                                for a, b in zip(grads, g)]
        losses.append(out.loss.item())
    want = [p.detach().clone() for p in ref.params.values()]
    topt.make_optimizer(optim, want).step([g / 4 for g in grads])

    apply_fn = _setup(weights, dropout=0.1)
    state = init_train_state(torch.Generator().manual_seed(11),
                             apply_fn.params, optim, avg)
    step = make_train_step(ts, apply_fn, optim, avg, accum_steps=4)
    state, metrics = step(state, split)
    assert state.step == 1 and state.averaging.num_updates == 1
    np.testing.assert_allclose(metrics['loss'].item(), np.mean(losses),
                               rtol=1e-5)
    assert metrics['token_count'].item() == 4 * B * L
    for k, w in zip(names, want):
        np.testing.assert_allclose(state.params[k].numpy(), w.numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
        # the module's weights are the updated masters
        torch.testing.assert_close(apply_fn.params[k].detach(),
                                   state.params[k], rtol=0, atol=0)


def test_eval_step_reads_the_averaged_weights(weights):
    """With a frozen EMA shadow the eval step on the averaged weights
    gives the initial weights' NLL after a training step; on the live
    masters it does not."""
    _, ts = specs()
    optim = topt.OptimSpec(lr=1e-2, num_warmup_steps=0)
    avg = tavg.AveragingSpec.ema(1.0, use_num_updates=False)
    apply_fn = _setup(weights)
    state = init_train_state(torch.Generator().manual_seed(0),
                             apply_fn.params, optim, avg)
    data = {k: torch.from_numpy(v) for k, v in batch(4).items()}
    ev = make_eval_step(ts, apply_fn)
    ev_live = make_eval_step(ts, apply_fn, use_averaged=False)
    before = ev(state, data, torch.Generator().manual_seed(9))['nll_sum']
    state, _ = make_train_step(ts, apply_fn, optim, avg)(state, data)
    after = ev(state, data, torch.Generator().manual_seed(9))['nll_sum']
    live = ev_live(state, data, torch.Generator().manual_seed(9))['nll_sum']
    torch.testing.assert_close(after, before, rtol=1e-6, atol=1e-6)
    assert abs(live.item() - before.item()) > 1e-3


def test_loss_decreases(weights):
    """A learnable batch (one constant token) under the t-independent
    simple-CE objective drives the loss to near 0."""
    _, ts = specs()
    ts = dataclasses.replace(ts, use_simple_ce_loss=True)
    optim = topt.OptimSpec(lr=3e-3, num_warmup_steps=0)
    avg = tavg.AveragingSpec.ema(0.99)
    apply_fn = _setup(weights)
    state = init_train_state(torch.Generator().manual_seed(0),
                             apply_fn.params, optim, avg)
    step = make_train_step(ts, apply_fn, optim, avg)
    data = {'input_ids': torch.full((B, L), 3, dtype=torch.int32),
            'attention_mask': torch.ones((B, L))}
    losses = []
    for _ in range(60):
        state, metrics = step(state, data)
        losses.append(metrics['loss'].item())
    assert losses[-1] < 0.05 * losses[0]
    assert state.step == 60
    assert np.isfinite(metrics['grad_norm'].item())


def test_train_flagship_tiny_runs_on_the_cpu():
    """The training entry point at tiny size: the CPU takes the plain
    versions, so no kernel launch is counted."""
    counters = (adaln.ln_modulate, adaln.ln_modulate_bwd,
                adaln.gate_res_ln_modulate, adaln.gate_res_ln_modulate_bwd,
                attention.fused_rope_attention,
                attention.fused_rope_attention_bwd)
    before = [f.launches for f in counters]
    run = train_flagship(device='cpu', tiny=True)
    assert run.accum_steps == 2 and run.cfg.dropout == 0.1
    data = run.batch(torch.Generator().manual_seed(0))
    assert tuple(data['input_ids'].shape) == (2, 4, 32)
    state, metrics = run.step(run.state, data)
    assert state.step == 1
    assert set(metrics) == {'loss', 'nll_sum', 'token_count', 'lr',
                            'grad_norm'}
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert metrics['lr'].item() == 0.0        # schedule(0) under warmup
    assert [f.launches for f in counters] == before


# --- dropout -----------------------------------------------------------------

def test_dropout_statistics():
    x = torch.ones(200_000)
    y = dropout(x, 0.1, train=True, generator=torch.Generator().manual_seed(0))
    keep = (y != 0).float().mean().item()
    assert abs(keep - 0.9) < 4 * (0.9 * 0.1 / x.numel()) ** 0.5
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    y2 = dropout(x, 0.1, train=True,
                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)
    assert dropout(x, 0.1, train=False, generator=None) is x
    assert dropout(x, 0.0, train=True, generator=None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.1, train=True, generator=None)


def test_dit_dropout_in_train_mode_only(weights):
    apply_fn = _setup(weights, dropout=0.1)
    x = torch.from_numpy(batch(6)['input_ids'])
    sigma = torch.zeros(B)
    a = apply_fn(apply_fn.params, x, sigma)
    b = apply_fn(apply_fn.params, x, sigma)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = apply_fn(apply_fn.params, x, sigma, train=True,
                 rng=torch.Generator().manual_seed(1))
    d = apply_fn(apply_fn.params, x, sigma, train=True,
                 rng=torch.Generator().manual_seed(1))
    assert c.requires_grad and not a.requires_grad
    torch.testing.assert_close(c, d, rtol=0, atol=0)
    assert (c - a).abs().max().item() > 1e-3


# --- the backward wrappers off the CPU ----------------------------------------

def test_backward_wrappers_never_take_the_plain_version_off_the_cpu():
    """Off the CPU the backward wrappers launch their kernel or raise: a
    tensor on another device is refused, and nothing is counted."""
    def meta(*s):
        return torch.empty(s, device='meta')
    counters = (adaln.ln_modulate_bwd, adaln.gate_res_ln_modulate_bwd,
                attention.fused_rope_attention_bwd, mamba.ssm_scan_bwd,
                mamba.mamba_inner_bwd)
    before = [f.launches for f in counters]
    x, d = meta(2, 16, 128), meta(2, 16, 128)
    w, c = meta(128), meta(2, 128)
    with pytest.raises(ValueError):
        adaln.ln_modulate_bwd(x, w, c, d)
    with pytest.raises(ValueError):
        adaln.gate_res_ln_modulate_bwd(x, x, c, w, c, d, d)
    q = meta(2, 16, 2, 64)
    with pytest.raises(ValueError):
        attention.fused_rope_attention_bwd(q, q, q, meta(16, 32),
                                           meta(16, 32), q)
    u, a, bc, h0s = meta(2, 256, 64), meta(64, 16), meta(2, 256, 16), \
        meta(2, 2, 16, 64)
    with pytest.raises(ValueError):
        mamba.ssm_scan_bwd(u, u, a, bc, bc, meta(64), u, h0s, u, chunk=128)
    h = meta(2, 256, 32)
    with pytest.raises(ValueError):
        mamba.mamba_inner_bwd(h, meta(32, 128), meta(4, 1, 64), meta(64),
                              meta(64, 48), meta(16, 64), meta(64), a,
                              meta(64), meta(64, 32), h0s, h, d_state=16,
                              dt_rank=16, chunk=128)
    assert [f.launches for f in counters] == before
