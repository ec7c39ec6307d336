"""The port's DiMamba training slice (`ddg_tpu_torch.models.dimamba` in
train mode, `entry.dimamba_train_flagship`) against `ddg_tpu`, at the size
of `dimamba_flagship(tiny=True)` (hidden 32, cond_dim 16, 2 blocks, L=256
as two scan chunks, d_state 16, V=12, 10 classes).

- The fp32 UDLM loss (`zero_recon_loss`, sigma conditioning, class labels)
  and every parameter gradient equal JAX's `loss_fn` on JAX's draw of
  (t, x_t), replayed into the port, on the three routes of a direction:
  the fused block (JAX's K18/K19 in interpret mode, the port's plain
  versions through its autograd wrapper), the unfused chain around the scan
  kernel (K14/K15) and the plain scan. Bars: the loss to rtol 1e-5, the
  gradients to rtol 1e-4 with atol 1e-4 of each gradient's largest
  magnitude (`test_dit_loss_grads_match_jax`'s). Model dropout and cond
  dropout are 0 here: their masks come from different generators.
- Dropout acts only in train mode, at the configured rate 0.1.
- `dimamba_train_flagship(tiny=True, device='cpu')` takes accumulated
  steps with finite losses and launches no kernel.
- `loss_fn(metrics=False)`, as the accumulating step calls it, skips the
  t = 0 forward kept only for the `recon_loss` metric, loss unchanged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddg_tpu.ops.selective_scan_pallas as jsp
from ddg_tpu import convert as jconvert
from ddg_tpu import diffusion as jd
from ddg_tpu.models import dimamba as jdm
from ddg_tpu.models import make_model_apply as jax_model_apply
from ddg_tpu.ops import forward_process as jfp
from ddg_tpu.ops import noise_schedules as jns
from ddg_tpu_torch import convert
from ddg_tpu_torch import diffusion as td
from ddg_tpu_torch.entry import dimamba_train_flagship
from ddg_tpu_torch.models import DiMamba, DiMambaConfig, make_model_apply
from ddg_tpu_torch.models import dimamba as tdm
from ddg_tpu_torch.ops import mamba
from ddg_tpu_torch.ops import noise_schedules as tns

torch.set_num_threads(1)
HID, COND, BLOCKS, V, NC, L, B = 32, 16, 2, 12, 10, 256, 3
SMALL = dict(hidden_size=HID, cond_dim=COND, length=L, n_blocks=BLOCKS,
             vocab_size=V, num_classes=NC, d_state=16, scan_chunk=128,
             scan_seg=64, scan_seg_bwd=64, dropout=0.0)
ROUTES = {
    'fused_block': dict(fused_block=True),
    'scan_kernel': dict(fused_block=False, pallas_scan=True),
    'plain_scan': dict(fused_block=False, pallas_scan=False),
}


@pytest.fixture(scope='module')
def params():
    """Reference-layout weights, matrices x4 so the mixer matters."""
    s = convert.make_reference_dimamba_state_dict(
        np.random.RandomState(0), hidden=HID, cond_dim=COND,
        n_blocks=BLOCKS, vocab=V, num_classes=NC)
    s = {k: v * 4 if v.ndim >= 2 and 'A_log' not in k else v
         for k, v in s.items()}
    return jconvert.convert_dimamba_params(s, n_blocks=BLOCKS)


def specs():
    kw = dict(diffusion='uniform', parameterization='d3pm', vocab_size=V,
              mask_index=3, num_classes=NC, time_conditioning=True,
              zero_recon_loss=True, antithetic_sampling=True,
              sampling_eps=1e-3)
    return (jd.DiffusionSpec(noise=jns.LogLinearNoise(), **kw),
            td.DiffusionSpec(noise=tns.LogLinearNoise(), **kw))


def data():
    r = np.random.RandomState(2)
    return (r.randint(7, 12, (B, L)).astype(np.int32),
            np.ones((B, L), np.float32),
            np.array([0, 4, 9], np.int32))


@pytest.mark.parametrize('route', list(ROUTES))
def test_float32_loss_and_grads_match_jax(params, route, monkeypatch):
    monkeypatch.setattr(jsp, 'selective_scan_pallas', functools.partial(
        jsp.selective_scan_pallas, interpret=True))
    js, ts = specs()
    x0, mask, cond = data()
    rng = jax.random.PRNGKey(5)
    _, loss_rng, _ = jax.random.split(rng, 3)
    t_rng, q_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jfp.sample_t(t_rng, B, sampling_eps=js.sampling_eps)
    xt = jfp.q_xt(q_rng, jnp.asarray(x0),
                  1 - jnp.exp(-js.noise(t)[0][:, None]),
                  diffusion='uniform', mask_index=3, vocab_size=V)
    jcfg = jdm.DiMambaConfig(**SMALL, compute_dtype=jnp.float32,
                             pallas_interpret=True, **ROUTES[route])
    apply_j = jax_model_apply(jdm.DiMamba(jcfg))

    def jloss(p):
        return jd.loss_fn(js, apply_j, p, jnp.asarray(x0), jnp.asarray(mask),
                          jnp.asarray(cond), rng, train=True).loss

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params))
    want = convert.dimamba_state_dict_from_jax(
        jax.tree.map(np.asarray, want_grads), n_blocks=BLOCKS)

    m = DiMamba(DiMambaConfig(**SMALL, compute_dtype=torch.float32,
                              **ROUTES[route]))
    m.load_state_dict(convert.dimamba_state_dict_from_jax(
        params, n_blocks=BLOCKS), strict=True)
    apply_t = make_model_apply(m)
    assert set(want) == set(apply_t.params)
    monkeypatch.setattr(td, 'sample_corruption', lambda *a, **k: (
        torch.tensor(np.asarray(t)), torch.tensor(np.asarray(xt))))
    out = td.loss_fn(ts, apply_t, apply_t.params, torch.from_numpy(x0),
                     torch.from_numpy(mask), torch.from_numpy(cond),
                     torch.Generator().manual_seed(0), train=True)
    names = list(apply_t.params)
    got = torch.autograd.grad(out.loss, [apply_t.params[k] for k in names],
                              allow_unused=True)
    np.testing.assert_allclose(out.loss.item(), float(want_loss), rtol=1e-5)
    for k, g in zip(names, got):
        w = np.asarray(want[k])
        if g is None:            # no path to the loss (e.g. unused rows)
            assert not w.any(), k
            continue
        assert tuple(g.shape) == w.shape, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_dropout_in_train_mode_only_at_the_configured_rate(monkeypatch):
    """Evaluation is deterministic; train mode draws its masks from `rng`
    (the same generator state gives the same logits) and moves the logits;
    each gated block calls dropout with rate 0.1."""
    run = dimamba_train_flagship(device='cpu', tiny=True)
    apply_fn = run.apply_fn
    assert run.cfg.dropout == 0.1
    x = torch.randint(7, 12, (2, run.cfg.length), dtype=torch.int32)
    sigma, cond = torch.full((2,), 0.5), torch.tensor([1, 8])
    a = apply_fn(apply_fn.params, x, sigma, cond)
    b = apply_fn(apply_fn.params, x, sigma, cond)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    rates = []
    real = tdm.dropout

    def spy(h, p, *, train, generator):
        rates.append((p, train))
        return real(h, p, train=train, generator=generator)

    monkeypatch.setattr(tdm, 'dropout', spy)
    c = apply_fn(apply_fn.params, x, sigma, cond, train=True,
                 rng=torch.Generator().manual_seed(1))
    d = apply_fn(apply_fn.params, x, sigma, cond, train=True,
                 rng=torch.Generator().manual_seed(1))
    assert c.requires_grad and not a.requires_grad
    torch.testing.assert_close(c, d, rtol=0, atol=0)
    assert (c - a).abs().max().item() > 1e-3
    assert rates == [(0.1, True)] * (2 * run.cfg.n_blocks)


def test_dimamba_train_flagship_tiny_runs_on_the_cpu():
    """The training entry point at tiny size: batches of DNA bases with a
    class label a row, accumulated steps with finite metrics; the CPU takes
    the plain versions, so no kernel launch is counted."""
    counters = (mamba.mamba_inner, mamba.mamba_inner_bwd, mamba.ssm_scan,
                mamba.ssm_scan_bwd)
    before = [f.launches for f in counters]
    run = dimamba_train_flagship(device='cpu', tiny=True)
    assert run.accum_steps == 2 and run.spec.zero_recon_loss
    assert run.spec.cond_dropout == 0.1 and run.optim.lr == 2e-3
    batch = run.batch(torch.Generator().manual_seed(0))
    assert tuple(batch['input_ids'].shape) == (2, 2, 256)
    assert tuple(batch['cond'].shape) == (2, 2)
    assert int(batch['input_ids'].min()) >= 7
    assert int(batch['input_ids'].max()) <= 11
    w0 = run.model.block_0.mixer.core_fwd.A_log.detach().clone()
    for _ in range(2):
        state, metrics = run.step(run.state, batch)
    assert state.step == 2
    assert all(np.isfinite(v.item()) for v in metrics.values())
    # the second step's learning rate is one warmup step in
    assert metrics['lr'].item() == pytest.approx(2e-3 / 2500)
    assert not torch.equal(w0, run.model.block_0.mixer.core_fwd.A_log)
    assert [f.launches for f in counters] == before


def test_unported_training_settings_still_raise():
    for name in ('remat',):
        with pytest.raises(NotImplementedError):
            DiMambaConfig(**{name: True})


def test_metric_only_terms_are_skipped_when_asked():
    """`metrics=False` (the accumulating step) skips the t = 0 forward that
    `zero_recon_loss` computes only for its metric; the loss is the same
    (the noised forward draws its masks first)."""
    run = dimamba_train_flagship(device='cpu', tiny=True)
    mb = {k: v[0] for k, v in run.batch(torch.Generator().manual_seed(3))
          .items()}
    outs = [td.loss_fn(run.spec, run.apply_fn, run.apply_fn.params,
                       mb['input_ids'], mb['attention_mask'], mb['cond'],
                       torch.Generator().manual_seed(4), train=True,
                       metrics=m) for m in (True, False)]
    assert outs[0].recon_loss is not None and outs[1].recon_loss is None
    torch.testing.assert_close(outs[0].loss, outs[1].loss, rtol=0, atol=0)
