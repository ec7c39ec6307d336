"""The port's UNet training slice (`ddg_tpu_torch.models.unet` in train
mode, `entry.unet_train_flagship`) against `ddg_tpu`, at `bench.py --unet
--quick`'s size (ch 16, one res block, 2 scales, 8 x 8 x 3 images: L=192,
V=256, 10 classes), float32, model dropout 0 and cond dropout 0 (their
masks come from other generators), on the same params and batch and on
JAX's draw of (t, x_t), replayed into the port:

- the uniform-state D3PM loss (continuous time, `zero_recon_loss`,
  antithetic t, sigma conditioning, class labels) and every parameter
  gradient equal `jax.value_and_grad` of `ddg_tpu.diffusion.loss_fn` with
  `train=True`: the loss to rtol 1e-5, the gradients to rtol 1e-4 with
  atol 1e-4 of each gradient's largest magnitude
  (`test_dit_loss_grads_match_jax`'s bars), JAX's gradient taken in two
  pieces around the ill-conditioned logistic head (the test's docstring);
- after one `make_train_step` (AdamW with weight decay, the gradient
  clipped, EMA) the loss is JAX's to the 1e-3 bar of BASELINE.md, and the
  parameters and the EMA shadow are `ddg_tpu.runtime.train_state`'s to
  1e-3 of the learning rate plus what JAX's own gradient error can move a
  first Adam step (the test's docstring);
- dropout: in train mode only, after `norm1` of every ResBlock at the
  configured rate, its masks from `rng` (keep share and 1 / (1 - p)
  scaling), a raise without a generator; the GroupNorms take their plain
  version under training even with `fused_norm`;
- `unet_train_flagship(tiny=True, device='cpu')` takes two steps to a
  finite loss, on class-pattern images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu import diffusion as jd
from ddg_tpu.models import make_model_apply as j_make_apply
from ddg_tpu.models import unet as junet
from ddg_tpu.ops import forward_process as jfp
from ddg_tpu.ops import noise_schedules as jns
from ddg_tpu.runtime import averaging as javg
from ddg_tpu.runtime import optim as joptim
from ddg_tpu.runtime import train_state as jts
from ddg_tpu_torch import diffusion as td
from ddg_tpu_torch.convert import unet_state_dict_from_jax
from ddg_tpu_torch.entry import class_pattern_images, unet_train_flagship
from ddg_tpu_torch.models import UNet, UNetConfig, make_model_apply
from ddg_tpu_torch.models import unet as tunet
from ddg_tpu_torch.ops import groupnorm
from ddg_tpu_torch.ops import noise_schedules as tns
from ddg_tpu_torch.runtime import averaging as tavg
from ddg_tpu_torch.runtime import optim as toptim
from ddg_tpu_torch.runtime import train_state as tts

torch.set_num_threads(1)
IMG, V, NC, B = 8, 256, 10, 3
L = 3 * IMG * IMG
SMALL = dict(ch=16, num_res_blocks=1, num_scales=2, ch_mult=(1, 1),
             image_size=IMG, num_classes=NC, dropout=0.0)
JCFG = junet.UNetConfig(**SMALL, compute_dtype=jnp.float32)


@pytest.fixture(scope='module')
def params():
    """JAX-initialised params, perturbed by seeded noise (flax zero-inits
    the biases and, near, the attention output projection)."""
    p = jax.jit(junet.UNet(JCFG).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32), jnp.ones((1,)),
        jnp.zeros((1,), jnp.int32))['params']
    r = np.random.RandomState(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * r.randn(*a.shape).astype(np.float32),
        p)


def specs():
    kw = dict(diffusion='uniform', parameterization='d3pm', vocab_size=V,
              mask_index=-1, num_classes=NC, time_conditioning=True,
              zero_recon_loss=True, antithetic_sampling=True,
              sampling_eps=1e-3)
    return (jd.DiffusionSpec(noise=jns.LogLinearNoise(), **kw),
            td.DiffusionSpec(noise=tns.LogLinearNoise(), **kw))


def batch():
    r = np.random.RandomState(2)
    return {'input_ids': r.randint(0, V, (B, L)).astype(np.int32),
            'attention_mask': np.ones((B, L), np.float32),
            'cond': np.array([0, 4, 9], np.int32)}


def replay(js, x0, rng):
    """JAX's (t, x_t) in `loss_fn` with key `rng` (`_, loss_rng, _ =
    split(rng, 3)`, then `t_rng, q_rng, ... = split(loss_rng, 5)`)."""
    _, loss_rng, _ = jax.random.split(rng, 3)
    t_rng, q_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jfp.sample_t(t_rng, x0.shape[0], sampling_eps=js.sampling_eps,
                     antithetic=js.antithetic_sampling, noise=js.noise)
    xt = jfp.q_xt(q_rng, x0, 1 - jnp.exp(-js.noise(t)[0][:, None]),
                  diffusion='uniform', mask_index=-1, vocab_size=V)
    return np.array(t), np.array(xt)


def port_apply(params, **kw):
    m = UNet(UNetConfig(**dict(SMALL, **kw), compute_dtype=torch.float32))
    m.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    return make_model_apply(m)


def use_draw(monkeypatch, draw):
    t, xt = draw
    monkeypatch.setattr(td, 'sample_corruption', lambda *a, **k: (
        torch.from_numpy(t), torch.from_numpy(xt)))


def _head_loss(js, b, rng, xt):
    """JAX's loss as a function of the trunk output h (B, H, W, 6): the
    UNet's head (tanh-residual mean, truncated logistic) on h, through
    `ddg_tpu.diffusion.loss_fn` with the batch's draw."""
    x = jnp.asarray(xt).reshape(B, 3, IMG, IMG).transpose(0, 2, 3, 1)
    centered = 2 * (x.astype(jnp.float32) / V) - 1

    def head(h):
        mu = jnp.tanh(centered + h[..., :3])
        return junet.truncated_logistic_logits(mu, h[..., 3:], vocab_size=V,
                                               fix_logistic=False)

    def loss(h):
        return jd.loss_fn(js, lambda p, *a, **k: head(p), h,
                          jnp.asarray(b['input_ids']),
                          jnp.asarray(b['attention_mask']),
                          jnp.asarray(b['cond']), rng, train=True).loss
    return loss


def test_loss_and_grads_match_jax(params, monkeypatch):
    """The loss to rtol 1e-5 against the jitted JAX loss, and the noised
    forward's trunk output (the head's input) to 1e-4, as
    `tests/test_torch_unet.py` holds it. The gradients: the
    truncated-logistic head is ill-conditioned (its cancelling tail), and
    XLA's fused elementwise code moves JAX's own head gradient by about
    1e-4 of its largest magnitude between the jitted and the un-jitted
    loss, which reaches every parameter's gradient at a few 1e-4. So JAX's
    gradient is taken by the chain rule in two pieces: `jax.grad` of the
    loss in the trunk output, un-jitted, and the jitted `jax.vjp` of the
    trunk with that cotangent; and the port's head is evaluated at JAX's
    trunk output (h + (h_jax - h).detach(), the port's trunk
    differentiated through it unchanged). The gradient in the trunk
    output, then every parameter's gradient, to rtol 1e-4 with atol 1e-4 of
    its largest magnitude (`test_dit_loss_grads_match_jax`'s bars); the
    attention key biases' gradients, zero but for rounding, to 1e-6 of
    their key matrix's."""
    js, ts = specs()
    b = batch()
    rng = jax.random.PRNGKey(5)
    t, xt = replay(js, jnp.asarray(b['input_ids']), rng)
    japply = j_make_apply(junet.UNet(JCFG))

    def jloss(p):
        return jd.loss_fn(js, japply, p, jnp.asarray(b['input_ids']),
                          jnp.asarray(b['attention_mask']),
                          jnp.asarray(b['cond']), rng, train=True).loss

    want_loss = jax.jit(jloss)(jax.tree.map(jnp.asarray, params))
    sigma = np.asarray(js.noise(jnp.asarray(t))[0])
    trunk_args = (jnp.asarray(xt), jnp.asarray(sigma), jnp.asarray(b['cond']))

    def trunk(p):
        return junet.UNet(JCFG).apply({'params': p}, *trunk_args,
                                      return_hidden_states=True)[1]

    want_hidden = np.asarray(jax.jit(trunk)(params))
    dh = jax.grad(_head_loss(js, b, rng, xt))(jnp.asarray(want_hidden))
    want_grads = jax.jit(lambda p, ct: jax.vjp(trunk, p)[1](ct)[0])(
        jax.tree.map(jnp.asarray, params), dh)
    want = unet_state_dict_from_jax(jax.tree.map(np.asarray, want_grads))

    apply_t = port_apply(params)
    assert set(want) == set(apply_t.params)
    use_draw(monkeypatch, (t, xt))
    conv_out = apply_t.params['conv_out.weight']
    plain_conv, seen = tunet._conv, []

    def at_jax_hidden(conv, x, **kw):
        out = plain_conv(conv, x, **kw)
        if conv.weight is conv_out and not seen:     # the noised forward
            h = out + (torch.from_numpy(want_hidden) - out).detach()
            h.retain_grad()
            seen.append((out.detach().clone(), h))
            return h
        return out

    monkeypatch.setattr(tunet, '_conv', at_jax_hidden)
    out = td.loss_fn(ts, apply_t, apply_t.params,
                     *(torch.from_numpy(b[k]) for k in
                       ('input_ids', 'attention_mask', 'cond')),
                     torch.Generator().manual_seed(0), train=True)
    np.testing.assert_allclose(seen[0][0].numpy(), want_hidden, atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(out.loss.item(), float(want_loss), rtol=1e-5)
    out.loss.backward()
    dh = np.asarray(dh)
    np.testing.assert_allclose(seen[0][1].grad.numpy(), dh, rtol=1e-4,
                               atol=1e-4 * np.abs(dh).max())
    for k, p in apply_t.params.items():
        w, g = want[k].numpy(), p.grad.numpy()
        assert g.shape == w.shape, k
        if k.endswith('.k.b'):
            # Exactly zero (the softmax over keys ignores q . b_k): both
            # sides' rounding noise, held to 1e-6 of the key matrix's.
            scale = 1e-6 * np.abs(want[k[:-1] + 'W'].numpy()).max()
            assert np.abs(g).max() <= scale and np.abs(w).max() <= scale, k
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_train_step_matches_jax(params, monkeypatch):
    """One step of AdamW (weight decay 0.1) with the gradient clipped at
    1.0 and EMA, against the jitted `ddg_tpu.runtime.train_state` step on
    JAX's draw: the loss to 1e-3 (BASELINE.md's bar), the gradient norm to
    rtol 1e-4. The jitted JAX step's gradients carry XLA's head error (a few
    1e-4 of their largest magnitude: the test above). AdamW's first step
    moves a parameter by lr g / (|g| + eps) + lr wd p (g clipped), which a
    gradient error D moves by at most lr eps D / (|g| + eps)^2: nothing
    where |g| >> sqrt(eps D), up to 2 lr where |g| is near eps. So with D
    = 1e-3 of each clipped gradient's largest magnitude (the port's), each
    parameter is held to 1e-3 lr plus that bound, capped at 2 lr, and so is
    the EMA shadow (0.1 of the old value and 0.9 of the new after one
    update). The attention key biases' gradients are zero but for
    rounding, so their steps (up to lr either way) are held to 2 lr."""
    js, ts = specs()
    b = batch()
    kw = dict(lr=1e-3, num_warmup_steps=0, weight_decay=0.1, grad_clip=1.0)
    jopt, topt = joptim.OptimSpec(**kw), toptim.OptimSpec(**kw)
    javg_spec, tavg_spec = (javg.AveragingSpec.ema(0.9999),
                            tavg.AveragingSpec.ema(0.9999))
    key = jax.random.PRNGKey(11)
    japply = j_make_apply(junet.UNet(JCFG))
    jstate = jts.init_train_state(key, jax.tree.map(jnp.asarray, params),
                                  jopt, javg_spec)
    _, step_rng = jax.random.split(key)
    use_draw(monkeypatch, replay(js, jnp.asarray(b['input_ids']), step_rng))
    jstep = jax.jit(jts.make_train_step(js, japply, jopt, javg_spec))
    jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, b))

    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tapply = port_apply(params)
    out = td.loss_fn(ts, tapply, tapply.params, tb['input_ids'],
                     tb['attention_mask'], tb['cond'],
                     torch.Generator().manual_seed(0), train=True)
    grads = dict(zip(tapply.params, torch.autograd.grad(
        out.loss, list(tapply.params.values()))))
    tstate = tts.init_train_state(torch.Generator().manual_seed(0),
                                  tapply.params, topt, tavg_spec)
    tstep = tts.make_train_step(ts, tapply, topt, tavg_spec)
    tstate, tmet = tstep(tstate, tb)
    assert abs(tmet['loss'].item() - float(jmet['loss'])) <= 1e-3
    norm = float(jmet['grad_norm'])
    np.testing.assert_allclose(tmet['grad_norm'].item(), norm, rtol=1e-4)
    assert norm > kw['grad_clip']                          # clipped
    want = unet_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    want_ema = unet_state_dict_from_jax(jax.tree.map(
        np.asarray, jstate.averaging.shadow_params))
    before = unet_state_dict_from_jax(params)
    lr, eps = kw['lr'], 1e-8
    for k, v in tstate.params.items():
        g = np.abs(grads[k].numpy()) * kw['grad_clip'] / norm
        bar = lr * (1e-3 + np.minimum(2.0, eps * 1e-3 * g.max()
                                      / (g + eps) ** 2))
        if k.endswith('.k.b'):        # a gradient of rounding noise alone
            bar = lr * (1e-3 + 2.0)
        for got, ref in ((v, want[k]),
                         (tstate.averaging.shadow_params[k], want_ema[k])):
            assert np.all(np.abs(got.numpy() - ref.numpy()) <= bar), k
        np.testing.assert_array_equal(tapply.params[k].detach().numpy(),
                                      v.numpy())
        assert not np.array_equal(v.numpy(), before[k].numpy()), k


def test_dropout_after_norm1_in_train_mode_only(params, monkeypatch):
    """Evaluation is deterministic and ignores `rng`; train mode calls
    dropout once a ResBlock, at rate 0.1, on norm1's output, its masks from
    `rng` (the same generator state, the same logits) moving the logits;
    the keep share and the 1 / (1 - p) scaling; a raise without a
    generator."""
    apply_fn = port_apply(params, dropout=0.1)
    x = torch.from_numpy(batch()['input_ids'])
    sigma, cond = torch.full((B,), 0.5), torch.tensor([1, 5, NC])
    a = apply_fn(apply_fn.params, x, sigma, cond)
    torch.testing.assert_close(a, apply_fn(apply_fn.params, x, sigma, cond),
                               rtol=0, atol=0)
    calls, real = [], tunet.dropout

    def spy(h, p, *, train, generator):
        out = real(h, p, train=train, generator=generator)
        calls.append((p, train, h.detach(), out.detach()))
        return out

    monkeypatch.setattr(tunet, 'dropout', spy)
    c = apply_fn(apply_fn.params, x, sigma, cond, train=True,
                 rng=torch.Generator().manual_seed(1))
    n_res = len(calls)
    d = apply_fn(apply_fn.params, x, sigma, cond, train=True,
                 rng=torch.Generator().manual_seed(1))
    assert c.requires_grad and not a.requires_grad
    torch.testing.assert_close(c, d, rtol=0, atol=0)
    assert (c - a).abs().max().item() > 1e-3
    assert n_res == 8 and all(p == 0.1 and t for p, t, _, _ in calls)
    h = torch.cat([i.flatten() for _, _, i, _ in calls[:n_res]])
    out = torch.cat([o.flatten() for _, _, _, o in calls[:n_res]])
    live = h != 0
    kept = (out[live] != 0).float().mean().item()
    assert abs(kept - 0.9) < 4 * (0.9 * 0.1 / live.sum().item()) ** 0.5
    k = live & (out != 0)
    torch.testing.assert_close(out[k], h[k] / 0.9, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match='generator'):
        apply_fn(apply_fn.params, x, sigma, cond, train=True, rng=None)


def test_training_takes_the_plain_groupnorm(params, monkeypatch):
    """`fused_norm=True` runs `fused_group_norm_act` in evaluation and its
    plain version under training (the kernel has no backward), as JAX's
    `fn = cfg.fused_norm and not train`."""
    apply_fn = port_apply(params, fused_norm=True)
    x = torch.from_numpy(batch()['input_ids'])
    sigma, cond = torch.full((B,), 0.5), torch.tensor([1, 5, NC])
    used = []
    real = groupnorm.fused_group_norm_act
    monkeypatch.setattr(groupnorm, 'fused_group_norm_act',
                        lambda *a, **k: used.append(1) or real(*a, **k))
    apply_fn(apply_fn.params, x, sigma, cond)
    assert len(used) == 2 * 8 + 4 + 1        # every GroupNorm of a forward
    used.clear()
    out = apply_fn(apply_fn.params, x, sigma, cond, train=True,
                   rng=torch.Generator().manual_seed(0))
    out.sum().backward()
    assert not used


def test_unet_train_flagship_tiny_runs_on_the_cpu():
    """The training entry point at tiny size: the reference script's
    settings, class-pattern images a generator fixes, two accumulated steps
    to finite metrics that move the weights; the CPU takes the plain
    versions, so no kernel launch is counted."""
    counters = (groupnorm.fused_group_norm_act,)
    before = [f.launches for f in counters]
    run = unet_train_flagship(device='cpu', tiny=True)
    assert (run.global_batch, run.accum_steps) == (4, 2)
    assert run.cfg.dropout == 0.1 and run.cfg.compute_dtype == torch.bfloat16
    assert run.spec.zero_recon_loss and run.spec.cond_dropout == 0.1
    assert run.spec.time_conditioning and run.spec.antithetic_sampling
    assert (run.optim.lr, run.optim.weight_decay, run.optim.grad_clip,
            run.optim.num_warmup_steps) == (2e-4, 0.0, 1.0, 2500)
    assert run.averaging.decay == 0.9999
    data = run.batch(torch.Generator().manual_seed(0))
    again = run.batch(torch.Generator().manual_seed(0))
    assert all(torch.equal(data[k], again[k]) for k in data)
    assert tuple(data['input_ids'].shape) == (2, 2, L)
    assert tuple(data['cond'].shape) == (2, 2)
    ids = data['input_ids']
    assert int(ids.min()) >= 0 and int(ids.max()) <= 255
    w0 = run.state.params['conv_in.weight'].clone()
    for _ in range(2):
        state, metrics = run.step(run.state, data)
    assert state.step == 2
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert metrics['lr'].item() == pytest.approx(2e-4 / 2500)
    # The float32 masters move (the module's bf16 copy may not yet: the
    # second step's learning rate is below bf16's resolution).
    assert not torch.equal(w0, run.state.params['conv_in.weight'])
    assert [f.launches for f in counters] == before


def test_class_patterns_tell_the_classes_apart():
    """Each class's images share a pattern: the mean image of one class is
    nearer its own images than another class's mean image is."""
    gen = torch.Generator().manual_seed(3)
    cond = torch.arange(NC).repeat_interleave(16)
    img = class_pattern_images(cond, gen, image_size=IMG).float()
    means = img.reshape(NC, 16, L).mean(1)
    dist = torch.cdist(img, means)              # (NC * 16, NC)
    assert (dist.argmin(-1) == cond).float().mean().item() > 0.95
