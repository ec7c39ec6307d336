"""The DiT's attention options against `ddg_tpu`'s flax DIT on the same
weights (carried across by `convert.dit_state_dict_from_jax`):

- `tpu_flash_attn` (RoPE, then the library flash attention: the port's
  K20-K22, their plain versions on the CPU; JAX runs the library under
  `pltpu.force_tpu_interpret_mode()`), at L=256 (two key blocks);
- `attn_probs_bf16` (`einsum_attention`: the probabilities rounded to bf16
  before PV) with and without `attn_remat`, and `attn_remat` alone on the
  plain route (`jax.checkpoint` in JAX, `torch.utils.checkpoint` here).

Float32 logits to the 1e-3 bar of BASELINE.md; for the plain-route options
also the text8 MDLM loss and every parameter gradient at rtol 1e-4
(`tests/test_torch_text8_train.py` holds the flash route's, with the text8
run's own flags).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ddg_tpu import diffusion as jd
from ddg_tpu.models import dit as jdit
from ddg_tpu.models import make_model_apply as jax_model_apply
from ddg_tpu.ops import forward_process as jfp
from ddg_tpu.ops import noise_schedules as jns
from ddg_tpu_torch import convert as tconvert
from ddg_tpu_torch import diffusion as td
from ddg_tpu_torch import entry
from ddg_tpu_torch.models import DIT, DITConfig, make_model_apply
from ddg_tpu_torch.ops import flash_attention

torch.set_num_threads(1)
HID, COND, NB, NH, L, V = 128, 32, 2, 2, 256, 37
OPTIONS = {'flash': dict(tpu_flash_attn=True),
           'probs_bf16': dict(attn_probs_bf16=True),
           'probs_bf16_remat': dict(attn_probs_bf16=True, attn_remat=True),
           'remat': dict(attn_remat=True)}


def jax_cfg(length=L, **kw):
    return jdit.DITConfig(hidden_size=HID, cond_dim=COND, length=length,
                          n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                          compute_dtype=jnp.float32, **kw)


def torch_model(weights, length=L, **kw):
    m = DIT(DITConfig(hidden_size=HID, cond_dim=COND, length=length,
                      n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                      compute_dtype=torch.float32, **kw))
    m.load_state_dict(tconvert.dit_state_dict_from_jax(weights,
                                                       n_blocks=NB),
                      strict=True)
    return m


def interpret(option):
    return (pltpu.force_tpu_interpret_mode() if option == 'flash'
            else contextlib.nullcontext())


def jax_logits(option, weights, x, sigma):
    """The flax DIT's logits as one jitted call, waited for before anything
    else is dispatched. The TPU interpret mode's io_callbacks dispatch jnp
    operations of their own; run op by op, the flax forward kept
    dispatching past the flash kernel, and a callback's operation could
    queue behind one that waits on the kernel's output (a deadlock that
    showed under CPU contention)."""
    model = jdit.DIT(jax_cfg(**OPTIONS[option]))
    with interpret(option):
        return jax.block_until_ready(jax.jit(model.apply)(
            {'params': weights}, jnp.asarray(x), jnp.asarray(sigma)))


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


@pytest.mark.parametrize('option', list(OPTIONS))
def test_logits_match_jax(weights, option):
    r = np.random.RandomState(2)
    x = r.randint(0, V, (2, L)).astype(np.int32)
    sigma = r.uniform(0, 2, 2).astype(np.float32)
    want = jax_logits(option, weights, x, sigma)
    assert float(jnp.abs(want).max()) > 0.1      # not trivially zero
    m = torch_model(weights, **OPTIONS[option]).eval()
    before = flash_attention.flash_attention_fwd.launches
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3,
                               rtol=0)
    assert flash_attention.flash_attention_fwd.launches == before


@pytest.mark.parametrize('option', ['probs_bf16', 'probs_bf16_remat',
                                    'remat'])
def test_loss_and_grads_match_jax(weights, option, monkeypatch):
    """The text8 MDLM loss (absorbing SUBS, log-linear noise) at L=128 and
    every parameter gradient, the corruption drawn by JAX and handed to the
    port."""
    length, B = 128, 2
    spec = dataclasses.replace(entry.text8_train_setup(tiny=True).spec,
                               vocab_size=V, mask_index=V - 1)
    js = jd.DiffusionSpec(noise=jns.LogLinearNoise(),
                          diffusion='absorbing_state',
                          parameterization='subs', vocab_size=V,
                          mask_index=V - 1)
    r = np.random.RandomState(3)
    ids = r.randint(0, V - 1, (B, length)).astype(np.int32)
    mask = np.ones((B, length), np.float32)
    rng = jax.random.PRNGKey(5)
    x0 = jnp.asarray(ids)
    _, loss_rng, _ = jax.random.split(rng, 3)
    t_rng, q_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jfp.sample_t(t_rng, B, sampling_eps=js.sampling_eps)
    xt = jfp.q_xt(q_rng, x0, 1 - jnp.exp(-js.noise(t)[0][:, None]),
                  diffusion=js.diffusion, mask_index=V - 1, vocab_size=V)
    apply_j = jax_model_apply(jdit.DIT(jax_cfg(length, **OPTIONS[option])))

    def jloss(p):
        return jd.loss_fn(js, apply_j, p, x0, jnp.asarray(mask), None, rng,
                          train=True).loss

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, weights))
    want = tconvert.dit_state_dict_from_jax(
        jax.tree.map(np.asarray, want_grads), n_blocks=NB)

    apply_t = make_model_apply(torch_model(weights, length,
                                           **OPTIONS[option]))
    monkeypatch.setattr(td, 'sample_corruption', lambda *a, **k: (
        torch.tensor(np.asarray(t)), torch.tensor(np.asarray(xt))))
    out = td.loss_fn(spec, apply_t, apply_t.params, torch.from_numpy(ids),
                     torch.from_numpy(mask), None,
                     torch.Generator().manual_seed(0), train=True)
    names = list(apply_t.params)
    got = torch.autograd.grad(out.loss, [apply_t.params[k] for k in names])
    np.testing.assert_allclose(out.loss.item(), float(want_loss), rtol=1e-4)
    for k, g in zip(names, got):
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_options_no_longer_refused():
    """`tpu_flash_attn`, `attn_probs_bf16` and `attn_remat` build; only
    `tensor_axis` is still refused (ROADMAP A.9)."""
    for kw in OPTIONS.values():
        assert all(getattr(DITConfig(**kw), k) for k in kw)
    with pytest.raises(NotImplementedError):
        DITConfig(tensor_axis='model')
