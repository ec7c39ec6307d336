"""The text8 training slice (`entry.text8_train_flagship`, the DiT's
`pallas_attention` route) against `ddg_tpu`:

- the fp32 MDLM loss and every parameter gradient of a tiny text8 DiT at
  L=256 (the tiny run's model, widened to 2 heads of 64 so that JAX's
  attention kernels take it: H * D = 128) equal JAX's `loss_fn` at rtol
  1e-4 on the three attention routes: K1 (`fused_rope_attn`), RoPE then K2
  (`pallas_attention`) and RoPE then the library flash attention
  (`tpu_flash_attn`, K20-K22). JAX runs its Pallas attention and adaLN
  kernels in interpret mode (its own attention kernels through a
  monkeypatch, as `tests/test_torch_dimamba.py` does for the scan; the
  library's under `pltpu.force_tpu_interpret_mode()`); the port its plain
  versions on the CPU;
- `text8_train_flagship(tiny=True, device='cpu')` trains on each route
  and launches nothing on the CPU;
- the full configuration is the JAX bench's text8 line
  (`bench.py:452-491`), checked without building the model.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ddg_tpu import diffusion as jd
from ddg_tpu.models import dit as jdit
from ddg_tpu.models import make_model_apply as jax_model_apply
from ddg_tpu.ops import attention_pallas as jap
from ddg_tpu.ops import forward_process as jfp
from ddg_tpu.ops import noise_schedules as jns
from ddg_tpu_torch import convert as tconvert
from ddg_tpu_torch import diffusion as td
from ddg_tpu_torch import entry
from ddg_tpu_torch.models import DIT, make_model_apply
from ddg_tpu_torch.ops import adaln, attention, flash_attention
from ddg_tpu_torch.runtime.train_state import (init_train_state,
                                               make_eval_step,
                                               make_train_step)

torch.set_num_threads(1)
HID, NB, NH, L, V = 128, 2, 2, 256, entry.TEXT8_VOCAB
B = 2
ROUTES = entry.TEXT8_ROUTES      # the DITConfig flags, the same in JAX's


def jax_cfg(route):
    return jdit.DITConfig(hidden_size=HID, cond_dim=32, length=L,
                          n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                          compute_dtype=jnp.float32, fused_adaln='interpret',
                          **ROUTES[route])


@pytest.fixture(scope='module')
def weights():
    """JAX-initialised params perturbed by seeded noise (flax zero-inits
    the adaLN projections and the head)."""
    params = jax.jit(jdit.DIT(jax_cfg('fused_rope')).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32),
        jnp.ones((1,)))['params']
    r = np.random.RandomState(1)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * r.randn(*p.shape).astype(np.float32),
        params)


@pytest.mark.parametrize('route', list(ROUTES))
def test_loss_and_grads_match_jax(weights, route, monkeypatch):
    for name in ('fused_rope_attention', 'short_seq_attention'):
        monkeypatch.setattr(jap, name, functools.partial(
            getattr(jap, name), interpret=True))
    setup = entry.text8_train_setup(tiny=True, route=route)
    js = jd.DiffusionSpec(noise=jns.LogLinearNoise(),
                          diffusion='absorbing_state',
                          parameterization='subs', vocab_size=V,
                          mask_index=V - 1)
    r = np.random.RandomState(2)
    ids = r.randint(0, V - 1, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    rng = jax.random.PRNGKey(5)
    x0 = jnp.asarray(ids)
    _, loss_rng, _ = jax.random.split(rng, 3)
    t_rng, q_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jfp.sample_t(t_rng, B, sampling_eps=js.sampling_eps)
    xt = jfp.q_xt(q_rng, x0, 1 - jnp.exp(-js.noise(t)[0][:, None]),
                  diffusion=js.diffusion, mask_index=V - 1, vocab_size=V)
    apply_j = jax_model_apply(jdit.DIT(jax_cfg(route)))

    def jloss(p):
        return jd.loss_fn(js, apply_j, p, x0, jnp.asarray(mask), None, rng,
                          train=True).loss

    with (pltpu.force_tpu_interpret_mode() if route == 'flash'
          else contextlib.nullcontext()):
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
            jax.tree.map(jnp.asarray, weights))
    want = tconvert.dit_state_dict_from_jax(
        jax.tree.map(np.asarray, want_grads), n_blocks=NB)

    cfg = dataclasses.replace(setup.cfg, hidden_size=HID, dropout=0.0,
                              compute_dtype=torch.float32)
    m = DIT(cfg)
    m.load_state_dict(tconvert.dit_state_dict_from_jax(weights, n_blocks=NB),
                      strict=True)
    apply_t = make_model_apply(m)
    monkeypatch.setattr(td, 'sample_corruption', lambda *a, **k: (
        torch.tensor(np.asarray(t)), torch.tensor(np.asarray(xt))))
    out = td.loss_fn(setup.spec, apply_t, apply_t.params,
                     torch.from_numpy(ids), torch.from_numpy(mask), None,
                     torch.Generator().manual_seed(0), train=True)
    names = list(apply_t.params)
    got = torch.autograd.grad(out.loss, [apply_t.params[k] for k in names])
    np.testing.assert_allclose(out.loss.item(), float(want_loss), rtol=1e-4)
    for k, g in zip(names, got):
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize('route', list(ROUTES))
def test_tiny_flagship_trains_on_the_cpu(route):
    """Two steps of the tiny run (lr 3e-3 without warmup, one batch of a
    constant token) lower its NLL on that batch, drawn with one fixed
    generator; the CPU takes the plain versions, so no launch is
    counted."""
    counters = (adaln.ln_modulate, adaln.ln_modulate_bwd,
                adaln.gate_res_ln_modulate, adaln.gate_res_ln_modulate_bwd,
                attention.fused_rope_attention,
                attention.fused_rope_attention_bwd,
                attention.short_seq_attention,
                attention.short_seq_attention_bwd,
                flash_attention.flash_attention_fwd,
                flash_attention.flash_attention_bwd_dkv,
                flash_attention.flash_attention_bwd_dq)
    before = [f.launches for f in counters]
    run = entry.text8_train_flagship(device='cpu', tiny=True, route=route)
    assert run.cfg.length == 256 and run.accum_steps == 2
    assert all(getattr(run.cfg, k) == v for k, v in ROUTES[route].items())
    data = run.batch(torch.Generator().manual_seed(0))
    assert tuple(data['input_ids'].shape) == (2, 2, 256)
    assert int(data['input_ids'].max()) < V - 1
    data['input_ids'] = torch.full_like(data['input_ids'], 3)
    optim = dataclasses.replace(run.optim, lr=3e-3, num_warmup_steps=0)
    state = init_train_state(torch.Generator().manual_seed(1),
                             run.apply_fn.params, optim, run.averaging)
    step = make_train_step(run.spec, run.apply_fn, optim, run.averaging,
                           accum_steps=run.accum_steps)
    ev = make_eval_step(run.spec, run.apply_fn, use_averaged=False)
    flat = {k: v.reshape(-1, 256) for k, v in data.items()}

    def nll():
        return ev(state, flat, torch.Generator().manual_seed(9))[
            'nll_sum'].item()

    first = nll()
    for _ in range(2):
        state, metrics = step(state, data)
    assert state.step == 2 and np.isfinite(metrics['loss'].item())
    assert nll() < 0.9 * first
    assert [f.launches for f in counters] == before


def test_full_config_is_the_bench_text8_line():
    """`bench.py:452-491`: DiT-small at L=256, V=35, dropout 0.1, global
    batch 512, absorbing SUBS with mask V - 1, log-linear noise, AdamW
    3e-4 with 2500 warmup, EMA 0.9999; the 'flash' route is the line's
    `--flash-attn` (`bench.py:457-466`: `tpu_flash_attn` alone, without
    the bf16-probs and remat knobs it excludes)."""
    want = jdit.DITConfig(hidden_size=768, cond_dim=128, length=256,
                          n_blocks=12, n_heads=12, dropout=0.1,
                          vocab_size=35)
    for route in ROUTES:
        s = entry.text8_train_setup(route=route)
        for f in ('hidden_size', 'cond_dim', 'length', 'n_blocks',
                  'n_heads', 'dropout', 'vocab_size', 'causal', 'use_adaLN',
                  'num_classes'):
            assert getattr(s.cfg, f) == getattr(want, f), f
        assert s.global_batch == 512
        assert 512 % s.micro_batch == 0
        assert s.cfg.compute_dtype == torch.bfloat16
        assert s.cfg.logits_dtype == torch.float32
        assert s.cfg.fused_adaln
        assert s.cfg.fused_rope_attn == (route == 'fused_rope')
        assert s.cfg.pallas_attention == (route == 'short_seq')
        assert s.cfg.tpu_flash_attn == (route == 'flash')
        assert not s.cfg.attn_probs_bf16 and not s.cfg.attn_remat
        assert (s.spec.diffusion, s.spec.parameterization) == (
            'absorbing_state', 'subs')
        assert (s.spec.vocab_size, s.spec.mask_index) == (35, 34)
        assert type(s.spec.noise).__name__ == 'LogLinearNoise'
        assert not s.spec.time_conditioning       # scripts/train_text8.sh
        assert (s.optim.lr, s.optim.num_warmup_steps) == (3e-4, 2500)
        assert s.averaging.decay == 0.9999
    assert set(ROUTES) == {'fused_rope', 'short_seq', 'flash'}
    with pytest.raises(ValueError):
        entry.text8_train_setup(route='sdpa')
