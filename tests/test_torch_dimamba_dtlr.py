"""The Species10 DiMamba's dt-lowrank route ('scan_kernel_dtlr': the unfused
chain around K16/K17, `dt_inkernel=True, fused_block=False`) against
`ddg_tpu`'s `DiMamba(dt_inkernel=True, fused_block=False)`, at the size of
`dimamba_flagship(tiny=True)` (hidden 32, cond_dim 16, 2 blocks, L=256 as
two scan chunks, d_state 16, V=12, 10 classes), JAX's
`selective_scan_pallas_dtlr` (and, for the dense route,
`selective_scan_pallas`) handed `interpret=True` by monkeypatching, as
`tests/test_convert_parity_dimamba.py` does.

- One converted state dict gives JAX's float32 logits on the dt-lowrank
  and the dense scan-kernel routes alike, to the 1e-3 bar of
  `test_torch_dimamba.py`: JAX registers dt_proj by a one-row probe, so
  the parameter tree is the same.
- The fp32 UDLM loss and every gradient equal JAX's `loss_fn` on JAX's draw
  of (t, x_t), to rtol 1e-5 (loss) and rtol 1e-4 with atol 1e-4 of each
  gradient's largest magnitude (`test_torch_dimamba_train.py`'s bars).
- The tiny flagships take the route on the CPU (the kernels' plain
  versions), sample and train, and launch nothing.
"""

import dataclasses
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
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.entry import dimamba_flagship, dimamba_train_flagship
from ddg_tpu_torch.models import DiMamba, DiMambaConfig, make_model_apply
from ddg_tpu_torch.models.dimamba import resolve_route
from ddg_tpu_torch.ops import mamba
from ddg_tpu_torch.ops import noise_schedules as tns

torch.set_num_threads(1)
HID, COND, BLOCKS, V, NC, L, B = 32, 16, 2, 12, 10, 256, 3
SMALL = dict(hidden_size=HID, cond_dim=COND, length=L, n_blocks=BLOCKS,
             vocab_size=V, num_classes=NC, d_state=16, scan_chunk=128,
             scan_seg=64, scan_seg_bwd=64, dropout=0.0)
DTLR = dict(fused_block=False, pallas_scan=True, dt_inkernel=True)
DENSE = dict(fused_block=False, pallas_scan=True)
COUNTERS = (mamba.mamba_inner, mamba.mamba_inner_bwd, mamba.ssm_scan,
            mamba.ssm_scan_bwd, mamba.ssm_scan_dtlr, mamba.ssm_scan_dtlr_bwd)


@pytest.fixture(scope='module')
def params():
    """Reference-layout weights, matrices x4 so the mixer matters."""
    s = convert.make_reference_dimamba_state_dict(
        np.random.RandomState(0), hidden=HID, cond_dim=COND,
        n_blocks=BLOCKS, vocab=V, num_classes=NC)
    s = {k: v * 4 if v.ndim >= 2 and 'A_log' not in k else v
         for k, v in s.items()}
    return jconvert.convert_dimamba_params(s, n_blocks=BLOCKS)


def _interpret(monkeypatch):
    for name in ('selective_scan_pallas', 'selective_scan_pallas_dtlr'):
        monkeypatch.setattr(jsp, name, functools.partial(getattr(jsp, name),
                                                         interpret=True))


def _port(params, flags):
    m = DiMamba(DiMambaConfig(**SMALL, compute_dtype=torch.float32, **flags))
    m.load_state_dict(convert.dimamba_state_dict_from_jax(
        params, n_blocks=BLOCKS), strict=True)
    return m


def test_one_state_dict_gives_jax_logits_on_both_routes(params, monkeypatch):
    _interpret(monkeypatch)
    r = np.random.RandomState(2)
    inputs = (r.randint(0, V, (B, L)).astype(np.int32),
              r.uniform(0, 1, B).astype(np.float32),
              np.array([0, 7, NC], np.int32))
    want = {}
    for name, flags in (('dtlr', DTLR), ('dense', DENSE)):
        cfg = jdm.DiMambaConfig(**SMALL, compute_dtype=jnp.float32,
                                pallas_interpret=True, **flags)
        fn = jax.jit(lambda p, x, s, c, cfg=cfg: jdm.DiMamba(cfg).apply(
            {'params': p}, x, s, c))
        want[name] = np.asarray(fn(jax.tree.map(jnp.asarray, params),
                                   *inputs))
    args = [torch.from_numpy(a) for a in inputs]
    for name, flags in (('dtlr', DTLR), ('dense', DENSE)):
        m = _port(params, flags).eval()
        with torch.no_grad():
            got = m(*args).numpy()
        for ref in want.values():
            np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert resolve_route(_port(params, DTLR).cfg, L, on_card=False) \
        == 'scan_kernel_dtlr'


def test_float32_loss_and_grads_match_jax(params, monkeypatch):
    _interpret(monkeypatch)
    kw = dict(diffusion='uniform', parameterization='d3pm', vocab_size=V,
              mask_index=3, num_classes=NC, time_conditioning=True,
              zero_recon_loss=True, antithetic_sampling=True,
              sampling_eps=1e-3)
    js = jd.DiffusionSpec(noise=jns.LogLinearNoise(), **kw)
    ts = td.DiffusionSpec(noise=tns.LogLinearNoise(), **kw)
    r = np.random.RandomState(2)
    x0 = r.randint(7, 12, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    cond = np.array([0, 4, 9], np.int32)
    rng = jax.random.PRNGKey(5)
    _, loss_rng, _ = jax.random.split(rng, 3)
    t_rng, q_rng, _, _, _ = jax.random.split(loss_rng, 5)
    t = jfp.sample_t(t_rng, B, sampling_eps=js.sampling_eps)
    xt = jfp.q_xt(q_rng, jnp.asarray(x0),
                  1 - jnp.exp(-js.noise(t)[0][:, None]),
                  diffusion='uniform', mask_index=3, vocab_size=V)
    jcfg = jdm.DiMambaConfig(**SMALL, compute_dtype=jnp.float32,
                             pallas_interpret=True, **DTLR)
    apply_j = jax_model_apply(jdm.DiMamba(jcfg))

    def jloss(p):
        return jd.loss_fn(js, apply_j, p, jnp.asarray(x0), jnp.asarray(mask),
                          jnp.asarray(cond), rng, train=True).loss

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params))
    want = convert.dimamba_state_dict_from_jax(
        jax.tree.map(np.asarray, want_grads), n_blocks=BLOCKS)
    apply_t = make_model_apply(_port(params, DTLR))
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
        if g is None:            # no path to the loss
            assert not w.any(), k
            continue
        assert tuple(g.shape) == w.shape, k
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_tiny_flagships_take_the_route_on_the_cpu(monkeypatch):
    """Both entry points with route='dt_lowrank' on the CPU: the route
    resolves to 'scan_kernel_dtlr' (K16/K17's plain versions run, as the
    spies see), a guided sampling loop returns DNA tokens, training steps
    are finite, and no kernel launch is counted."""
    before = [f.launches for f in COUNTERS]
    calls = []
    fwd = mamba.ssm_scan_dtlr_plain
    monkeypatch.setattr(mamba, 'ssm_scan_dtlr_plain',
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    spec, cfg, _, apply_fn, params = dimamba_flagship(
        tiny=True, device='cpu', route='dt_lowrank')
    assert resolve_route(cfg, cfg.length, on_card=False) == 'scan_kernel_dtlr'
    x = TS.diffusion_sample(
        spec, TS.SamplerSpec(steps=2, use_cache=False, fused=False),
        apply_fn, params, torch.Generator().manual_seed(4), batch_size=2,
        length=cfg.length, guidance=TS.GuidanceSpec(method='cfg', gamma=2.0),
        cond=torch.tensor([1, 9], dtype=torch.int32))
    assert x.dtype == torch.int32 and x.shape == (2, L)
    assert ((x >= 0) & (x < V)).all()
    # steps x blocks x directions (CFG runs both halves as one batch)
    assert len(calls) == 2 * BLOCKS * 2
    run = dimamba_train_flagship(device='cpu', tiny=True, route='dt_lowrank')
    assert run.accum_steps == 2 and run.cfg.dt_inkernel
    batch = run.batch(torch.Generator().manual_seed(0))
    _, metrics = run.step(run.state, batch)
    assert all(np.isfinite(v.item()) for v in metrics.values())
    assert [f.launches for f in COUNTERS] == before
    with pytest.raises(ValueError, match='route'):
        dimamba_flagship(tiny=True, device='cpu', route='fused')


def test_dt_rank_300_matches_jax_logits(monkeypatch):
    """The dt-lowrank route at dt_rank 300, past the ranks the first K17
    design held (248), with a tiny L and d_inner: both configurations
    derive dt_rank from the hidden size (ceil(H / 16)), so a subclass of
    each pins it at 300 for hidden 32 (d_inner 64); JAX initialises the
    weights (x_proj's 300 + 2 d_state columns, dt_proj's 300 rows, x4 so
    the mixer matters), and the port's float32 logits on the converted
    state dict equal JAX's to the 1e-3 bar above. The port runs K16/K17's
    plain versions here; `chip_smoke.py` holds the kernels against them at
    dt_rank 300 and 512."""
    _interpret(monkeypatch)
    rank, Lr, blocks = 300, 64, 1

    @dataclasses.dataclass(frozen=True)
    class JCfg(jdm.DiMambaConfig):
        dt_rank = property(lambda self: rank)

    @dataclasses.dataclass(frozen=True)
    class TCfg(DiMambaConfig):
        dt_rank = property(lambda self: rank)

    small = dict(SMALL, length=Lr, n_blocks=blocks, scan_chunk=32)
    jcfg = JCfg(**small, compute_dtype=jnp.float32, pallas_interpret=True,
                **DTLR)
    r = np.random.RandomState(3)
    x = r.randint(0, V, (B, Lr)).astype(np.int32)
    sigma = r.uniform(0, 1, B).astype(np.float32)
    cond = np.array([0, 7, NC], np.int32)
    model = jdm.DiMamba(jcfg)
    params = model.init(jax.random.PRNGKey(1), x, sigma, cond)['params']
    params = jax.tree.map(lambda a: a * 4 if a.ndim >= 2 else a, params)
    x_proj = [a for p, a in jax.tree_util.tree_leaves_with_path(params)
              if 'x_proj' in jax.tree_util.keystr(p)]
    assert x_proj and all(a.shape[-1] == rank + 2 * 16 for a in x_proj)
    want = np.asarray(jax.jit(lambda p: model.apply({'params': p}, x, sigma,
                                                    cond))(params))
    m = DiMamba(TCfg(**small, compute_dtype=torch.float32, **DTLR))
    m.load_state_dict(convert.dimamba_state_dict_from_jax(
        jax.tree.map(np.array, params), n_blocks=blocks), strict=True)
    assert m.cfg.dt_rank == rank
    assert resolve_route(m.cfg, Lr, on_card=False) == 'scan_kernel_dtlr'
    assert resolve_route(m.cfg, Lr, on_card=True) == 'scan_kernel_dtlr'
    with torch.no_grad():
        got = m.eval()(*(torch.from_numpy(a) for a in (x, sigma, cond)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
