"""The port's DiMamba (`ddg_tpu_torch.models.dimamba`) and the Species10
serving slice against `ddg_tpu` on the same weights, at the size of
`entry.dimamba_flagship(tiny=True)` (hidden 32, cond_dim 16, 2 blocks,
L=256 as two scan chunks of 128, d_state 16, V=12, 10 classes).

The weights are the reference layout's seeded random ones (non-zero adaLN
projections, so every gate is open), matrices scaled up so the mixer
moves the logits, carried into JAX by `ddg_tpu.convert` and into the port
by `convert.dimamba_state_dict_from_jax`.

- float32 logits equal the flax DiMamba's to the 1e-3 per-step bar of
  BASELINE.md on the three routes of a direction: the fused block (JAX's
  K18 in interpret mode, the port's plain version), the unfused chain
  around the scan kernel (JAX's K14 in interpret mode) and the plain scan;
  zeroing the mixers' out_proj moves the logits far past that bar, so the
  mixer is tested;
- the converters agree with `ddg_tpu.convert` and load strictly;
- one fused D-CFG step (gamma 2, K10's plain version) gives the tokens of
  the unfused chain (log-posterior interpolation, softmax, Gumbel-max)
  from the same uniforms, wherever the top-two scores differ by > 1e-4;
- whole sampling loops through `dimamba_flagship(tiny=True)` return DNA
  vocabulary tokens.
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
from ddg_tpu.models import dimamba as jdm
from ddg_tpu_torch import convert
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.entry import dimamba_flagship
from ddg_tpu_torch.models import DiMamba, DiMambaConfig, make_model_apply
from ddg_tpu_torch.models.dimamba import resolve_route
from ddg_tpu_torch.ops import fused_sampling as tfs
from ddg_tpu_torch.ops import sampling as tsamp

torch.set_num_threads(1)
HID, COND, BLOCKS, V, NC, L = 32, 16, 2, 12, 10, 256
GAMMA = 2.0
ATOL = 1e-3
SMALL = dict(hidden_size=HID, cond_dim=COND, length=L, n_blocks=BLOCKS,
             vocab_size=V, num_classes=NC, d_state=16, scan_chunk=128,
             scan_seg=64, scan_seg_bwd=64, dropout=0.0)
ROUTES = {
    'fused_block': dict(fused_block=True),
    'scan_kernel': dict(fused_block=False, pallas_scan=True),
    'plain_scan': dict(fused_block=False, pallas_scan=False),
}


@pytest.fixture(scope='module')
def reference():
    """Reference-layout weights; matrices x4 so the mixer matters."""
    s = convert.make_reference_dimamba_state_dict(
        np.random.RandomState(0), hidden=HID, cond_dim=COND,
        n_blocks=BLOCKS, vocab=V, num_classes=NC)
    return {k: v * 4 if v.ndim >= 2 and 'A_log' not in k else v
            for k, v in s.items()}


@pytest.fixture(scope='module')
def params(reference):
    return jconvert.convert_dimamba_params(reference, n_blocks=BLOCKS)


@pytest.fixture(scope='module')
def inputs():
    r = np.random.RandomState(2)
    return (r.randint(0, V, (3, L)).astype(np.int32),
            r.uniform(0, 1, 3).astype(np.float32),
            np.array([0, 7, NC], np.int32))     # NC is the null class


def port_model(params, **kw):
    m = DiMamba(DiMambaConfig(**SMALL, compute_dtype=torch.float32, **kw))
    m.load_state_dict(convert.dimamba_state_dict_from_jax(
        params, n_blocks=BLOCKS), strict=True)
    return m.eval()


def jax_logits(params, inputs, route, monkeypatch):
    # The unfused JAX module calls selective_scan_pallas without an
    # interpret switch: hand it one, as tests/test_convert_parity_dimamba.py
    # does.
    monkeypatch.setattr(jsp, 'selective_scan_pallas', functools.partial(
        jsp.selective_scan_pallas, interpret=True))
    cfg = jdm.DiMambaConfig(**SMALL, compute_dtype=jnp.float32,
                            pallas_interpret=True, **ROUTES[route])
    fn = jax.jit(lambda p, x, s, c: jdm.DiMamba(cfg).apply(
        {'params': p}, x, s, c))
    return np.asarray(fn(jax.tree.map(jnp.asarray, params), *inputs))


@pytest.mark.parametrize('route', list(ROUTES))
def test_float32_logits_match_jax(params, inputs, route, monkeypatch):
    want = jax_logits(params, inputs, route, monkeypatch)
    m = port_model(params, **ROUTES[route])
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in inputs))
    assert got.dtype == torch.float32 and got.shape == (3, L, V)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_the_mixer_moves_the_logits(params, inputs):
    """Zeroing every out_proj (both directions share it) leaves the
    residual stream alone: the logits must move by far more than the
    parity bar, or the parity tests would not see the mixer."""
    args = [torch.from_numpy(a) for a in inputs]
    m = port_model(params, fused_block=True)
    with torch.no_grad():
        full = m(*args)
        for i in range(BLOCKS):
            getattr(m, f'block_{i}').mixer.out_proj_fwd.weight.zero_()
        cut = m(*args)
    assert (full - cut).abs().max() > 100 * ATOL


@pytest.mark.parametrize('tie', [True, False], ids=['tied', 'untied'])
def test_converters_agree_with_ddg_tpu(tie):
    """The port's reference-layout draw equals ddg_tpu's for a 2-class
    model; its reference -> params converter equals ddg_tpu's, tied and
    untied; the state dict loads strictly into the port's module."""
    kw = dict(hidden=HID, cond_dim=COND, n_blocks=BLOCKS, vocab=V,
              weight_tie=tie)
    ref = convert.make_reference_dimamba_state_dict(
        np.random.RandomState(5), num_classes=2, **kw)
    jref = jconvert.make_reference_dimamba_state_dict(
        np.random.RandomState(5), with_cond=True, **kw)
    assert set(ref) == set(jref)
    for k in ref:
        np.testing.assert_array_equal(ref[k], jref[k])
    ours = convert.dimamba_params_from_reference(ref, n_blocks=BLOCKS,
                                                 weight_tie=tie)
    theirs = jconvert.convert_dimamba_params(ref, n_blocks=BLOCKS,
                                             weight_tie=tie)
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(theirs))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, b)
    sd = convert.dimamba_state_dict_from_jax(theirs, n_blocks=BLOCKS)
    m = DiMamba(DiMambaConfig(**dict(SMALL, num_classes=2),
                              bidirectional_weight_tie=tie,
                              compute_dtype=torch.float32))
    assert set(sd) == set(m.state_dict())
    m.load_state_dict(sd, strict=True)
    mix = m.block_1.mixer
    np.testing.assert_array_equal(
        mix.core_rev.conv1d_kernel.detach().numpy(),
        theirs['block_1']['mixer']['core_rev']['conv1d_kernel'])
    np.testing.assert_array_equal(
        mix.in_proj_fwd.weight.detach().numpy(),
        theirs['block_1']['mixer']['in_proj_fwd']['kernel'].T)
    np.testing.assert_array_equal(
        m.sigma_map.mlp[2].weight.detach().numpy(),
        theirs['sigma_map']['mlp2']['kernel'].T)
    assert hasattr(mix, 'in_proj_rev') is not tie
    with pytest.raises(ValueError, match='blocks'):
        convert.dimamba_state_dict_from_jax(theirs, n_blocks=BLOCKS + 1)


def test_fused_cfg_step_matches_the_unfused_chain(params, monkeypatch):
    """The port's `_cfg_step` twice from the same x_t, sigma and uniforms
    U: the fused branch forced on the CPU (K10's plain version, Gumbel
    g = -log(1e-10 - log(U + 1e-10))) and the unfused chain, whose
    Gumbel-max divides the probabilities by 1e-10 - log(U + 1e-10). The
    fused branch reads the logits in bf16, so the unfused one is handed
    the same bf16-rounded logits."""
    B = 2
    r = np.random.RandomState(3)
    t = torch.from_numpy
    xt = t(r.randint(0, V, (B, L)).astype(np.int32))
    sigma = t(r.uniform(0.1, 2.0, B).astype(np.float32))
    mct = (1 - torch.exp(-sigma))[:, None, None]
    mcs = 0.6 * mct
    cond = torch.tensor([3, 8], dtype=torch.int32)
    U = t(r.uniform(size=(B, L, V)).astype(np.float32))
    g = -torch.log(1e-10 - torch.log(U + 1e-10))
    spec = dimamba_flagship(tiny=True, device='cpu')[0]
    apply = make_model_apply(port_model(params, fused_block=True))

    def bf16_logits(*args, **kw):
        return apply(*args, **kw).to(torch.bfloat16).float()

    seen = {}

    def with_noise(seed, xt_, lc, lu, gamma, a_t, a_s, *, vocab_size):
        seen['args'] = (lc, lu, a_t, a_s)
        return tfs.fused_uniform_cfg_sample(seed, xt_, lc, lu, gamma, a_t,
                                            a_s, vocab_size=vocab_size,
                                            gumbel=g)

    def step(fused):
        return TS._cfg_step(
            spec, TS.SamplerSpec(fused=fused, use_cache=False),
            TS.GuidanceSpec(method='cfg', gamma=GAMMA), bf16_logits,
            apply.params,
            torch.Generator().manual_seed(0), xt, sigma, mct, mcs, cond,
            None, None)[0]

    monkeypatch.setattr(TS, '_fused_ok',
                        lambda spec, sampler, guidance, xt: sampler.fused)
    monkeypatch.setattr(TS, 'fused_uniform_cfg_sample', with_noise)
    monkeypatch.setattr(tsamp, 'sample_categorical', functools.partial(
        tsamp.sample_categorical, u=U))
    fused, unfused = step(True), step(False)
    lc, lu, a_t, a_s = seen['args']
    scores = tfs.uniform_perturbed_scores(
        0, tfs.uniform_cfg_log_num(lc, lu, GAMMA, xt, a_t, a_s,
                                   vocab_size=V), vocab_size=V, gumbel=g)
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 1e-4
    assert decided.float().mean() > 0.9
    assert fused.dtype == torch.int32 and fused.shape == (B, L)
    np.testing.assert_array_equal(fused[decided].numpy(),
                                  unfused[decided].numpy())


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
@pytest.mark.parametrize('guided', [False, True], ids=['unguided', 'dcfg'])
def test_sampling_loop_gives_dna_tokens(fused, guided, monkeypatch):
    """`dimamba_flagship(tiny=True)` on the CPU: the unfused chain, and the
    fused branch forced (K9/K10's plain versions)."""
    if fused:
        monkeypatch.setattr(TS, '_fused_ok',
                            lambda spec, sampler, guidance, xt: sampler.fused)
    spec, cfg, _, apply_fn, params = dimamba_flagship(tiny=True,
                                                      device='cpu')
    assert (spec.vocab_size, spec.mask_index, cfg.num_classes) == (12, 3, 10)
    assert spec.time_conditioning and cfg.compute_dtype == torch.bfloat16
    kw = {}
    if guided:
        kw = dict(guidance=TS.GuidanceSpec(method='cfg', gamma=GAMMA),
                  cond=torch.tensor([1, 9], dtype=torch.int32))
    x = TS.diffusion_sample(
        spec, TS.SamplerSpec(steps=3, use_cache=False, fused=fused),
        apply_fn, params, torch.Generator().manual_seed(4), batch_size=2,
        length=cfg.length, **kw)
    assert x.dtype == torch.int32 and x.shape == (2, L)
    assert ((x >= 0) & (x < V)).all()


def test_unported_settings_raise():
    for name in ('remat',):
        with pytest.raises(NotImplementedError):
            DiMambaConfig(**{name: True})
    assert DiMambaConfig(dt_inkernel=True).dt_inkernel    # ported (K16)
    with pytest.raises(NotImplementedError):
        DiMambaConfig(sequence_axis='tensor')
    with pytest.raises(ValueError, match='interpret'):
        DiMambaConfig(pallas_interpret=True)
    m = DiMamba(DiMambaConfig(**SMALL))
    with pytest.raises(ValueError, match='constraints'):
        m2 = DiMamba(dataclasses.replace(m.cfg, fused_block=True,
                                         length=200))
        m2(torch.zeros((1, 200), dtype=torch.int32), torch.zeros(1))


# d_conv, d_state -> the route 'auto' takes on the card, as the JAX module
# takes it on the TPU (the fused block: L on the chunk grid, d_conv <= 8).
# K18/K19 take d_conv 3 (as 4 with a zero tap) and d_state 32 (two groups
# of 16 states) on the card, as the TPU kernels do.
AUTO_ROUTES = [(4, 16, 'fused_block'), (3, 16, 'fused_block'),
               (4, 32, 'fused_block'), (3, 32, 'fused_block')]


@pytest.mark.parametrize('d_conv,d_state,want', AUTO_ROUTES)
def test_auto_route_follows_the_kernels_limits(d_conv, d_state, want):
    """The resolution is a pure function of (cfg, L, on_card): 'auto'
    follows the JAX module's choice, off the card 'auto' is the plain
    scan, and on the card a shape the chosen kernel does not take raises
    rather than run the plain scan there. `dt_inkernel` takes the
    dt-lowrank scan where the JAX module takes it: never in place of the
    fused block, and the dense scan kernel where L is off the chunk grid."""
    cfg = DiMambaConfig(**dict(SMALL, d_conv=d_conv, d_state=d_state))
    assert resolve_route(cfg, L, on_card=True) == want
    assert resolve_route(cfg, L, on_card=False) == 'plain_scan'
    # L off the chunk grid: the scan kernel, as in JAX.
    assert resolve_route(cfg, L - 1, on_card=True) == 'scan_kernel'
    fused = dataclasses.replace(cfg, fused_block=True)
    for on_card in (False, True):
        assert resolve_route(fused, L, on_card=on_card) == 'fused_block'
    scan = dataclasses.replace(cfg, fused_block=False, pallas_scan=True)
    for on_card in (False, True):
        assert resolve_route(scan, L, on_card=on_card) == 'scan_kernel'
    plain = dataclasses.replace(cfg, pallas_scan=False)
    assert resolve_route(plain, L, on_card=True) == 'plain_scan'
    # dt_inkernel: the fused block still wins where 'auto' takes it.
    dtlr = dataclasses.replace(cfg, dt_inkernel=True)
    assert resolve_route(dtlr, L, on_card=True) == 'fused_block'
    assert resolve_route(dtlr, L, on_card=False) == 'plain_scan'
    unfused = dataclasses.replace(dtlr, fused_block=False)
    assert resolve_route(unfused, L, on_card=True) == 'scan_kernel_dtlr'
    assert resolve_route(unfused, L - 1, on_card=True) == 'scan_kernel'
    assert resolve_route(dataclasses.replace(unfused, pallas_scan=True), L,
                         on_card=False) == 'scan_kernel_dtlr'
    assert resolve_route(dataclasses.replace(unfused, pallas_scan=False), L,
                         on_card=True) == 'plain_scan'
    # d_conv 5-8 take the fused block on the card as on the TPU; 9 fails
    # the JAX constraint and takes the scan kernel.
    for taps in (5, 8):
        assert resolve_route(dataclasses.replace(cfg, d_conv=taps), L,
                             on_card=True) == 'fused_block'
    assert resolve_route(dataclasses.replace(cfg, d_conv=9), L,
                         on_card=True) == 'scan_kernel'
    # Every route takes any d_state on the card (each scan pass stages one
    # group of 16 states at a time), and the dt-lowrank scan dt_rank 65.
    big = dataclasses.replace(cfg, d_state=176)
    assert resolve_route(big, L, on_card=True) == 'fused_block'
    assert resolve_route(dataclasses.replace(big, fused_block=False), L,
                         on_card=True) == 'scan_kernel'
    assert resolve_route(dataclasses.replace(big, fused_block=False,
                                             dt_inkernel=True), L,
                         on_card=True) == 'scan_kernel_dtlr'
    # Every route takes any chunk, and the fused block any dt_rank: chunk
    # 384 past 16 states (the forward scan's shared memory is the same for
    # every chunk), dt_rank 65 at hidden 1040.
    long = dataclasses.replace(cfg, d_state=32, scan_chunk=384)
    assert resolve_route(long, 768, on_card=True) == 'fused_block'
    assert resolve_route(dataclasses.replace(long, fused_block=False), 768,
                         on_card=True) == 'scan_kernel'
    assert resolve_route(dataclasses.replace(long, fused_block=False,
                                             dt_inkernel=True), 768,
                         on_card=True) == 'scan_kernel_dtlr'
    wide = dataclasses.replace(cfg, hidden_size=1040)
    assert resolve_route(wide, L, on_card=True) == 'fused_block'
    assert resolve_route(dataclasses.replace(wide, fused_block=False,
                                             dt_inkernel=True), L,
                         on_card=True) == 'scan_kernel_dtlr'
    # What the card's kernels still refuse raises, naming the kernel: a
    # hidden off the products' rows (1036: d_inner 2072 is not a multiple
    # of 16) on the fused block. The dt-lowrank scan takes every dt_rank
    # (K16 and K17 stage W_dt and dt_lr in rank tiles): 190 past 16 states
    # (hidden 3040) and 361 (hidden 5776), which it once refused.
    wider = dataclasses.replace(cfg, hidden_size=3040, d_state=32,
                                fused_block=False, dt_inkernel=True)
    assert resolve_route(wider, L, on_card=True) == 'scan_kernel_dtlr'
    with pytest.raises(ValueError, match='K18/K19'):
        resolve_route(dataclasses.replace(cfg, hidden_size=1036), L,
                      on_card=True)
    widest = dataclasses.replace(cfg, hidden_size=5776, fused_block=False,
                                 dt_inkernel=True)
    assert resolve_route(widest, L, on_card=True) == 'scan_kernel_dtlr'
    assert resolve_route(dataclasses.replace(widest, dt_inkernel=False), L,
                         on_card=True) == 'scan_kernel'


def test_auto_route_on_a_refused_shape_runs_on_the_cpu():
    """A model of a shape past the Species10 one (d_conv 3, d_state 32),
    which the card's widened kernels take, builds and runs on the CPU with
    the default 'auto' flags (the plain scan there)."""
    cfg = DiMambaConfig(**dict(SMALL, d_conv=3, d_state=32,
                               compute_dtype=torch.float32))
    m = DiMamba(cfg).eval()
    x = torch.randint(0, V, (1, L))
    with torch.no_grad():
        out = m(x, torch.ones(1), torch.zeros(1, dtype=torch.int32))
    assert out.shape == (1, L, V) and bool(torch.isfinite(out).all())
