"""The plain versions of K20-K22 (`ddg_tpu_torch.ops.flash_attention`)
against the library flash attention they port,
`jax.experimental.pallas.ops.tpu.flash_attention`, run on the CPU under
`pltpu.force_tpu_interpret_mode()` (nothing in `ddg_tpu` changes):

- the forward's o and its saved l and m, and dq, dk, dv of `jax.vjp`,
  at B=1, H=2, L in {128 (the single-step kernel), 384 (three key blocks)},
  D in {32, 64}, causal and not; fp32 to 1e-5 of the largest magnitude,
  bf16 to 2 ulp of it with at most 1% of the elements differing at all;
- the plain K21 on its own, forming di from the forward's o: dk and dv
  against the library's VJP at L=384, di equal to `output_grad_dot`;
- a negative control: `ops.attention.attention_plain` (normalise, then
  round) fails that bf16 share bar at L=384, so the bar sees where p is
  rounded;
- the library's refusals (L=64, L=200, and D=160 past one key block) raise
  the same exception types in the port;
- the CPU runs the plain versions and launches nothing.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from ddg_tpu_torch.ops import attention
from ddg_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)
DTYPES = {'float32': (torch.float32, jnp.float32),
          'bfloat16': (torch.bfloat16, jnp.bfloat16)}
SHARE_BAR = 0.01


def _inputs(L, D, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((1, L, 2, D)).astype(np.float32)
            for _ in range(4)]


def _to_jax(a, jdt):
    return jnp.asarray(a, jdt).swapaxes(1, 2)          # (B, H, L, D)


def _to_torch(a, dt):
    a = np.asarray(jnp.asarray(a, jnp.float32))
    return torch.from_numpy(np.ascontiguousarray(a)).to(dt)


def library(q, k, v, do, causal, jdt):
    """o, l, m of the library's forward and dq, dk, dv of its VJP, all
    as torch tensors in the model's (B, L, H, D) layout ((B, H, L) for l
    and m), run in interpret mode."""
    sc = 1.0 / math.sqrt(q.shape[-1])
    blocks = lib.BlockSizes.get_default(*q.shape[:1], 2, q.shape[1],
                                        q.shape[1], q.shape[-1])
    jq, jk, jv, jdo = (_to_jax(a, jdt) for a in (q, k, v, do))

    def run(jq, jk, jv, jdo):
        o, l, m = lib._flash_attention(jq, jk, jv, None, None, True, causal,
                                       sc, blocks, False)
        _, vjp = jax.vjp(lambda a, b, c: lib.flash_attention(
            a, b, c, causal=causal, sm_scale=sc), jq, jk, jv)
        return (o, l, m), vjp(jdo)

    # One jitted call, waited for before anything else is dispatched: the
    # interpret mode's io_callbacks dispatch jnp operations of their own,
    # which can deadlock behind work queued on the kernel's outputs
    # (tests/test_torch_dit_attention_options.py:jax_logits).
    with pltpu.force_tpu_interpret_mode():
        (o, l, m), grads = jax.block_until_ready(
            jax.jit(run)(jq, jk, jv, jdo))
    dt = torch.float32 if jdt == jnp.float32 else torch.bfloat16
    return ([_to_torch(x.swapaxes(1, 2), dt) for x in (o, *grads)],
            [_to_torch(x, torch.float32) for x in (l, m)])


def bf16_tol(ref):
    m = ref.float().abs().max().item()
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def close(name, got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5 * want.abs().max().item(), (name, err)
        return
    assert err <= bf16_tol(want), (name, err, bf16_tol(want))
    share = (got != want).float().mean().item()
    assert share <= SHARE_BAR, (name, share)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('D', [32, 64])
@pytest.mark.parametrize('L', [128, 384])
def test_plain_matches_library(L, D, causal, dtype):
    dt, jdt = DTYPES[dtype]
    q, k, v, do = _inputs(L, D, seed=L + D)
    (o, dq, dk, dv), (l, m) = library(q, k, v, do, causal, jdt)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dt) for a in (q, k, v, do))
    sc = 1.0 / math.sqrt(D)
    got_o, got_l, got_m = fa.flash_attention_fwd_plain(
        tq, tk, tv, causal=causal, sm_scale=sc)
    close('o', got_o, o, dt)
    for name, a, b in (('l', got_l, l), ('m', got_m, m)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name
    qq, kk, vv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    out = fa.flash_attention(qq, kk, vv, causal=causal, sm_scale=sc)
    assert torch.equal(out, got_o)
    grads = torch.autograd.grad(out, (qq, kk, vv), tdo)
    for name, a, b in zip(('dq', 'dk', 'dv'), grads, (dq, dk, dv)):
        close(name, a, b, dt)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('causal', [False, True])
def test_plain_k21_forms_di_and_matches_library(causal, dtype):
    """K21's plain version takes the forward's o in place of di (as the
    kernel does), returns di = output_grad_dot(o, do) beside dk and dv, and
    its dk and dv match the library's VJP."""
    dt, jdt = DTYPES[dtype]
    q, k, v, do = _inputs(384, 64, seed=21 + causal)
    (o, _, dk, dv), (l, m) = library(q, k, v, do, causal, jdt)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dt) for a in (q, k, v, do))
    calls = fa.output_grad_dot.calls
    got_dk, got_dv, di = fa.flash_attention_bwd_dkv(
        tq, tk, tv, l, m, tdo, o, causal=causal, sm_scale=1.0 / 8)
    assert fa.output_grad_dot.calls == calls + 1
    assert di.shape == (1, 2, 384) and di.dtype == torch.float32
    assert torch.equal(di, fa.output_grad_dot(o, tdo))
    for name, a, b in (('dk', got_dk, dk), ('dv', got_dv, dv)):
        close(name, a, b, dt)


def test_normalise_then_round_fails_the_share_bar():
    """K2's plain version rounds p after normalising it; the library rounds
    the unnormalised p of each key block. At L=384 in bf16 the two differ in
    far more than SHARE_BAR of the outputs, while the port's plain K20 stays
    under it (test_plain_matches_library)."""
    q, k, v, do = _inputs(384, 64, seed=448)
    (o, *_), _ = library(q, k, v, do, False, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    plain = attention.attention_plain(tq, tk, tv)
    assert (plain.float() - o.float()).abs().max() <= bf16_tol(o)
    assert (plain != o).float().mean().item() > SHARE_BAR


@pytest.mark.parametrize('L, D', [(64, 32), (200, 32), (256, 160)])
def test_refusals_match_the_library(L, D):
    q = np.random.default_rng(0).standard_normal((1, L, 1, D)).astype(
        np.float32)
    with pytest.raises((ValueError, NotImplementedError)) as want:
        with pltpu.force_tpu_interpret_mode():
            jq = _to_jax(q, jnp.float32)
            lib.flash_attention(jq, jq, jq, sm_scale=0.1)
    t = torch.from_numpy(q)
    with pytest.raises(want.type):
        fa.flash_attention(t, t, t, sm_scale=0.1)
    z = torch.zeros((1, 1, L))
    with pytest.raises(want.type):
        fa.flash_attention_bwd_dq(t, t, t, z, z, t, z, sm_scale=0.1)


def test_one_key_block_takes_any_head_width():
    """The library's single-step kernel (L = 128) has no head-width check:
    D=160 runs there, and the port takes it too."""
    q = torch.from_numpy(_inputs(128, 160, seed=1)[0])
    o, l, m = fa.flash_attention_fwd(q, q, q, sm_scale=0.1)
    assert o.shape == q.shape and l.shape == (1, 2, 128)


def test_cpu_runs_the_plain_versions_and_launches_nothing():
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dkv,
                fa.flash_attention_bwd_dq)
    before = [(w.launches, w.tensor_core_launches) for w in wrappers]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(256, 32, seed=7))
    qq = q.clone().requires_grad_()
    out = fa.flash_attention(qq, k, v, causal=True, sm_scale=0.2)
    out.backward(do)
    assert torch.equal(out, fa.flash_attention_fwd_plain(
        q, k, v, causal=True, sm_scale=0.2)[0])
    assert qq.grad is not None and torch.isfinite(qq.grad).all()
    assert [(w.launches, w.tensor_core_launches) for w in wrappers] == before
