"""The plain backwards of the port's adaLN chains
(`ddg_tpu_torch.ops.adaln.*_bwd_plain`, what the wrappers run on the CPU)
against `jax.vjp` of `ddg_tpu/ops/adaln_pallas.py` with interpret=True,
which runs `_lm_bwd_kernel` and `_gr_bwd_kernel`; and against torch
autograd through the plain forwards. Float32 to 1e-5, absolute and
relative (dw and the conditioning grads are sums over rows, taken in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops import adaln_pallas as jad
from ddg_tpu_torch.ops import adaln as tad

torch.set_num_threads(1)
B, L, D = 2, 16, 128
TOL = 1e-5


@pytest.fixture(scope='module')
def inputs():
    r = np.random.RandomState(5)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    return dict(x=f(B, L, D) + 3.0, y=f(B, L, D), skip=f(B, L, D),
                gate=f(B, D), w=(1.0 + 0.1 * f(D)).astype(np.float32),
                shift=f(B, D), scale=0.5 * f(B, D), dx=f(B, L, D),
                dh=f(B, L, D))


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    if isinstance(want, torch.Tensor):
        want = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_ln_modulate_bwd_matches_pallas_vjp(inputs):
    t = inputs
    _, vjp = jax.vjp(lambda *a: jad.ln_modulate(*a, interpret=True),
                     *(jnp.asarray(t[k]) for k in ('x', 'w', 'shift',
                                                   'scale')))
    want = vjp(jnp.asarray(t['dh']))
    got = tad.ln_modulate_bwd_plain(T(t['x']), T(t['w']), T(t['scale']),
                                    T(t['dh']))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)


def test_gate_res_ln_modulate_bwd_matches_pallas_vjp(inputs):
    t = inputs
    keys = ('y', 'skip', 'gate', 'w', 'shift', 'scale')
    (x_new, _), vjp = jax.vjp(
        lambda *a: jad.gate_res_ln_modulate(*a, interpret=True),
        *(jnp.asarray(t[k]) for k in keys))
    want = vjp((jnp.asarray(t['dx']), jnp.asarray(t['dh'])))
    got = tad.gate_res_ln_modulate_bwd_plain(
        T(x_new), T(t['y']), T(t['gate']), T(t['w']), T(t['scale']),
        T(t['dx']), T(t['dh']))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w)


def _leaves(t, keys):
    return [T(t[k]).requires_grad_() for k in keys]


def test_ln_modulate_bwd_matches_autograd(inputs):
    t = inputs
    x, w, shift, scale = _leaves(t, ('x', 'w', 'shift', 'scale'))
    want = torch.autograd.grad(tad.ln_modulate_plain(x, w, shift, scale),
                               (x, w, shift, scale), T(t['dh']))
    got = tad.ln_modulate_bwd_plain(x, w, scale, T(t['dh']))
    for g, w_ in zip(got, want):
        close(g, w_)


def test_gate_res_ln_modulate_bwd_matches_autograd(inputs):
    t = inputs
    leaves = _leaves(t, ('y', 'skip', 'gate', 'w', 'shift', 'scale'))
    x_new, h = tad.gate_res_ln_modulate_plain(*leaves)
    want = torch.autograd.grad((x_new, h), leaves, (T(t['dx']), T(t['dh'])))
    y, _, gate, w, _, scale = leaves
    got = tad.gate_res_ln_modulate_bwd_plain(x_new, y, gate, w, scale,
                                             T(t['dx']), T(t['dh']))
    for g, w_ in zip(got, want):
        close(g, w_)


def test_autograd_functions_use_the_plain_backwards(inputs):
    """Autograd through the wrappers on CPU tensors gives what the plain
    backwards give; the conditioning as strided chunks of one projection
    gets its gradient assembled into the projection's."""
    t = inputs
    x = T(t['x']).requires_grad_()
    w = T(t['w']).requires_grad_()
    mod = T(np.concatenate([t['shift'], t['scale'], t['gate']], -1)
            ).requires_grad_()
    shift, scale, gate = mod[:, :D], mod[:, D:2 * D], mod[:, 2 * D:]
    got = torch.autograd.grad(tad.ln_modulate(x, w, shift, scale), (x, w, mod),
                              T(t['dh']))
    dx, dw, dshift, dscale = tad.ln_modulate_bwd_plain(x, w, scale,
                                                       T(t['dh']))
    close(got[0], dx)
    close(got[1], dw)
    close(got[2], torch.cat([dshift, dscale, torch.zeros_like(dshift)], -1))
    y = T(t['y']).requires_grad_()
    x_new, h = tad.gate_res_ln_modulate(y, x, gate, w, shift, scale)
    got = torch.autograd.grad((x_new, h), (y, x, w, mod),
                              (T(t['dx']), T(t['dh'])))
    dy, dskip, dgate, dw, dshift, dscale = \
        tad.gate_res_ln_modulate_bwd_plain(x_new, y, gate, w, scale,
                                           T(t['dx']), T(t['dh']))
    for g, want in zip(got, (dy, dskip, dw,
                             torch.cat([dshift, dscale, dgate], -1))):
        close(g, want)
