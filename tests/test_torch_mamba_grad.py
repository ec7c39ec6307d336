"""The port's DiMamba backward kernels (`ddg_tpu_torch.ops.mamba`, the plain
versions on the CPU) against `jax.grad` of the Pallas kernels in interpret
mode: K19 (`mamba_inner_pallas`'s VJP) and K15 (`selective_scan_pallas`'s,
the pps3 schedule), on the same numpy-seeded inputs and output cotangent.

Bars. float32: rtol 2e-4 with atol 2e-4 (K19, as
`tests/test_mamba_block_pallas.py` holds the fused gradients) and rtol 1e-4
with atol 1e-4 of the largest magnitude (K15, sums over up to 512 rows).
bfloat16 outputs of the scan: 2 ulp of the largest magnitude. The bf16 K19
gradients are sums whose bf16 rounding flips compound: each bf16 run lies
1-11% (of the largest magnitude) from the float32 gradients, and the JAX
bf16 kernel's forward states differ from a float64 recurrence on the same
rounded inputs by up to about 1% (the port's by 2e-7), so the two bf16 runs
can be more than 2 ulp apart (3 ulp measured, db_dt and dW_dt). There each
gradient of the port must lie no further from the float32 gradients than
1.5 times JAX's own bf16 gradients do, plus 2 ulp (the port's error over
JAX's measured 0.6-1.6 over two seeds and both shapes).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops.mamba_block_pallas import mamba_inner_pallas
from ddg_tpu.ops.selective_scan_pallas import selective_scan_pallas
from ddg_tpu_torch.ops import mamba

torch.set_num_threads(1)
NAMES = ('h', 'W_in', 'conv_w', 'conv_b', 'W_x', 'W_dt', 'b_dt', 'A', 'D',
         'W_out')
# (B, L, H, d, N, R, chunk, seg): tests/test_mamba_block_pallas.py's shapes,
# and two Species10-sized chunks at narrow widths.
SHAPES = {'chunk16': (2, 64, 8, 16, 4, 2, 16, 4),
          'chunk128': (2, 256, 32, 64, 16, 2, 128, 64)}
K = 4
_DT = {'f32': (jnp.float32, torch.float32),
       'bf16': (jnp.bfloat16, torch.bfloat16)}


def _ulp2(ref):
    m = float(np.abs(ref).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def _weights(seed, B, L, H, d, N, R):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    return (f(B, L, H), f(H, 2 * d, scale=H ** -0.5),
            f(K, 1, d, scale=0.5), f(d, scale=0.1),
            f(d, R + 2 * N, scale=d ** -0.5), f(R, d, scale=R ** -0.5),
            f(d, scale=0.5) - 3.0, -np.exp(f(d, N, scale=0.5)), f(d),
            f(d, H, scale=d ** -0.5))


def _jax_inner_grads(args, ct, shape, jdt):
    _, _, _, _, N, R, chunk, seg = shape

    def loss(*a):
        y = mamba_inner_pallas(*a, d_state=N, dt_rank=R, chunk=chunk,
                               seg=seg, seg_bwd=seg, interpret=True,
                               compute_dtype=jdt)
        return jnp.sum(y.astype(jnp.float32) * ct)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(10))))(
        *(jnp.asarray(a) for a in args))
    return [np.asarray(g, np.float32) for g in grads]


def _port_inner_grads(args, ct, shape, tdt, flip=False):
    """Gradients through the autograd wrapper (the plain backward on the
    CPU); with `flip`, h runs reversed as BiMambaWrapper runs `core_rev`."""
    _, _, _, _, N, R, chunk, _ = shape
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    h = torch.flip(ts[0], (1,)) if flip else ts[0]
    y = mamba.mamba_inner(h, *ts[1:], d_state=N, dt_rank=R, chunk=chunk,
                          compute_dtype=tdt)
    if flip:
        y = torch.flip(y, (1,))
    (y.float() * torch.from_numpy(ct)).sum().backward()
    return [t.grad.float().numpy() for t in ts]


def _inner_case(key, seed):
    shape = SHAPES[key]
    B, L, H, d, N, R, _, _ = shape
    args = _weights(seed, B, L, H, d, N, R)
    ct = np.random.RandomState(seed + 1).randn(B, L, H).astype(np.float32)
    return shape, args, ct


@pytest.mark.parametrize('key', list(SHAPES))
def test_mamba_inner_grads_match_pallas_f32(key):
    shape, args, ct = _inner_case(key, 3)
    want = _jax_inner_grads(args, ct, shape, jnp.float32)
    got = _port_inner_grads(args, ct, shape, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.mark.parametrize('key', list(SHAPES))
def test_mamba_inner_grads_match_pallas_bf16(key):
    shape, args, ct = _inner_case(key, 4)
    want = _jax_inner_grads(args, ct, shape, jnp.bfloat16)
    got = _port_inner_grads(args, ct, shape, torch.bfloat16)
    ref = _port_inner_grads(args, ct, shape, torch.float32)
    for name, g, w, r in zip(NAMES, got, want, ref):
        jax_err = np.abs(w - r).max()
        err = np.abs(g - r).max()
        assert err <= 1.5 * jax_err + _ulp2(w), (name, err, jax_err)


def test_mamba_inner_grads_three_taps_match_pallas_f32():
    """d_conv 3 runs as 4 taps with a leading zero one (`pad_taps`): the
    gradients, conv_w's (3, 1, d) too, equal JAX's at 3 taps, and
    `mamba_inner_bwd` slices the padded tap off itself."""
    shape, args, ct = _inner_case('chunk16', 5)
    args = args[:2] + (args[2][1:],) + args[3:]
    want = _jax_inner_grads(args, ct, shape, jnp.float32)
    got = _port_inner_grads(args, ct, shape, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4, err_msg=name)


def test_mamba_inner_grads_reverse_direction_weights():
    """The reverse direction: flip(h) through another set of weights, the
    output flipped back, as the model runs `core_rev`."""
    shape, args, ct = _inner_case('chunk16', 7)
    fwd = _weights(8, *shape[:6])
    args_rev = (args[0],) + fwd[1:]

    def loss(*a):
        y = mamba_inner_pallas(jnp.flip(a[0], 1), *a[1:], d_state=shape[4],
                               dt_rank=shape[5], chunk=shape[6],
                               seg=shape[7], seg_bwd=shape[7],
                               interpret=True, compute_dtype=jnp.float32)
        return jnp.sum(jnp.flip(y, 1) * ct)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(10))))(
        *(jnp.asarray(a) for a in args_rev))
    got = _port_inner_grads(args_rev, ct, shape, torch.float32, flip=True)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def _scan_inputs(seed, L, d=64, N=16, B=2):
    r = np.random.RandomState(seed)

    def f(*shape):
        return r.randn(*shape).astype(np.float32)

    u = f(B, L, d)
    delta = np.log1p(np.exp(f(B, L, d) - 2.0)).astype(np.float32)
    A = -np.exp(0.5 * f(d, N))
    return (u, delta, A, f(B, L, N), f(B, L, N), f(d), f(B, L, d)), f(B, L, d)


SCAN_NAMES = ('u', 'delta', 'A', 'B', 'C', 'D', 'z')


@pytest.mark.parametrize('L, chunk', [(256, 128), (200, 64)],
                         ids=['aligned', 'padded'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_ssm_scan_grads_match_pallas(L, chunk, dtype):
    """u, B, C, z in `dtype` (delta, A, D float32); their gradients come
    back in their dtypes on both sides. L=200 pads the last chunk."""
    inputs, ct = _scan_inputs(L + chunk, L)
    jdt, tdt = _DT[dtype]
    low = (0, 3, 4, 6)

    def loss(*a):
        y = selective_scan_pallas(*a, chunk=chunk, seg=min(64, chunk // 2),
                                  scan_impl='pps3', interpret=True)
        return jnp.sum(y.astype(jnp.float32) * ct)

    jin = [jnp.asarray(a, jdt if i in low else jnp.float32)
           for i, a in enumerate(inputs)]
    want = jax.jit(jax.grad(loss, argnums=tuple(range(7))))(*jin)
    ts = [torch.from_numpy(a).to(tdt if i in low else torch.float32)
          .requires_grad_() for i, a in enumerate(inputs)]
    y = mamba.ssm_scan(*ts, chunk=chunk)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    for i, (name, t, w) in enumerate(zip(SCAN_NAMES, ts, want)):
        assert t.grad.dtype == t.dtype, name
        g, w = t.grad.float().numpy(), np.asarray(w, np.float32)
        if dtype == 'bf16' and i in low:
            assert np.abs(g - w).max() <= _ulp2(w), name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)


def test_autograd_wrappers_equal_the_plain_backwards():
    """On the CPU the autograd Functions hand back exactly what the plain
    backwards give (A's gradient from that of log(-A).T)."""
    inputs, g = _scan_inputs(11, 96)
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y, h0s = mamba.ssm_scan(*ts, chunk=32, return_h0s=True)
    y.backward(torch.from_numpy(g))
    plain = mamba.ssm_scan_bwd_plain(*(t.detach() for t in ts), h0s,
                                     torch.from_numpy(g), chunk=32)
    du, ddt, dB, dC, dA_log, dz, dD = plain
    for t, w in zip(ts, (du, ddt, dA_log.t() / ts[2].detach(), dB, dC, dD,
                         dz)):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)

    shape, args, ct = _inner_case('chunk16', 12)
    N, R, chunk = shape[4], shape[5], shape[6]
    kw = dict(d_state=N, dt_rank=R, chunk=chunk,
              compute_dtype=torch.bfloat16)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out, h0s = mamba.mamba_inner(*ts, return_h0s=True, **kw)
    gc = torch.from_numpy(ct).to(torch.bfloat16)
    out.backward(gc)
    plain = list(mamba.mamba_inner_bwd_plain(
        *(t.detach() for t in ts), h0s, gc, **kw))
    plain[7] = plain[7].t() / ts[7].detach()
    for name, t, w in zip(NAMES, ts, plain):
        torch.testing.assert_close(t.grad, w.to(t.dtype), rtol=0, atol=0,
                                   msg=name)


def test_no_grad_forward_skips_autograd():
    """Sampling runs the forwards outside autograd: no graph is recorded."""
    inputs, _ = _scan_inputs(13, 64)
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    with torch.no_grad():
        y = mamba.ssm_scan(*ts, chunk=32)
    assert y.grad_fn is None
    y = mamba.ssm_scan(*ts, chunk=32)
    assert y.grad_fn is not None
