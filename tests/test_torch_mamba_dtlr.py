"""The port's dt-lowrank scan, K16 and K17 (`ddg_tpu_torch.ops.mamba
.ssm_scan_dtlr` and its backward, the plain versions on the CPU), against
`selective_scan_pallas_dtlr` in interpret mode and its `jax.grad`, on the
same numpy-seeded inputs; and the fused block's plain versions (K18, K19)
at the shapes the card's kernels were widened to take (ROADMAP C.1):
d_state 24, d_conv 6 and hidden 48 with dt_rank 3, against
`mamba_inner_pallas` in interpret mode.

Bars (those of `test_torch_mamba.py` and `test_torch_mamba_grad.py`):
float32 outputs and gradients to rtol 1e-4 with atol 1e-4 of the largest
magnitude (the fused block's gradients: rtol/atol 2e-4); the bfloat16
outputs and the gradients of bfloat16 inputs to 2 ulp of the largest
magnitude. L is a multiple of the chunk: the dt-lowrank path refuses
anything else, as JAX does.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops.mamba_block_pallas import mamba_inner_pallas
from ddg_tpu.ops.selective_scan_pallas import selective_scan_pallas_dtlr
from ddg_tpu_torch.ops import mamba

torch.set_num_threads(1)
B, L, D_IN, N, R, CHUNK = 2, 256, 64, 16, 4, 128
NAMES = ('u', 'dt_lr', 'W_dt', 'b_dt', 'A', 'B', 'C', 'D', 'z')
LOW = (0, 5, 6, 8)          # u, B, C, z: in the tested dtype
_DT = {'f32': (jnp.float32, torch.float32),
       'bf16': (jnp.bfloat16, torch.bfloat16)}


def _ulp2(ref):
    m = float(np.abs(ref).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def _inputs(seed, L=L):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    args = (f(B, L, D_IN), f(B, L, R), f(R, D_IN, scale=R ** -0.5),
            f(D_IN, scale=0.5) - 3.0, -np.exp(f(D_IN, N, scale=0.5)),
            f(B, L, N), f(B, L, N), f(D_IN), f(B, L, D_IN))
    return args, f(B, L, D_IN)


def _jax_args(args, jdt):
    return [jnp.asarray(a, jdt if i in LOW else jnp.float32)
            for i, a in enumerate(args)]


def _torch_args(args, tdt, grad=False):
    return [torch.from_numpy(a).to(tdt if i in LOW else torch.float32)
            .requires_grad_(grad) for i, a in enumerate(args)]


def _jax_scan(*a):
    return selective_scan_pallas_dtlr(*a, chunk=CHUNK, seg=64,
                                      interpret=True)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_forward_matches_pallas(dtype):
    args, _ = _inputs(1)
    jdt, tdt = _DT[dtype]
    want = np.asarray(jax.jit(_jax_scan)(*_jax_args(args, jdt)), np.float32)
    got = mamba.ssm_scan_dtlr(*_torch_args(args, tdt), chunk=CHUNK)
    assert got.dtype == tdt and tuple(got.shape) == (B, L, D_IN)
    tol = 1e-4 * np.abs(want).max() if dtype == 'f32' else _ulp2(want)
    assert np.abs(got.float().numpy() - want).max() <= tol


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_all_nine_grads_match_pallas(dtype):
    """u, B, C, z in `dtype`, dt_lr, W_dt, b_dt, A, D float32; every
    gradient comes back in its input's dtype on both sides."""
    args, ct = _inputs(2)
    jdt, tdt = _DT[dtype]

    def loss(*a):
        return jnp.sum(_jax_scan(*a).astype(jnp.float32) * ct)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(9))))(
        *_jax_args(args, jdt))
    ts = _torch_args(args, tdt, grad=True)
    y = mamba.ssm_scan_dtlr(*ts, chunk=CHUNK)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    for i, (name, t, w) in enumerate(zip(NAMES, ts, want)):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape, name
        g, w = t.grad.float().numpy(), np.asarray(w, np.float32)
        if dtype == 'bf16' and i in LOW:
            assert np.abs(g - w).max() <= _ulp2(w), name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)


def test_refuses_l_off_the_chunk_grid():
    args, g = _inputs(3, L=200)
    ts = _torch_args(args, torch.float32)
    with pytest.raises(ValueError, match='chunk'):
        mamba.ssm_scan_dtlr(*ts, chunk=CHUNK)
    with pytest.raises(ValueError, match='chunk'):
        mamba.ssm_scan_dtlr_plain(*ts, chunk=CHUNK)
    h0s = torch.zeros((B, 2, N, D_IN))
    with pytest.raises(ValueError, match='chunk'):
        mamba.ssm_scan_dtlr_bwd(*ts, h0s, torch.from_numpy(g), chunk=CHUNK)


def test_autograd_equals_the_plain_backward():
    """The autograd Function hands back exactly what the plain backward
    gives (A's gradient from that of log(-A).T), and the forward equals
    `ssm_scan_plain` of the composite delta bit for bit."""
    args, g = _inputs(4, L=96)
    ts = _torch_args(args, torch.float32, grad=True)
    y, h0s = mamba.ssm_scan_dtlr(*ts, chunk=32, return_h0s=True)
    y.backward(torch.from_numpy(g))
    det = [t.detach() for t in ts]
    delta = mamba.softplus(det[1] @ det[2] + det[3])
    torch.testing.assert_close(
        y.detach(), mamba.ssm_scan_plain(det[0], delta, *det[4:8], det[8],
                                         chunk=32), rtol=0, atol=0)
    du, dlr, dW, db, dB, dC, dA_log, dz, dD = mamba.ssm_scan_dtlr_bwd_plain(
        *det, h0s, torch.from_numpy(g), chunk=32)
    for t, w in zip(ts, (du, dlr, dW, db, dA_log.t() / det[4], dB, dC, dD,
                         dz)):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


def test_no_grad_forward_records_no_graph():
    args, _ = _inputs(5, L=64)
    ts = _torch_args(args, torch.float32, grad=True)
    with torch.no_grad():
        y = mamba.ssm_scan_dtlr(*ts, chunk=32)
    assert y.grad_fn is None
    assert mamba.ssm_scan_dtlr(*ts, chunk=32).grad_fn is not None


# (H, d, N, R, K): the widened shapes of the fused block, at L=64 in
# chunks of 16 (segments of 4).
WIDE = {'d_state24': (32, 64, 24, 2, 4), 'd_conv6': (32, 64, 16, 2, 6),
        'hidden48': (48, 96, 16, 3, 4)}
WL, WCHUNK, WSEG = 64, 16, 4


def _wide_weights(seed, H, d, N, R, K):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    return (f(B, WL, H), f(H, 2 * d, scale=H ** -0.5), f(K, 1, d, scale=0.5),
            f(d, scale=0.1), f(d, R + 2 * N, scale=d ** -0.5),
            f(R, d, scale=R ** -0.5), f(d, scale=0.5) - 3.0,
            -np.exp(f(d, N, scale=0.5)), f(d), f(d, H, scale=d ** -0.5))


@pytest.mark.parametrize('key', list(WIDE))
def test_fused_block_at_widened_shapes_matches_pallas(key):
    """`mamba_inner` (its plain forward and, through autograd, its plain
    backward; d_conv 6 runs as 8 taps, `pad_taps`) against
    `mamba_inner_pallas(interpret=True)` and its `jax.grad`, float32."""
    H, d, N_, R_, K = WIDE[key]
    args = _wide_weights(7, H, d, N_, R_, K)
    ct = np.random.RandomState(8).randn(B, WL, H).astype(np.float32)
    kw = dict(d_state=N_, dt_rank=R_, chunk=WCHUNK)

    def fwd(*a):
        return mamba_inner_pallas(*a, **kw, seg=WSEG, seg_bwd=WSEG,
                                  interpret=True, compute_dtype=jnp.float32)

    def loss(*a):
        return jnp.sum(fwd(*a) * ct)

    jargs = [jnp.asarray(a) for a in args]
    want_y = np.asarray(jax.jit(fwd)(*jargs))
    want = jax.jit(jax.grad(loss, argnums=tuple(range(10))))(*jargs)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = mamba.mamba_inner(*ts, **kw, compute_dtype=torch.float32)
    assert np.abs(y.detach().numpy() - want_y).max() <= 1e-4
    (y * torch.from_numpy(ct)).sum().backward()
    for t, w in zip(ts, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
