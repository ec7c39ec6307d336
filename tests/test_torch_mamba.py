"""The port's DiMamba kernels (`ddg_tpu_torch.ops.mamba`, the plain versions
on the CPU) against the Pallas kernels of `ddg_tpu/ops/mamba_block_pallas.py`
(K18) and `ddg_tpu/ops/selective_scan_pallas.py` (K14) in interpret mode,
on the same numpy-seeded inputs.

Bars: float32 outputs to 1e-4 abs; bfloat16 outputs to 2 ulp of the
largest magnitude (one rounding flip of a shared fp32 value is 1 ulp). The
JAX test's 8e-2 bf16 bar compares two paths with different summation
orders (the unfused conv starts from its newest tap); here both sides
follow the fused kernel's order. Scales keep the outputs of order 1, so
the float32 bar means something.
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
B, H, D_IN, N, R, K = 2, 32, 64, 16, 2, 4


def _bf16_tol(ref):
    m = float(np.abs(ref).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def _check(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = 1e-4 if dtype == 'f32' else _bf16_tol(want)
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


def _weights(seed, L):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    return (f(B, L, H), f(H, 2 * D_IN, scale=H ** -0.5),
            f(K, 1, D_IN, scale=0.5), f(D_IN, scale=0.1),
            f(D_IN, R + 2 * N, scale=D_IN ** -0.5),
            f(R, D_IN, scale=R ** -0.5), f(D_IN, scale=0.5) - 3.0,
            -np.exp(f(D_IN, N, scale=0.5)), f(D_IN),
            f(D_IN, H, scale=D_IN ** -0.5))


_DT = {'f32': (jnp.float32, torch.float32),
       'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize('L, chunk, seg', [(256, 128, 64), (64, 16, 4)],
                         ids=['chunk128', 'chunk16'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_mamba_inner_matches_pallas(L, chunk, seg, dtype):
    args = _weights(L + chunk, L)
    jdt, tdt = _DT[dtype]
    want = jax.jit(functools.partial(
        mamba_inner_pallas, d_state=N, dt_rank=R, chunk=chunk, seg=seg,
        seg_bwd=seg, interpret=True, compute_dtype=jdt))(
            *(jnp.asarray(a) for a in args)).astype(jnp.float32)
    got = mamba.mamba_inner(*(torch.from_numpy(a) for a in args),
                            d_state=N, dt_rank=R, chunk=chunk,
                            compute_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (B, L, H)
    _check(got.float(), want, dtype)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_mamba_inner_three_taps_match_pallas(dtype):
    """d_conv 3 (the TPU kernel takes d_conv <= 8): `mamba_inner` runs it
    as 4 taps with a leading zero one (`pad_taps`, on every device), which
    equals the plain version on the 3 taps bit for bit and the Pallas
    kernel to the bar."""
    L, chunk = 64, 16
    args = list(_weights(11, L))
    args[2] = args[2][1:]
    jdt, tdt = _DT[dtype]
    want = jax.jit(functools.partial(
        mamba_inner_pallas, d_state=N, dt_rank=R, chunk=chunk, seg=4,
        seg_bwd=4, interpret=True, compute_dtype=jdt))(
            *(jnp.asarray(a) for a in args)).astype(jnp.float32)
    targs = [torch.from_numpy(a) for a in args]
    kw = dict(d_state=N, dt_rank=R, chunk=chunk, compute_dtype=tdt)
    got = mamba.mamba_inner(*targs, **kw)
    assert tuple(mamba.pad_taps(targs[2]).shape) == (4, 1, D_IN)
    assert torch.equal(got, mamba.mamba_inner_plain(*targs, **kw))
    _check(got.float(), want, dtype)


def test_mamba_inner_reverse_direction_weights():
    """The reverse direction: flip(h) through another core's weights, as
    BiMambaWrapper runs `core_rev`, flipped back."""
    L, chunk = 256, 128
    fwd, rev = _weights(7, L), _weights(8, L)
    args = (fwd[0][:, ::-1].copy(),) + rev[1:]
    want = jax.jit(functools.partial(
        mamba_inner_pallas, d_state=N, dt_rank=R, chunk=chunk, seg=64,
        seg_bwd=64, interpret=True, compute_dtype=jnp.float32))(
            *(jnp.asarray(a) for a in args))
    got = mamba.mamba_inner(
        torch.flip(torch.from_numpy(fwd[0]), (1,)),
        *(torch.from_numpy(a) for a in rev[1:]), d_state=N, dt_rank=R,
        chunk=chunk, compute_dtype=torch.float32)
    _check(torch.flip(got, (1,)), np.asarray(want)[:, ::-1], 'f32')


def test_mamba_inner_checks_shapes():
    """As `mamba_inner_pallas`: L a multiple of the chunk, consistent
    weights (here W_x missing its C columns)."""
    args = [torch.from_numpy(a) for a in _weights(0, 100)]
    with pytest.raises(ValueError, match='divisible'):
        mamba.mamba_inner(*args, d_state=N, dt_rank=R, chunk=128)
    args = [torch.from_numpy(a) for a in _weights(0, 128)]
    args[4] = args[4][:, :R + N]
    with pytest.raises(ValueError, match='shapes'):
        mamba.mamba_inner(*args, d_state=N, dt_rank=R, chunk=128)


def _scan_inputs(seed, L):
    r = np.random.RandomState(seed)

    def f(*shape):
        return r.randn(*shape).astype(np.float32)

    u = f(B, L, D_IN)
    delta = np.log1p(np.exp(f(B, L, D_IN) - 2.0)).astype(np.float32)
    A = -np.exp(0.5 * f(D_IN, N))
    return (u, delta, A, f(B, L, N), f(B, L, N), f(D_IN), f(B, L, D_IN))


@pytest.mark.parametrize('L, chunk', [(256, 128), (200, 64)],
                         ids=['aligned', 'padded'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_ssm_scan_matches_pallas(L, chunk, dtype):
    """u, B, C, z in `dtype` (delta, A, D float32), the pps3 schedule with
    seg 64 where the chunk allows it; y in u's dtype as both calls return
    it. L=200 pads the last chunk."""
    u, delta, A, Bc, Cc, Dv, z = _scan_inputs(L, L)
    jdt, tdt = _DT[dtype]
    want = jax.jit(functools.partial(
        selective_scan_pallas, chunk=chunk, seg=min(64, chunk // 2),
        scan_impl='pps3', interpret=True))(
            jnp.asarray(u, jdt), jnp.asarray(delta), jnp.asarray(A),
            jnp.asarray(Bc, jdt), jnp.asarray(Cc, jdt), jnp.asarray(Dv),
            jnp.asarray(z, jdt)).astype(jnp.float32)
    t = [torch.from_numpy(a) for a in (u, delta, A, Bc, Cc, Dv, z)]
    for i in (0, 3, 4, 6):
        t[i] = t[i].to(tdt)
    got, h0s = mamba.ssm_scan(*t, chunk=chunk, return_h0s=True)
    assert got.dtype == tdt
    _check(got.float(), want, dtype)
    assert tuple(h0s.shape) == (B, -(-L // chunk), N, D_IN)
    assert float(h0s[:, 0].abs().max()) == 0.0


def test_scan_chunks_matches_a_sequential_scan():
    """The chunk-parallel schedule against the recurrence run row by row,
    and its entry states against the sequential states at the chunk
    starts."""
    L, chunk = 48, 16
    u, delta, A, Bc, Cc, _, _ = (torch.from_numpy(a)
                                 for a in _scan_inputs(3, L))
    y, h0s = mamba.scan_chunks(u, delta, A, Bc, Cc, chunk)
    h = torch.zeros(B, D_IN, N)
    for t in range(L):
        if t % chunk == 0:
            torch.testing.assert_close(h0s[:, t // chunk],
                                       h.transpose(1, 2), rtol=1e-5,
                                       atol=1e-5)
        a = torch.exp(delta[:, t, :, None] * A)
        h = a * h + (delta[:, t] * u[:, t])[..., None] * Bc[:, t, None, :]
        torch.testing.assert_close(y[:, t], (h * Cc[:, t, None, :]).sum(-1),
                                   rtol=1e-5, atol=1e-5)
