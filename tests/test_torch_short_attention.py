"""The port's short-sequence attention (`ddg_tpu_torch.ops.attention.
short_seq_attention`, K2: plain version on the CPU) against
`ddg_tpu/ops/attention_pallas.py:short_seq_attention` with interpret=True
(its Pallas kernel, and its custom VJP `_flash_bwd` for the backward),
causal and not, at L=16, text8's L=256 and the reference DiT-small's
L=1024, B=1, H=2, D=64: float32 to 1e-5 abs, bfloat16 to 2 ulp of the
largest magnitude of the JAX output (one rounding flip of a bf16 operand
moves a result by about that much). Also:
the autograd Function equals the plain backward on views of one qkv
projection, and a tensor that is neither on the CPU nor on a card is
refused without taking the plain version."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops import attention_pallas as jat
from ddg_tpu_torch.ops import attention as tat

torch.set_num_threads(1)
B, H, DH = 1, 2, 64
ATOL = 1e-5
CASES = [(causal, length) for length in (16, 256, 1024)
         for causal in (False, True)]
DTYPES = {'float32': (np.float32, jnp.float32, torch.float32),
          'bfloat16': (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, length, n=3):
    r = np.random.RandomState(seed)
    return [r.randn(B, length, H, DH).astype(np.float32) for _ in range(n)]


def _assert_close(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        return
    m = np.abs(want).max()
    tol = 2.0 * 2.0 ** (math.floor(math.log2(m)) - 7)
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('causal,length', CASES)
def test_forward_matches_pallas(causal, length, dtype):
    _, jdt, tdt = DTYPES[dtype]
    q, k, v = _inputs(1 + causal + length, length)
    want = jat.short_seq_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        interpret=True)
    got = tat.short_seq_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal)
    assert got.shape == (B, length, H, DH) and got.dtype == tdt
    _assert_close(got, want, dtype)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('causal,length', CASES)
def test_backward_matches_pallas_vjp(causal, length, dtype):
    _, jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(10 + causal + length, length, n=4)
    _, vjp = jax.vjp(
        lambda q, k, v: jat.short_seq_attention(q, k, v, causal=causal,
                                                interpret=True),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do).astype(jdt))
    got = tat.short_seq_attention_bwd_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v, do)), causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _assert_close(g, w, dtype)


@pytest.mark.parametrize('causal', [False, True])
def test_autograd_matches_the_plain_backward(causal):
    """Through the autograd Function, with q, k, v as views of one qkv
    projection, and against autograd through the plain forward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(20 + causal, 16, 4))
    qkv = torch.stack([q, k, v], 2).requires_grad_()
    views = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = torch.autograd.grad(
        tat.short_seq_attention(*views, causal=causal), qkv, do)[0]
    want = torch.autograd.grad(
        tat.attention_plain(*views, causal=causal), qkv, do)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=1e-5)
    plain = torch.stack(tat.short_seq_attention_bwd_plain(
        q, k, v, do, causal=causal), 2)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_non_cpu_tensors_never_take_the_plain_version():
    q = torch.empty((B, 16, H, DH), device='meta')
    counters = (tat.short_seq_attention, tat.short_seq_attention_bwd)
    before = [(f.launches, getattr(f, 'tensor_core_launches', 0))
              for f in counters]
    with pytest.raises(ValueError):
        tat.short_seq_attention(q, q, q)
    with pytest.raises(ValueError):
        tat.short_seq_attention_bwd(q, q, q, q)
    assert [(f.launches, getattr(f, 'tensor_core_launches', 0))
            for f in counters] == before
