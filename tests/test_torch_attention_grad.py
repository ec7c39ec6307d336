"""The plain backward of the port's fused RoPE attention
(`ddg_tpu_torch.ops.attention.fused_rope_attention_bwd_plain`, what the
wrapper runs on the CPU) against `jax.vjp` of `ddg_tpu/ops/
attention_pallas.py:fused_rope_attention` with interpret=True (its custom
VJP, `_rope_flash_bwd`), causal and not, and against torch autograd
through the plain forward. Float32 to 1e-5, absolute and relative. H * D =
128, so the JAX function takes its kernel and not its jnp fallback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.models import dit as jdit
from ddg_tpu.ops import attention_pallas as jat
from ddg_tpu_torch.models import dit as tdit
from ddg_tpu_torch.ops import attention as tat

torch.set_num_threads(1)
B, L, H, DH = 2, 16, 2, 64
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, length=L):
    r = np.random.RandomState(seed)
    return [r.randn(B, length, H, DH).astype(np.float32) for _ in range(4)]


def T(a):
    return torch.from_numpy(np.array(a))


# L=16, text8's L=256 and the reference DiT-small's L=1024 (the case ids
# of L=16 are the original ones).
LENGTHS = [pytest.param(c, n, id=f'{c}' if n == L else f'{c}-L{n}')
           for n in (L, 256, 1024) for c in (False, True)]


@pytest.mark.parametrize('causal,length', LENGTHS)
def test_bwd_matches_pallas_vjp(causal, length):
    q, k, v, do = _inputs(10 + causal, length)
    cos, sin = (np.array(a) for a in jdit.rope_cos_sin(length, DH))
    _, vjp = jax.vjp(
        lambda q, k, v: jat.fused_rope_attention(
            q, k, v, jnp.asarray(cos), jnp.asarray(sin), causal=causal,
            interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = tat.fused_rope_attention_bwd_plain(
        *(T(a) for a in (q, k, v, cos, sin, do)), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_bwd_matches_autograd_of_plain_forward(causal):
    """Also through the autograd Function, with q, k, v as views of one
    qkv projection (what the DiT gives it)."""
    q, k, v, do = _inputs(20 + causal)
    cos, sin = tdit.rope_cos_sin(L, DH)
    qkv = torch.stack([T(q), T(k), T(v)], 2).requires_grad_()
    views = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    want = torch.autograd.grad(
        tat.fused_rope_attention_plain(*views, cos, sin, causal=causal),
        qkv, T(do))[0]
    got = torch.autograd.grad(
        tat.fused_rope_attention(*views, cos, sin, causal=causal), qkv,
        T(do))[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    plain = torch.stack(tat.fused_rope_attention_bwd_plain(
        *(t.detach() for t in views), cos, sin, T(do), causal=causal), 2)
    np.testing.assert_allclose(plain.numpy(), want.numpy(), **TOL)


def test_bwd_rounds_where_the_vjp_rounds():
    """In bfloat16 the plain backward equals the fp32 one rounded at the
    VJP's points: not bit-equal to the fp32 grads cast once, but within a
    few bf16 ulp of them."""
    q, k, v, do = (T(a) for a in _inputs(30))
    cos, sin = tdit.rope_cos_sin(L, DH)
    got = tat.fused_rope_attention_bwd_plain(
        *(a.to(torch.bfloat16) for a in (q, k, v)), cos, sin,
        do.to(torch.bfloat16))
    ref = tat.fused_rope_attention_bwd_plain(
        *(a.to(torch.bfloat16).float() for a in (q, k, v)), cos, sin,
        do.to(torch.bfloat16).float())
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        scale = r.abs().max().item()
        assert (g.float() - r).abs().max().item() <= 4 * scale * 2 ** -8


@pytest.mark.parametrize('route', ['fused_rope', 'short_seq'])
def test_bwd_matches_pallas_vjp_at_head_dim_192(route):
    """A head width the CUDA-core backward takes only on its halved tiles
    (past 174, up to the forward's 290): both plain backwards against
    `jax.vjp` of the Pallas kernels (interpret=True), causal, at L=40."""
    length, D = 40, 192
    r = np.random.RandomState(30)
    q, k, v, do = (r.randn(B, length, H, D).astype(np.float32)
                   for _ in range(4))
    cos, sin = (np.array(a) for a in jdit.rope_cos_sin(length, D))
    if route == 'fused_rope':
        def fn(q, k, v):
            return jat.fused_rope_attention(
                q, k, v, jnp.asarray(cos), jnp.asarray(sin), causal=True,
                interpret=True)
        got = tat.fused_rope_attention_bwd_plain(
            *(T(a) for a in (q, k, v, cos, sin, do)), causal=True)
    else:
        def fn(q, k, v):
            return jat.short_seq_attention(q, k, v, causal=True,
                                           interpret=True)
        got = tat.short_seq_attention_bwd_plain(
            *(T(a) for a in (q, k, v, do)), causal=True)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert tat.backward_plan(B, length, H, D, torch.float32)['q'][
        'q_tile'] == 16
