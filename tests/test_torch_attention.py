"""The port's fused RoPE attention (`ddg_tpu_torch.ops.attention`, plain
version on the CPU) against `ddg_tpu/ops/attention_pallas.py`'s kernel in
interpret mode: float32, 1e-5 abs, at L=16, 256 and 1024. H * D = 128, so
the JAX function takes its kernel and not its jnp fallback."""

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
ATOL = 1e-5


def _inputs(seed=0, length=L):
    r = np.random.RandomState(seed)
    return [r.randn(B, length, H, DH).astype(np.float32) for _ in range(3)]


def test_rope_tables_match():
    jc, js = jdit.rope_cos_sin(L, DH)
    tc, ts = tdit.rope_cos_sin(L, DH)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


# L=16, text8's L=256 and the reference DiT-small's L=1024
# (configs/model/small.yaml; the case ids of L=16 are the original ones).
LENGTHS = [pytest.param(c, n, id=f'{c}' if n == L else f'{c}-L{n}')
           for n in (L, 256, 1024) for c in (False, True)]


@pytest.mark.parametrize('causal,length', LENGTHS)
def test_fused_rope_attention_matches_pallas(causal, length):
    q, k, v = _inputs(1 + causal, length)
    cos, sin = (np.array(a) for a in jdit.rope_cos_sin(length, DH))
    want = jat.fused_rope_attention(
        *(jnp.asarray(a) for a in (q, k, v, cos, sin)), causal=causal,
        interpret=True)
    got = tat.fused_rope_attention(
        *(torch.from_numpy(a) for a in (q, k, v, cos, sin)), causal=causal)
    assert got.shape == (B, length, H, DH)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_strided_qkv_views_are_accepted():
    """The model hands q, k, v over as views into one fused projection."""
    r = np.random.RandomState(3)
    qkv = torch.from_numpy(r.randn(B, L, 3, H, DH).astype(np.float32))
    cos, sin = tdit.rope_cos_sin(L, DH)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = tat.fused_rope_attention(q, k, v, cos, sin)
    want = tat.fused_rope_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), cos, sin)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_rope_rounds_back_to_the_input_dtype():
    q, _, _ = _inputs(4)
    cos, sin = tdit.rope_cos_sin(L, DH)
    x = torch.from_numpy(q).to(torch.bfloat16)
    got = tat.apply_rope(x, cos, sin)
    assert got.dtype == torch.bfloat16
    want = jdit.apply_rope(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                           jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_non_cpu_tensors_never_take_the_plain_version():
    q = torch.empty((B, L, H, DH), device='meta')
    cos = torch.empty((L, DH // 2), device='meta')
    before = tat.fused_rope_attention.launches
    with pytest.raises(ValueError):
        tat.fused_rope_attention(q, q, q, cos, cos)
    assert tat.fused_rope_attention.launches == before
