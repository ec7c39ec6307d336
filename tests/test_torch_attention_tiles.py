"""The K1/K2 forward kernels' key-tile order and launch plan, on the CPU.

1. A test-local PyTorch mirror of the kernels' two passes over 64-key
   tiles (pass 1: each row's running max and sum, tile by tile; pass 2:
   exp(s - m) / l rounded to the input dtype, then P V in fp32, tile by
   tile) against `ddg_tpu/ops/attention_pallas.py`'s `short_seq_attention`
   and `fused_rope_attention` with interpret=True, at L = 40, 200, 256 and
   1024, causal and not, B=1, H=2, D=64: float32 to 1e-5 abs, bfloat16 to
   2 ulp of the largest magnitude of the JAX output (the card's bar). It
   shows that moving the softmax sum to an online one over key tiles, and
   nothing else, keeps the Pallas kernels' rounding point: in bf16 at most
   1% of the mirror's outputs differ at all from the plain version's,
   which a flash-style order (about 45%) fails.
2. `ops.attention.forward_plan`, the mirror of the C library's
   `ddg_attention_fwd_plan` (held equal to it on the card by
   `chip_smoke.py`): bf16 at D = 64 takes the tensor-core kernel at every
   L, float32 and D = 32 the CUDA-core one, and neither's shared memory
   grows with L or passes the H100's 232,448 bytes a block.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.models import dit as jdit
from ddg_tpu.ops import attention_pallas as jat
from ddg_tpu_torch.ops import attention as tat

torch.set_num_threads(1)
B, H, DH = 1, 2, 64
KEY_TILE = 64
NEG = -1e30
LENGTHS = (40, 200, 256, 1024)
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}
SMEM_MAX = 232448


def two_pass_attention(q, k, v, *, causal):
    """softmax(q k^T / sqrt(D)) v as the kernels order it: (B, L, H, D) in
    q's dtype, fp32 scores, the sum over key tiles of 64 kept online."""
    dt, L = q.dtype, q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, k32, v32 = q.float(), k.float(), v.float()
    rows = torch.arange(L)[:, None]
    tiles = [(j0, min(j0 + KEY_TILE, L)) for j0 in range(0, L, KEY_TILE)]

    def scores(j0, j1):
        s = torch.einsum('bqhd,bkhd->bhqk', q32, k32[:, j0:j1]) * scale
        if causal:
            s = torch.where(torch.arange(j0, j1)[None, :] <= rows, s,
                            torch.full_like(s, NEG))
        return s

    m = torch.full(q.shape[:1] + (q.shape[2], L), NEG)
    l = torch.zeros_like(m)
    for j0, j1 in tiles:
        s = scores(j0, j1)
        mn = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - mn) + torch.exp(s - mn[..., None]).sum(-1)
        m = mn
    o = torch.zeros(q.shape[0], q.shape[2], L, q.shape[3])
    for j0, j1 in tiles:
        p = torch.exp(scores(j0, j1) - m[..., None]) / l[..., None]
        o = o + torch.einsum('bhqk,bkhd->bhqd', p.to(dt).float(),
                             v32[:, j0:j1])
    return o.permute(0, 2, 1, 3).to(dt)


def _inputs(seed, length):
    r = np.random.RandomState(seed)
    return [r.randn(B, length, H, DH).astype(np.float32) for _ in range(3)]


def _assert_close(got, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    tol = 2.0 * 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('length', LENGTHS)
def test_two_pass_tiles_match_short_seq_pallas(length, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _inputs(30 + length + causal, length)
    want = jat.short_seq_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), causal=causal,
        interpret=True)
    got = two_pass_attention(*(torch.from_numpy(a).to(tdt)
                               for a in (q, k, v)), causal=causal)
    assert got.shape == (B, length, H, DH) and got.dtype == tdt
    _assert_close(got, want, dtype)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('length', LENGTHS)
def test_two_pass_tiles_match_fused_rope_pallas(length, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _inputs(50 + length + causal, length)
    cos, sin = (np.array(a) for a in jdit.rope_cos_sin(length, DH))
    want = jat.fused_rope_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(cos),
        jnp.asarray(sin), causal=causal, interpret=True)
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    ct, st = torch.from_numpy(cos), torch.from_numpy(sin)
    got = two_pass_attention(tat.apply_rope(qt, ct, st),
                             tat.apply_rope(kt, ct, st), vt, causal=causal)
    assert got.shape == (B, length, H, DH) and got.dtype == tdt
    _assert_close(got, want, dtype)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('length', LENGTHS)
def test_two_pass_tiles_keep_the_rounding_point(length, causal):
    """The 2-ulp bar does not tell rounding points apart; bit equality
    does. In bf16 the mirror equals the port's plain version (P normalised
    in fp32, then rounded) in all but at most 1% of the elements (0 to
    0.12% here: the online sum moves l by a few fp32 ulps, the tiled P V
    sums in another order). Rounding exp(s - m) before the division, as a
    flash-style online softmax does, changes about 45% of them."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(7 + length, length))
    got = two_pass_attention(q, k, v, causal=causal)
    want = tat.attention_plain(q, k, v, causal=causal)
    assert (got != want).float().mean().item() <= 0.01


@pytest.mark.parametrize('length', LENGTHS[:1] + (128,) + LENGTHS[1:])
def test_bf16_at_d64_takes_the_tensor_cores_at_every_length(length):
    plan = tat.forward_plan(48, length, 12, 64, torch.bfloat16)
    assert plan['path'] == 1 and plan['threads'] == 256
    assert (plan['q_tile'], plan['k_tile'], plan['stages']) == (128, 64, 2)
    assert plan['grid'] == (-(-length // 128), 12, 48)


@pytest.mark.parametrize('dtype,D,aligned', [
    (torch.float32, 64, True), (torch.bfloat16, 32, True),
    (torch.float32, 32, True), (torch.bfloat16, 64, False)])
def test_fp32_other_d_and_unaligned_rows_take_the_cuda_cores(dtype, D,
                                                             aligned):
    for length in LENGTHS:
        plan = tat.forward_plan(4, length, 3, D, dtype, aligned=aligned)
        assert plan['path'] == 0 and plan['threads'] == 256
        assert (plan['q_tile'], plan['k_tile'], plan['stages']) == (32, 64, 1)
        assert plan['grid'] == (-(-length // 32), 3, 4)


@pytest.mark.parametrize('dtype,D', [(torch.bfloat16, 64),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 128)])
def test_shared_memory_does_not_grow_with_length(dtype, D):
    smem = {tat.forward_plan(2, n, 2, D, dtype)['smem']
            for n in (1, 40, 128, 200, 256, 1024, 8192)}
    assert len(smem) == 1 and smem.pop() <= SMEM_MAX


def test_shapes_no_kernel_takes_raise():
    # 290 is the widest even head the CUDA-core kernel's shared memory
    # holds: (192 D + 2112) floats.
    assert tat.forward_plan(1, 16, 1, 290, torch.float32)['smem'] <= SMEM_MAX
    for args in ((1, 16, 1, 292, torch.float32), (1, 16, 1, 63,
                                                 torch.bfloat16),
                 (0, 16, 1, 64, torch.bfloat16),
                 (1, 16, 1, 64, torch.float16)):
        with pytest.raises(ValueError):
            tat.forward_plan(*args)
