"""The K1b/K2b backward kernels' tile order and launch plan, on the CPU.

1. A test-local PyTorch mirror of the two launches' order:
   kernel Q walks 64-key tiles twice. Pass A is the forward mirror's pass 1
   (each row's running max m and sum l, tile by tile) with delta's running
   sum carried beside l (exp(s - m_running) times the rounded dP, rescaled
   as m grows) and multiplied by 1 / l at the end; pass B forms P =
   exp(s - m) / l, dP rounded to the input dtype, dS = (P dP - P delta) /
   sqrt(D) in fp32, and sums dq' += dS k' tile by tile, in bf16 as two
   terms (dS rounded to bf16, and the rounded remainder) as the tensor
   cores take it. Kernel KV walks 64-row query tiles in order with the
   rows' m, 1 / l and delta: dv += round(P)^T dO, dk' += dS^T q' (two terms
   in bf16). It is held against `jax.vjp` of `ddg_tpu/ops/
   attention_pallas.py`'s `short_seq_attention` and `fused_rope_attention`
   with interpret=True (their custom VJPs `_flash_bwd` and
   `_rope_flash_bwd`) at L = 40, 200, 256 and 1024, causal and not, B=1,
   H=2, D=64: float32 to 1e-5 abs, bfloat16 to 2 ulp of the largest
   magnitude of the JAX output (the card's bar). In bf16 under 2% of the
   mirror's dq, dk and dv differ at all from the plain backward's (the
   2-ulp bar does not tell rounding points apart; bit equality does).
2. `ops.attention.backward_plan`, the mirror of the C library's
   `ddg_attention_bwd_plan` (held equal to it on the card by
   `chip_smoke.py`): bf16 at D = 64 takes the tensor-core kernels at every
   L up to 8192 (K1b first rotating q and k once in a launch of its own),
   float32, unaligned rows and D = 32 the CUDA-core ones,
   neither's shared memory grows with L or passes the H100's 232,448 bytes
   a block, and the shapes no kernel takes raise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.models import dit as jdit
from ddg_tpu.ops import attention_pallas as jat
from ddg_tpu_torch.ops import attention as tat

torch.set_num_threads(1)
B, H, DH = 1, 2, 64
TILE = 64
NEG = -1e30
LENGTHS = (40, 200, 256, 1024)
DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}
SMEM_MAX = 232448


def _two_terms(x):
    """x (fp32) as the tensor cores take it: bf16(x) + bf16(x - bf16(x))."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def tiled_backward(q, k, v, do, *, causal):
    """(dq', dk', dv) of softmax(q k^T / sqrt(D)) v for (B, L, H, D) q, k
    (as the products take them), v and do, in the kernels' order; q's
    dtype."""
    dt, L = q.dtype, q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])

    def heads(x):                   # (B, L, H, D) -> (B, H, L, D) fp32
        return x.float().permute(0, 2, 1, 3)

    q32, k32, v32, do32 = heads(q), heads(k), heads(v), heads(do.to(dt))
    tiles = [(j0, min(j0 + TILE, L)) for j0 in range(0, L, TILE)]
    products = ((lambda ds, x: sum(t @ x for t in _two_terms(ds)))
                if dt == torch.bfloat16 else (lambda ds, x: ds @ x))

    def scores(i0, i1, j0, j1):
        s = q32[:, :, i0:i1] @ k32[:, :, j0:j1].transpose(-1, -2) * scale
        if causal:
            keep = (torch.arange(j0, j1)[None, :]
                    <= torch.arange(i0, i1)[:, None])
            s = torch.where(keep, s, torch.full_like(s, NEG))
        return s

    def dprob(i0, i1, j0, j1):
        dp = do32[:, :, i0:i1] @ v32[:, :, j0:j1].transpose(-1, -2)
        return dp.to(dt).float()

    # Kernel Q, pass A: m and l as the forward's pass 1, delta's sum beside.
    m = torch.full(q32.shape[:3], NEG)
    l, dl = torch.zeros_like(m), torch.zeros_like(m)
    for j0, j1 in tiles:
        s, dp = scores(0, L, j0, j1), dprob(0, L, j0, j1)
        mn = torch.maximum(m, s.amax(-1))
        f, e = torch.exp(m - mn), torch.exp(s - mn[..., None])
        l, dl, m = l * f + e.sum(-1), dl * f + (e * dp).sum(-1), mn
    rl = 1.0 / l
    delta = dl * rl

    def dscore(i0, i1, j0, j1):
        p = torch.exp(scores(i0, i1, j0, j1) - m[..., i0:i1, None]) \
            * rl[..., i0:i1, None]
        dp = dprob(i0, i1, j0, j1)
        return p, (p * dp - p * delta[..., i0:i1, None]) * scale

    # Kernel Q, pass B: dq' over the key tiles.
    dq = torch.zeros_like(q32)
    for j0, j1 in tiles:
        dq = dq + products(dscore(0, L, j0, j1)[1], k32[:, :, j0:j1])
    # Kernel KV: dk' and dv over the query tiles, in order.
    dk, dv = torch.zeros_like(k32), torch.zeros_like(v32)
    for i0, i1 in tiles:
        p, ds = dscore(i0, i1, 0, L)
        dv = dv + p.to(dt).float().transpose(-1, -2) @ do32[:, :, i0:i1]
        dk = dk + products(ds.transpose(-1, -2), q32[:, :, i0:i1])
    return tuple(x.permute(0, 2, 1, 3).to(dt) for x in (dq, dk, dv))


def _inputs(seed, length):
    r = np.random.RandomState(seed)
    return [r.randn(B, length, H, DH).astype(np.float32) for _ in range(4)]


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
def test_tiled_backward_matches_short_seq_pallas_vjp(length, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(60 + length + causal, length)
    _, vjp = jax.vjp(
        lambda q, k, v: jat.short_seq_attention(q, k, v, causal=causal,
                                                interpret=True),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do).astype(jdt))
    got = tiled_backward(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, do)),
                         causal=causal)
    for g, w in zip(got, want):
        assert g.shape == (B, length, H, DH) and g.dtype == tdt
        _assert_close(g, w, dtype)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('length', LENGTHS)
def test_tiled_backward_matches_fused_rope_pallas_vjp(length, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(80 + length + causal, length)
    cos, sin = (np.array(a) for a in jdit.rope_cos_sin(length, DH))
    _, vjp = jax.vjp(
        lambda q, k, v: jat.fused_rope_attention(
            q, k, v, jnp.asarray(cos), jnp.asarray(sin), causal=causal,
            interpret=True),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do).astype(jdt))
    qt, kt, vt, dot = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    ct, st = torch.from_numpy(cos), torch.from_numpy(sin)
    dq, dk, dv = tiled_backward(tat.apply_rope(qt, ct, st),
                                tat.apply_rope(kt, ct, st), vt, dot,
                                causal=causal)
    got = tat.unrotate(dq, ct, st), tat.unrotate(dk, ct, st), dv
    for g, w in zip(got, want):
        assert g.shape == (B, length, H, DH) and g.dtype == tdt
        _assert_close(g, w, dtype)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('length', LENGTHS)
def test_tiled_backward_keeps_the_rounding_points(length, causal):
    """In bf16 the mirror's dq, dk and dv each equal the plain backward's
    (which rounds where the VJP rounds) in all but under 2% of the
    elements (0.1 to 0.3% here: dS in two bf16 terms and the tiled sums
    move the fp32 values by a few ulps before their rounding)."""
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(9 + length, length))
    got = tiled_backward(q, k, v, do, causal=causal)
    want = tat.short_seq_attention_bwd_plain(q, k, v, do, causal=causal)
    for g, w in zip(got, want):
        assert (g != w).float().mean().item() < 0.02


@pytest.mark.parametrize('length', (1, 40, 128, 200, 256, 1024, 8192))
def test_bf16_at_d64_takes_the_tensor_cores_at_every_length(length):
    plan = tat.backward_plan(48, length, 12, 64, torch.bfloat16)
    grid = (-(-length // 128), 12, 48)
    assert plan['path'] == 1
    assert plan['stats_len'] == -(-length // 64) * 64
    assert (plan['q']['q_tile'], plan['q']['k_tile'], plan['q']['stages'],
            plan['q']['threads'], plan['q']['grid']) == (128, 64, 2, 256, grid)
    assert (plan['kv']['q_tile'], plan['kv']['k_tile'], plan['kv']['stages'],
            plan['kv']['threads'], plan['kv']['grid']) == (64, 128, 2, 256,
                                                           grid)
    # K1b rotates q and k once first: a thread per 8 pairs of a row.
    assert plan['rope'] == dict(threads=256,
                                grid=(-(-48 * length * 12 * 4 // 256), 2, 1))


@pytest.mark.parametrize('dtype,D,aligned', [
    (torch.float32, 64, True), (torch.bfloat16, 32, True),
    (torch.float32, 32, True), (torch.bfloat16, 64, False)])
def test_fp32_other_d_and_unaligned_rows_take_the_cuda_cores(dtype, D,
                                                             aligned):
    for length in LENGTHS:
        plan = tat.backward_plan(4, length, 3, D, dtype, aligned=aligned)
        assert plan['path'] == 0
        assert (plan['q']['q_tile'], plan['q']['k_tile'], plan['q']['stages'],
                plan['q']['threads']) == (32, 64, 1, 256)
        assert plan['q']['grid'] == (-(-length // 32), 3, 4)
        assert (plan['kv']['q_tile'], plan['kv']['k_tile'],
                plan['kv']['stages'], plan['kv']['threads']) == (32, 64, 1,
                                                                 256)
        assert plan['kv']['grid'] == (-(-length // 64), 3, 4)
        assert plan['rope'] is None


@pytest.mark.parametrize('dtype,D', [(torch.bfloat16, 64),
                                     (torch.float32, 64),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 128)])
def test_shared_memory_does_not_grow_with_length(dtype, D):
    for launch in ('q', 'kv'):
        smem = {tat.backward_plan(2, n, 2, D, dtype)[launch]['smem']
                for n in (1, 40, 128, 200, 256, 1024, 8192)}
        assert len(smem) == 1 and smem.pop() <= SMEM_MAX


def test_shapes_no_kernel_takes_raise():
    # 174 is the widest even head the CUDA-core kernels' 32-row, 64-key
    # tiles hold ((320 D + 2400) floats for the key-tile kernel); past it
    # they halve, up to 290, the widest head the CUDA-core forward takes
    # (ROADMAP C.7): the backward refuses 292 as the forward does.
    plan = tat.backward_plan(1, 16, 1, 174, torch.float32)
    assert max(plan['q']['smem'], plan['kv']['smem']) <= SMEM_MAX
    assert (plan['q']['q_tile'], plan['q']['k_tile']) == (32, 64)
    for D in range(176, 292, 2):
        plan = tat.backward_plan(1, 16, 1, D, torch.float32)
        assert max(plan['q']['smem'], plan['kv']['smem']) <= SMEM_MAX
        assert (plan['q']['q_tile'], plan['q']['k_tile']) == (16, 32)
        assert plan['kv']['grid'] == (1, 1, 1)
    tat.forward_plan(1, 16, 1, 290, torch.float32)
    with pytest.raises(ValueError):
        tat.forward_plan(1, 16, 1, 292, torch.float32)
    for args in ((1, 16, 1, 292, torch.float32), (1, 16, 1, 63,
                                                 torch.bfloat16),
                 (0, 16, 1, 64, torch.bfloat16), (1, 0, 1, 64, torch.float32),
                 (1, 16, 1, 64, torch.float16)):
        with pytest.raises(ValueError):
            tat.backward_plan(*args)
