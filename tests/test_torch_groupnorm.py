"""The port's GroupNorm (+ SiLU) (`ddg_tpu_torch.ops.groupnorm`, the plain
version on the CPU) against the Pallas kernel of
`ddg_tpu/ops/groupnorm_pallas.py` in interpret mode, on the same numpy-
seeded inputs: float32 outputs to 1e-5 abs, bfloat16 outputs to 2 ulp of
the largest magnitude (one rounding flip of the shared fp32 value is 1
ulp)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops.groupnorm_pallas import fused_group_norm_act as jgn
from ddg_tpu_torch.ops import groupnorm

torch.set_num_threads(1)
N, H, W = 2, 4, 4


def _bf16_tol(ref):
    m = float(np.abs(ref).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


@pytest.mark.parametrize('C, groups', [(16, 4), (48, 12), (128, 32)])
@pytest.mark.parametrize('act', [False, True], ids=['norm', 'norm_silu'])
@pytest.mark.parametrize('out', ['f32', 'bf16'])
def test_matches_pallas(C, groups, act, out):
    r = np.random.RandomState(C + act)
    # bf16 inputs (the trunk's dtype) with a nonzero mean per group.
    x = (0.5 + 2.0 * r.randn(N, H, W, C)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    scale = (1.0 + 0.2 * r.randn(C)).astype(np.float32)
    bias = (0.2 * r.randn(C)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if out == 'f32'
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jgn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                          jnp.asarray(bias), num_groups=groups, act=act,
                          out_dtype=jdt, interpret=True).astype(jnp.float32))
    got = groupnorm.fused_group_norm_act(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
        torch.from_numpy(bias), num_groups=groups, act=act, out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (N, H, W, C)
    tol = 1e-5 if out == 'f32' else _bf16_tol(want)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_float32_input_defaults_to_its_dtype():
    r = np.random.RandomState(3)
    x = r.randn(N, H, W, 32).astype(np.float32)
    scale, bias = np.ones(32, np.float32), np.zeros(32, np.float32)
    want = np.asarray(jgn(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias), num_groups=8, interpret=True))
    got = groupnorm.fused_group_norm_act(
        *(torch.from_numpy(a) for a in (x, scale, bias)), num_groups=8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_no_fallback_off_the_cpu():
    """A tensor on neither the CPU nor a CUDA card is refused, not run
    through the plain version."""
    x = torch.empty((N, H, W, 16), device='meta')
    s = torch.ones(16, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        groupnorm.fused_group_norm_act(x, s, s, num_groups=4)
