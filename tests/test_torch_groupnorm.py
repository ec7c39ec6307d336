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


def _unet_norms():
    """{(H, W, C, act, groups): count} of one forward of the CIFAR10 UNet
    (`entry.unet_flagship`'s configuration), read by hooks on its GNorm
    modules during a B=1 forward on the meta device (shapes only), as
    `chip_smoke.unet_forward_census` reads them on the card."""
    import dataclasses

    from ddg_tpu_torch.models import unet as U
    cfg = dataclasses.replace(
        U.UNetConfig(ch=128, num_res_blocks=2, num_scales=4,
                     ch_mult=(1, 2, 2, 2), image_size=32),
        num_classes=10, dropout=0.0, compute_dtype=torch.float32,
        norm_dtype=torch.float32, fused_norm=False)
    with torch.device('meta'):
        model = U.UNet(cfg)
    norms = {}

    def on_norm(mod, args):
        key = (*args[0].shape[1:], mod.act, mod.num_groups)
        norms[key] = norms.get(key, 0) + 1
    for m in model.modules():
        if isinstance(m, U.GNorm):
            m.register_forward_pre_hook(on_norm)
    L = cfg.input_channels * cfg.image_size ** 2
    with torch.no_grad():
        model(torch.zeros((1, L), dtype=torch.int32, device='meta'),
              torch.ones((1,), device='meta'),
              torch.zeros((1,), dtype=torch.int32, device='meta'))
    return norms


@pytest.mark.parametrize('in_size', [2, 4], ids=['bf16_in', 'f32_in'])
def test_plan_holds_every_unet_norm_in_one_launch(in_size):
    """At each of the 51 norms of one UNet forward (13 shapes, 4 x 4 x 256
    to 32 x 32 x 384, bf16 or fp32 in), the plan is the slab path: one
    launch, a cluster of 1 to 16 blocks a sample (a power of two) whose
    pixels cover the sample, each block's x, scratch, group sums and
    mbarriers within the card's shared memory."""
    norms = _unet_norms()
    assert sum(norms.values()) == 51 and len(norms) == 13
    for (H, W, C, _, G) in norms:
        path, cs, pix, smem = groupnorm.plan(H * W, C, G, in_size)
        assert path == 1, (H, W, C)
        assert cs in (1, 2, 4, 8, 16) and cs * pix >= H * W > (cs - 1) * pix
        assert pix * C * in_size <= smem <= 232448
        assert smem == (-(-pix * C * in_size // 16) * 16 + 2 * 256 * 8 * 4
                        + 8 * G + 8 * 16)
    # The largest: 32 x 32 x 384 over 16 blocks, 48 KB of bf16 or 96 KB
    # of fp32 x a block.
    assert groupnorm.plan(1024, 384, 32, 2) == (1, 16, 64, 65920)
    assert groupnorm.plan(1024, 384, 32, 4) == (1, 16, 64, 115072)
    assert groupnorm.plan(16, 256, 32, 2) == (1, 1, 16, 24960)


@pytest.mark.parametrize('H, C, in_size, path', [
    (64, 256, 2, 1), (64, 512, 2, 2), (45, 2048, 4, 2), (3, 2048, 4, 1)])
def test_plan_takes_the_two_kernels_past_sixteen_blocks(H, C, in_size, path):
    """A slab whose share over 16 blocks does not fit a block's shared
    memory (64 x 64 x 512 bf16: 256 KB a block) takes the two-kernel path;
    smaller ones, the slab path."""
    assert groupnorm.plan(H * H, C, 32, in_size)[0] == path
