"""`ops.flash_attention.flash_plan`, the Python mirror of the launch plan
of K20-K22 (`csrc/flash_attention.cu`, `ddg_flash_attention_plan`; on
the card `chip_smoke.check_flash_plan` holds the two equal): the path each
kernel takes, its shared memory under the H100's 232,448 bytes a block at
every shape the wrappers take (every D up to 512 at L = 128, the library's
multiples of 128 past one key block), grids that cover L, and the
refusals (the library's, and D past 512)."""

import pytest
import torch

from ddg_tpu_torch.ops import flash_attention as fa

SMEM_MAX = 232448
KERNELS = ('fwd', 'dkv', 'dq')


def _shapes():
    """(L, D) of every head width the wrappers take: any D at L = 128,
    up to 128 and the multiples of 128 past it at L = 256 and 384."""
    for D in range(1, fa.D_MAX + 1):
        yield 128, D
        if D <= 128 or D % 128 == 0:
            yield 256, D
            yield 384, D


@pytest.mark.parametrize('aligned', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_shared_memory_fits_every_shape(dtype, aligned):
    for L, D in _shapes():
        plan = fa.flash_plan(2, L, 3, D, dtype, aligned=aligned)
        for kern in KERNELS:
            p = plan[kern]
            assert 0 < p['smem'] <= SMEM_MAX, (L, D, kern, p)
            assert p['grid'] == (L // p['tile'], 3, 2), (L, D, kern, p)
            assert L % p['tile'] == 0
            assert p['threads'] == (128 if p['path'] == 2 else 256)


@pytest.mark.parametrize('L', [128, 256, 384, 1024])
def test_bf16_d64_takes_wgmma(L):
    plan = fa.flash_plan(4, L, 12, 64, torch.bfloat16)
    assert [plan[k]['path'] for k in KERNELS] == [2, 2, 2]
    assert fa.PATHS[plan['fwd']['path']] == 'wgmma'
    # One warpgroup: 64 query rows (K20, K22) or keys (K21) a block; K20
    # takes a library block of 128 keys a step, K21 64 query rows, K22 64
    # keys through a three-stage ring.
    assert (plan['fwd']['tile'], plan['fwd']['step']) == (64, 128)
    assert (plan['dkv']['tile'], plan['dkv']['step']) == (64, 64)
    assert (plan['dq']['tile'], plan['dq']['step'],
            plan['dq']['stages']) == (64, 64, 3)
    assert all(plan[k]['threads'] == 128 for k in KERNELS)
    assert plan['dq']['grid'] == (L // 64, 12, 4)
    # Three blocks an SM of each: K20's take 72 KB, K21's 66 KB, K22's 64.
    for k in KERNELS:
        assert 3 * plan[k]['smem'] <= 228 * 1024
    assert plan['dq']['smem'] == 64 * 1024


@pytest.mark.parametrize('dtype, D, aligned, path', [
    (torch.bfloat16, 48, True, 1), (torch.bfloat16, 32, True, 1),
    (torch.bfloat16, 64, False, 0), (torch.float32, 64, True, 0),
    (torch.bfloat16, 128, True, 0)])
def test_k22_keeps_its_old_paths_elsewhere(dtype, D, aligned, path):
    """Only bf16 D = 64 on 16-byte rows moved to wgmma; K22's mma.sync
    kernel (128 rows a block, 64 keys a step) and CUDA-core kernel keep
    the other shapes."""
    dq = fa.flash_plan(2, 256, 2, D, dtype, aligned=aligned)['dq']
    assert dq['path'] == path
    if path == 1:
        assert (dq['tile'], dq['step'], dq['threads']) == (128, 64, 256)


@pytest.mark.parametrize('D', [16, 32, 48])
def test_other_tensor_core_widths_take_mma_sync(D):
    plan = fa.flash_plan(2, 256, 2, D, torch.bfloat16)
    assert [plan[k]['path'] for k in KERNELS] == [1, 1, 1]


@pytest.mark.parametrize('dtype, D, aligned', [
    (torch.float32, 64, True), (torch.bfloat16, 64, False),
    (torch.bfloat16, 40, True), (torch.bfloat16, 128, True)])
def test_everything_else_takes_the_cuda_cores(dtype, D, aligned):
    plan = fa.flash_plan(2, 256, 2, D, dtype, aligned=aligned)
    assert [plan[k]['path'] for k in KERNELS] == [0, 0, 0]
    assert plan['fwd']['tile'] == plan['dkv']['tile'] == 32


@pytest.mark.parametrize('L, D', [(256, 384), (256, 512), (128, 300)])
def test_wide_heads_shrink_the_backward_tiles(L, D):
    """Past D = 256 the CUDA-core backwards own 16 keys (K21) or rows
    (K22) a block, so the fp32 tiles fit; the forward keeps 32."""
    plan = fa.flash_plan(2, L, 2, D, torch.float32)
    assert plan['fwd']['tile'] == 32
    assert plan['dkv']['tile'] == plan['dq']['tile'] == 16
    assert max(plan[k]['smem'] for k in KERNELS) <= SMEM_MAX


@pytest.mark.parametrize('L, D, exc', [
    (128, 513, ValueError), (128, 640, ValueError), (256, 1024, ValueError),
    (256, 160, NotImplementedError), (200, 64, ValueError),
    (64, 64, ValueError)])
def test_refusals(L, D, exc):
    with pytest.raises(exc):
        fa.flash_plan(2, L, 2, D, torch.bfloat16)


def test_the_wrappers_refuse_past_512_on_the_cpu_too():
    """The plain versions follow the library (which has no head-width
    bound at L = 128), but the plan and the card's wrappers stop at
    D_MAX = 512."""
    assert fa.D_MAX == 512
    q = torch.zeros((1, 128, 1, 520))
    o, l, m = fa.flash_attention_fwd(q, q, q, sm_scale=0.1)
    assert o.shape == q.shape
    with pytest.raises(ValueError):
        fa.flash_plan(1, 128, 1, 520, torch.float32)
