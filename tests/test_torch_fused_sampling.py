"""The port's fused absorbing denoise step (`ddg_tpu_torch.ops.
fused_sampling`, plain versions on the CPU) against the Pallas kernels of
`ddg_tpu/ops/fused_sampling.py` in interpret mode, fed the same Gumbel
noise: the tokens are identical wherever the top-two perturbed scores
differ by more than 1e-4. The plain version's own noise (from its seed) is
held against the exact posterior by total variation."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops import fused_sampling as jfs
from ddg_tpu_torch.ops import fused_sampling as tfs

torch.set_num_threads(1)
B, L = 2, 16
MARGIN = 1e-4
GAMMA = 2.0


def _inputs(V, dtype, seed):
    r = np.random.RandomState(seed)
    lc = (r.randn(B, L, V) * 3).astype(np.float32)
    lu = (r.randn(B, L, V) * 3).astype(np.float32)
    x0 = r.randint(0, V - 1, (B, L))
    xt = np.where(r.rand(B, L) < 0.6, V - 1, x0).astype(np.int32)
    mct = r.uniform(0.4, 0.9, B).astype(np.float32)
    mcs = (0.6 * mct).astype(np.float32)
    g = r.gumbel(size=(B, L, V)).astype(np.float32)
    jl = [jnp.asarray(a).astype(dtype) for a in (lc, lu)]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tl = [torch.from_numpy(a).to(tdt) for a in (lc, lu)]
    return jl, tl, xt, mct, mcs, g


def _decided(scores, xt, mask):
    top2 = scores.topk(2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1]) > MARGIN) | (xt != mask)


@pytest.mark.parametrize('V', [33, 1000])
@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('cfg', [False, True], ids=['plain', 'cfg'])
def test_matches_pallas_with_the_same_noise(V, dtype, cfg):
    mask = V - 1
    jl, tl, xt, mct, mcs, g = _inputs(V, dtype, seed=V + cfg)
    xtt, mctt, mcst, gt = (torch.from_numpy(a) for a in (xt, mct, mcs, g))
    if cfg:
        want = jfs.fused_absorbing_cfg_sample(
            3, jnp.asarray(xt), jl[0], jl[1], GAMMA, jnp.asarray(mct),
            jnp.asarray(mcs), mask_index=mask, interpret=True,
            gumbel=jnp.asarray(g))
        got = tfs.fused_absorbing_cfg_sample(3, xtt, tl[0], tl[1], GAMMA,
                                             mctt, mcst, mask_index=mask,
                                             gumbel=gt)
        z = tfs.cfg_mix(tl[0], tl[1], GAMMA)
    else:
        want = jfs.fused_absorbing_sample(
            3, jnp.asarray(xt), jl[0], jnp.asarray(mct), jnp.asarray(mcs),
            mask_index=mask, interpret=True, gumbel=jnp.asarray(g))
        got = tfs.fused_absorbing_sample(3, xtt, tl[0], mctt, mcst,
                                         mask_index=mask, gumbel=gt)
        z = tl[0].float()
    assert got.dtype == torch.int32 and got.shape == (B, L)
    decided = _decided(tfs.perturbed_scores(3, z, mctt, mcst,
                                            mask_index=mask, gumbel=gt),
                       xtt, mask)
    assert decided.float().mean() > 0.9
    want = torch.from_numpy(np.array(want))
    np.testing.assert_array_equal(got[decided].numpy(),
                                  want[decided].numpy())
    # Decoded positions are copied over; masked ones are never the mask
    # when mcs is below the move chance of any token.
    np.testing.assert_array_equal(got[xtt != mask].numpy(),
                                  xt[xt != mask])


@pytest.mark.parametrize('cfg', [False, True], ids=['plain', 'cfg'])
def test_ties_go_to_the_lowest_index(cfg):
    V = 40
    z = np.zeros((B, L, V), np.float32)
    xt = np.full((B, L), V - 1, np.int32)
    mct = np.full(B, 0.9, np.float32)
    mcs = np.full(B, 1e-3, np.float32)     # the mask channel loses
    g = np.zeros_like(z)
    if cfg:
        want = jfs.fused_absorbing_cfg_sample(
            0, jnp.asarray(xt), jnp.asarray(z), jnp.asarray(z), GAMMA,
            jnp.asarray(mct), jnp.asarray(mcs), mask_index=V - 1,
            interpret=True, gumbel=jnp.asarray(g))
        got = tfs.fused_absorbing_cfg_sample(
            0, *(torch.from_numpy(a) for a in (xt, z, z)), GAMMA,
            *(torch.from_numpy(a) for a in (mct, mcs)), mask_index=V - 1,
            gumbel=torch.from_numpy(g))
    else:
        want = jfs.fused_absorbing_sample(
            0, jnp.asarray(xt), jnp.asarray(z), jnp.asarray(mct),
            jnp.asarray(mcs), mask_index=V - 1, interpret=True,
            gumbel=jnp.asarray(g))
        got = tfs.fused_absorbing_sample(
            0, *(torch.from_numpy(a) for a in (xt, z, mct, mcs)),
            mask_index=V - 1, gumbel=torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).all()


@pytest.mark.parametrize('cfg', [False, True], ids=['plain', 'cfg'])
def test_own_noise_draws_the_exact_posterior(cfg):
    """TV of N draws against the exact posterior stays below twice the
    binomial floor 0.5 * sum_v sqrt(2 q_v (1 - q_v) / (pi N))."""
    V, rows = 12, 8192
    r = np.random.RandomState(7)
    rc, ru = (torch.from_numpy(r.randn(V).astype(np.float32))
              for _ in range(2))
    xt = torch.full((1, rows), V - 1, dtype=torch.int32)
    mct, mcs = torch.tensor([0.8]), torch.tensor([0.3])
    z_row = GAMMA * rc + (1 - GAMMA) * ru if cfg else rc
    if cfg:
        out = tfs.fused_absorbing_cfg_sample(
            11, xt, rc.expand(1, rows, V), ru.expand(1, rows, V), GAMMA,
            mct, mcs, mask_index=V - 1)
    else:
        out = tfs.fused_absorbing_sample(11, xt, rc.expand(1, rows, V),
                                         mct, mcs, mask_index=V - 1)
    z = z_row.clone()
    z[V - 1] = -1e30
    p = torch.softmax(z, -1).double() * 0.5
    p[V - 1] = 0.3
    q = p / p.sum()
    hist = torch.bincount(out.flatten().long(), minlength=V).double() / rows
    tv = 0.5 * (hist - q).abs().sum().item()
    floor = 0.5 * torch.sqrt(2 * q * (1 - q) / (math.pi * rows)).sum().item()
    assert tv < 2 * floor, (tv, floor)
