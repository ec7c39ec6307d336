"""The port's fused uniform-state denoise steps K9/K10 (`ddg_tpu_torch.ops.
fused_sampling`, plain versions on the CPU) against the Pallas kernels of
`ddg_tpu/ops/fused_sampling.py` in interpret mode, fed the same Gumbel
noise: the tokens are identical wherever the top-two perturbed scores
differ by more than 1e-4. Vocabularies that are not a multiple of 32, and
logits with columns past the vocabulary, are included. The plain
version's own noise (from its seed) is held against the exact posterior
by total variation."""

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
    xt = r.randint(0, V, (B, L)).astype(np.int32)
    a_t = r.uniform(0.05, 0.8, B).astype(np.float32)
    a_s = (a_t + (1 - a_t) * r.uniform(0.1, 0.9, B)).astype(np.float32)
    g = r.gumbel(size=(B, L, V)).astype(np.float32)
    jl = [jnp.asarray(a).astype(dtype) for a in (lc, lu)]
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tl = [torch.from_numpy(a).to(tdt) for a in (lc, lu)]
    return jl, tl, xt, a_t, a_s, g


@pytest.mark.parametrize('V, vocab', [(33, 33), (256, 256), (40, 35)])
@pytest.mark.parametrize('dtype', [jnp.float32, jnp.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('cfg', [False, True], ids=['plain', 'cfg'])
def test_matches_pallas_with_the_same_noise(V, vocab, dtype, cfg):
    jl, tl, xt, a_t, a_s, g = _inputs(V, dtype, seed=V + cfg)
    xtt, att, ast, gt = (torch.from_numpy(a) for a in (xt, a_t, a_s, g))
    jargs = (jnp.asarray(xt),)
    if cfg:
        want = jfs.fused_uniform_cfg_sample(
            3, *jargs, jl[0], jl[1], GAMMA, jnp.asarray(a_t),
            jnp.asarray(a_s), vocab_size=vocab, interpret=True,
            gumbel=jnp.asarray(g))
        got = tfs.fused_uniform_cfg_sample(3, xtt, tl[0], tl[1], GAMMA, att,
                                           ast, vocab_size=vocab, gumbel=gt)
        log_q = tfs.uniform_cfg_log_num(tl[0], tl[1], GAMMA, xtt, att, ast,
                                        vocab_size=vocab)
    else:
        want = jfs.fused_uniform_sample(
            3, *jargs, jl[0], jnp.asarray(a_t), jnp.asarray(a_s),
            vocab_size=vocab, interpret=True, gumbel=jnp.asarray(g))
        got = tfs.fused_uniform_sample(3, xtt, tl[0], att, ast,
                                       vocab_size=vocab, gumbel=gt)
        log_q = tfs.uniform_log_num(tl[0], xtt, att, ast, vocab_size=vocab)
    assert got.dtype == torch.int32 and got.shape == (B, L)
    scores = tfs.uniform_perturbed_scores(3, log_q, vocab_size=vocab,
                                          gumbel=gt)
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > MARGIN
    assert decided.float().mean() > 0.9
    want = torch.from_numpy(np.array(want))
    np.testing.assert_array_equal(got[decided].numpy(),
                                  want[decided].numpy())
    assert ((got >= 0) & (got < vocab)).all()


@pytest.mark.parametrize('cfg', [False, True], ids=['plain', 'cfg'])
def test_ties_go_to_the_lowest_index(cfg):
    """alpha(t) = 0 makes every column's numerator equal: a tie over the
    whole vocabulary."""
    V = 40
    z = np.zeros((B, L, V), np.float32)
    xt = np.full((B, L), 7, np.int32)
    a_t = np.zeros(B, np.float32)
    a_s = np.full(B, 0.5, np.float32)
    g = np.zeros_like(z)
    t = torch.from_numpy
    if cfg:
        want = jfs.fused_uniform_cfg_sample(
            0, jnp.asarray(xt), jnp.asarray(z), jnp.asarray(z), GAMMA,
            jnp.asarray(a_t), jnp.asarray(a_s), vocab_size=V,
            interpret=True, gumbel=jnp.asarray(g))
        got = tfs.fused_uniform_cfg_sample(0, t(xt), t(z), t(z), GAMMA,
                                           t(a_t), t(a_s), vocab_size=V,
                                           gumbel=t(g))
    else:
        want = jfs.fused_uniform_sample(
            0, jnp.asarray(xt), jnp.asarray(z), jnp.asarray(a_t),
            jnp.asarray(a_s), vocab_size=V, interpret=True,
            gumbel=jnp.asarray(g))
        got = tfs.fused_uniform_sample(0, t(xt), t(z), t(a_t), t(a_s),
                                       vocab_size=V, gumbel=t(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 0).all()


@pytest.mark.parametrize('cfg', [False, True], ids=['plain', 'cfg'])
def test_own_noise_draws_the_exact_posterior(cfg):
    """TV of N draws against the exact posterior stays below twice the
    binomial floor 0.5 * sum_v sqrt(2 q_v (1 - q_v) / (pi N))."""
    V, vocab, rows = 14, 12, 8192
    r = np.random.RandomState(7)
    rc, ru = (torch.from_numpy(r.randn(V).astype(np.float32))
              for _ in range(2))
    xt = torch.full((1, rows), 3, dtype=torch.int32)
    a_t, a_s = torch.tensor([0.3]), torch.tensor([0.6])
    lc, lu = rc.expand(1, rows, V), ru.expand(1, rows, V)
    if cfg:
        out = tfs.fused_uniform_cfg_sample(11, xt, lc, lu, GAMMA, a_t, a_s,
                                           vocab_size=vocab)
        log_q = tfs.uniform_cfg_log_num(lc[:, :1], lu[:, :1], GAMMA,
                                        xt[:, :1], a_t, a_s,
                                        vocab_size=vocab)
    else:
        out = tfs.fused_uniform_sample(11, xt, lc, a_t, a_s,
                                       vocab_size=vocab)
        log_q = tfs.uniform_log_num(lc[:, :1], xt[:, :1], a_t, a_s,
                                    vocab_size=vocab)
    q = torch.softmax(log_q.flatten().double(), -1)
    assert q[vocab:].sum() == 0
    hist = torch.bincount(out.flatten().long(), minlength=V).double() / rows
    tv = 0.5 * (hist - q).abs().sum().item()
    floor = 0.5 * torch.sqrt(2 * q * (1 - q) / (math.pi * rows)).sum().item()
    assert tv < 2 * floor, (tv, floor)


def test_no_fallback_off_the_cpu():
    """A tensor on neither the CPU nor a CUDA card is refused."""
    z = torch.empty((B, L, 8), device='meta')
    xt = torch.empty((B, L), dtype=torch.int32, device='meta')
    a = torch.empty((B,), device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        tfs.fused_uniform_sample(0, xt, z, a, a, vocab_size=8)
    with pytest.raises(ValueError, match='CUDA'):
        tfs.fused_uniform_cfg_sample(0, xt, z, z, GAMMA, a, a, vocab_size=8)
