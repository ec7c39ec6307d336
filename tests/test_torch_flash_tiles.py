"""The tile order of K20's wgmma kernel (`csrc/flash_attention.cu`,
`fwd_wgmma`), emulated in PyTorch on the CPU, against the plain K20
(`ops.flash_attention.flash_attention_fwd_plain`), which the library
flash attention's own tests hold (tests/test_torch_flash_attention.py).

The kernel forms S for one library block of 128 keys as two 64-key
products (two n64 wgmma chains), joins them before the row max, takes p =
2^((s - m') log2 e) (ex2) in fp32 and rounds the unnormalised p to bf16
at the library's point, block by block. The emulation does the same in
the same order and must stay within the bf16 bars that `chip_smoke.py`
holds the kernel to (2 ulp of the largest magnitude, at most 1% of the
outputs differing at all) at L in {128, 256, 384}, causal and not.

Negative control: an online softmax over 64-key blocks (the tempting
shape for the n64 helpers, with p rounded against a running max that
moves every 64 keys) fails the 1% bar at L = 384, so the bar sees the
block size.
"""

import math

import numpy as np
import pytest
import torch

from ddg_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)
SHARE_BAR = 0.01
LOG2E = 1.4426950408889634


def _inputs(L, seed, B=2, H=2, D=64):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal((B, L, H, D)).astype(
        np.float32)).bfloat16() for _ in range(3)]


def bf16_tol(ref):
    m = ref.float().abs().max().item()
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def emulate(q, k, v, causal, sm_scale, key_block=128, halves=2):
    """o of an online softmax over blocks of `key_block` keys in the
    kernel's order: S of a block as `halves` products joined before the
    max, p by ex2 and rounded to v's dtype before its product, acc = acc *
    (l_corr / l') + (round(p) V) / l' in fp32; with one block, p / l
    rounded (the single-step kernel)."""
    B, L, H, D = q.shape
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    o = torch.empty((B, H, L, D))
    rows_n = 64                              # a warpgroup's rows
    n = L // key_block
    for r0 in range(0, L, rows_n):
        rows = slice(r0, r0 + rows_n)
        row = torch.arange(r0, r0 + rows_n)[:, None]
        acc = torch.zeros((B, H, rows_n, D))
        m_prev = torch.full((B, H, rows_n, 1), float('-inf'))
        l_prev = torch.zeros((B, H, rows_n, 1))
        last = r0 // key_block if causal else n - 1
        for c in range(last + 1):
            keys = slice(c * key_block, (c + 1) * key_block)
            w = key_block // halves
            s = torch.cat([qh[:, :, rows] @ kh[:, :, c * key_block + i * w:
                                                c * key_block + (i + 1) * w]
                           .transpose(-1, -2) for i in range(halves)], -1)
            x = s * sm_scale
            if causal:
                key = torch.arange(c * key_block, (c + 1) * key_block)[None]
                x = torch.where(key > row, float('-inf'), x)
            mx = x.amax(-1, keepdim=True)
            mn = mx if n == 1 else torch.maximum(m_prev, mx)
            p = torch.exp2((x - mn) * LOG2E)
            total = p.sum(-1, keepdim=True)
            if n == 1:
                p = p / total
                corr, inv, l_next = 0.0, 1.0, total
            else:
                l_corr = torch.exp(m_prev - mn) * l_prev
                l_next = total + l_corr
                inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
                corr = l_corr * inv
            oc = p.to(v.dtype).float() @ vh[:, :, keys]
            acc = acc * corr + oc * inv
            m_prev, l_prev = mn, l_next
        o[:, :, rows] = acc
    return o.transpose(1, 2).to(q.dtype).contiguous()


def _share(got, want):
    return (got != want).float().mean().item()


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('L', [128, 256, 384])
def test_kernel_order_within_the_bars(L, causal):
    q, k, v = _inputs(L, seed=L + causal)
    sc = 1.0 / math.sqrt(64)
    want = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                        sm_scale=sc)[0]
    got = emulate(q, k, v, causal, sc)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= bf16_tol(want), (err, bf16_tol(want))
    assert _share(got, want) <= SHARE_BAR, _share(got, want)


def test_64_key_blocks_fail_the_share_bar():
    """The same online softmax over 64-key blocks moves the rounding point
    of p: far more than SHARE_BAR of the outputs differ at L=384 (the
    2-ulp bar alone would pass it)."""
    q, k, v = _inputs(384, seed=384)
    sc = 1.0 / math.sqrt(64)
    want = fa.flash_attention_fwd_plain(q, k, v, sm_scale=sc)[0]
    ours = emulate(q, k, v, False, sc)
    small = emulate(q, k, v, False, sc, key_block=64, halves=1)
    assert _share(ours, want) <= SHARE_BAR
    assert (small.float() - want.float()).abs().max() <= bf16_tol(want)
    assert _share(small, want) > SHARE_BAR, _share(small, want)
