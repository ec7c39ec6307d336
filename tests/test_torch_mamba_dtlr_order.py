"""A torch emulation of the summation order of K17's dt_proj adjoint
(`csrc/mamba_bwd.cu`, the epilogue of `scan_bwd_out_kernel` in its
low-rank form, then `reduce_slices`), held against the float64 adjoint and
against the plain version (`ops.mamba.ssm_scan_dtlr_bwd_plain`); what the
card's dt-lowrank kernels take (`ssm_scan_dtlr_takes`, `ssm_scan_takes`);
and the plain versions at a shape past the old limits against
`selective_scan_pallas_dtlr` in interpret mode.

The kernel's order: pass 3 forms dpre = ddelta sigmoid(pre) for a
sub-chunk of up to 64 rows and the block's tile of 64 channels, then

- ddt_lr[r, k]: per channel tile, fp32 FMAs over the tile's channels in
  channel order (channels past d add zeros), then the tiles' partials
  summed in tile order;
- dW_dt[k, c] and db_dt[c]: per (b, chunk), fp32 FMAs (adds for db) over the
  chunk's rows in row order, carried across its sub-chunks, then the (b,
  chunk) partials summed in order, in groups of 128 and then the groups'
  sums (`reduce_slices`).

The emulation takes each FMA as one float64 product and sum rounded to
float32 (a double rounding, which the bars below do not see). Bars: rtol
1e-4 with atol 1e-4 of the largest magnitude against both references, as
tests/test_torch_mamba_scan_order.py holds the adjoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops.selective_scan_pallas import selective_scan_pallas_dtlr
from ddg_tpu_torch.ops import mamba

torch.set_num_threads(1)
TILE, GROUP = 64, 128


def _fma(a, b, acc):
    return (a.double() * b.double() + acc.double()).float()


def reduce_slices(parts):
    """`reduce_slices`: the sum of parts[0], parts[1], ... from +0 in order,
    in groups of 128 slices, then the groups' sums the same way."""
    while parts.shape[0] > GROUP:
        n = -(-parts.shape[0] // GROUP)
        parts = torch.stack([reduce_slices(parts[i * GROUP:(i + 1) * GROUP])
                             for i in range(n)])
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc


def dt_adjoint_in_kernel_order(ddelta, pre, dt_lr, W_dt, chunk, fma=_fma):
    """(ddt_lr, dW_dt, db_dt) from the adjoint's ddelta (Bt, L, d), pre =
    dt_lr W_dt + b_dt and dt_lr (Bt, L, R), W_dt (R, d), of one float
    dtype, in the kernel's order, each FMA taken by `fma`."""
    Bt, L, d = ddelta.shape
    R = W_dt.shape[0]
    dpre = ddelta * torch.sigmoid(pre)
    tiles = -(-d // TILE)
    pad = tiles * TILE - d
    dp = torch.nn.functional.pad(dpre, (0, pad))
    W = torch.nn.functional.pad(W_dt, (0, pad))
    parts = []
    for t in range(tiles):
        acc = ddelta.new_zeros((Bt, L, R))
        for c in range(t * TILE, (t + 1) * TILE):
            acc = fma(dp[..., c, None], W[None, None, :, c], acc)
        parts.append(acc)
    ddt_lr = reduce_slices(torch.stack(parts))
    nc = L // chunk
    lr = dt_lr.reshape(Bt * nc, chunk, R)
    dpc = dpre.reshape(Bt * nc, chunk, d)
    dW = ddelta.new_zeros((Bt * nc, R, d))
    db = ddelta.new_zeros((Bt * nc, d))
    for r in range(chunk):            # sub-chunks in order: rows in order
        dW = fma(lr[:, r, :, None], dpc[:, r, None, :], dW)
        db = db + dpc[:, r]
    return ddt_lr, reduce_slices(dW), reduce_slices(db)


def _inputs(seed, Bt, L, d, N, R):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((r.randn(*shape) * scale).astype(np.float32))

    return (f(Bt, L, d), f(Bt, L, R), f(R, d, scale=R ** -0.5),
            f(d, scale=0.5) - 3.0, -torch.exp(f(d, N, scale=0.5)),
            f(Bt, L, N), f(Bt, L, N), f(d), f(Bt, L, d)), f(Bt, L, d)


# (Bt, L, d, R, chunk): two channel tiles (the second ragged) and R off the
# multiples of 4; two sub-chunks a chunk; 256 (b, chunk) slices, which
# reduce_slices sums as two groups of 128.
CASES = [(2, 256, 80, 6, 128), (1, 192, 64, 16, 64), (2, 2048, 16, 3, 16)]


@pytest.mark.parametrize('Bt, L, d, R, chunk', CASES)
def test_emulated_order_within_the_bars(Bt, L, d, R, chunk):
    args, g = _inputs(7, Bt, L, d, 4, R)
    u, lr, W, b, A, B, C, D, z = args
    _, h0s = mamba.ssm_scan_dtlr_plain(*args, chunk=chunk, return_h0s=True)
    delta, pre = mamba._delta_lr(lr, W, b)
    ddelta = mamba.ssm_scan_bwd_plain(u, delta, A, B, C, D, z, h0s, g,
                                      chunk=chunk)[1]
    got = dt_adjoint_in_kernel_order(ddelta, pre, lr, W, chunk)
    plain = mamba.ssm_scan_dtlr_bwd_plain(*args, h0s, g, chunk=chunk)[1:4]
    # float64 from the same ddelta: the epilogue's own error.
    dp64 = ddelta.double() * torch.sigmoid(pre.double())
    exact = (dp64 @ W.double().t(),
             lr.double().reshape(-1, R).t() @ dp64.reshape(-1, d),
             dp64.sum((0, 1)))
    for name, x, p, e in zip(('ddt_lr', 'dW_dt', 'db_dt'), got, plain,
                             exact):
        m = float(e.abs().max())
        for ref in (p.double(), e):
            torch.testing.assert_close(x.double(), ref, rtol=1e-4,
                                       atol=1e-4 * m, msg=name)


def test_emulated_order_is_the_sum_in_float64():
    """In float64 the emulation's split sums equal the plain products to
    rounding: the order is exact algebra."""
    Bt, L, d, R, chunk = 2, 256, 80, 6, 128
    args, g = _inputs(8, Bt, L, d, 4, R)
    r = np.random.RandomState(9)
    ddelta = torch.from_numpy(r.randn(Bt, L, d)).double()
    lr, W = args[1].double(), args[2].double()
    pre = lr @ W + args[3].double()

    got = dt_adjoint_in_kernel_order(ddelta, pre, lr, W, chunk,
                                     fma=lambda a, b, acc: a * b + acc)
    dp = ddelta * torch.sigmoid(pre)
    want = (dp @ W.t(), lr.reshape(-1, R).t() @ dp.reshape(-1, d),
            dp.sum((0, 1)))
    for x, y in zip(got, want):
        torch.testing.assert_close(x.double(), y, rtol=1e-10,
                                   atol=1e-10 * float(y.abs().max()))


def test_takes_the_widened_shapes_and_refuses_the_rest():
    """Every scan stages one group of 16 states at a time and the forward
    scan's shared memory is the same for every chunk, so any d_state and
    chunk fit; so does any dt_rank (K16's delta kernel and K17's passes 1
    and 3 stage W_dt's columns and the sub-chunk's dt_lr rows a rank tile
    at a time). The fused block takes any dt_rank and d_inner (the front
    walks d in k steps and dt_lr in rank tiles, K19's dt_proj adjoint loops
    rank tiles past 64)."""
    for N, R in ((192, 96), (512, 128), (16, 248), (17, 184), (1600, 16)):
        assert mamba.ssm_scan_dtlr_takes(512, N, R, 128), (N, R)
    # Past the ranks the first K17 design held (248 at d_state <= 16, 184
    # past it) and K16's first delta tile (360).
    for N, R, chunk in ((16, 249, 128), (17, 185, 128), (16, 300, 128),
                        (32, 360, 128), (16, 361, 128)):
        assert mamba.ssm_scan_dtlr_takes(512, N, R, chunk), (N, R, chunk)
    for N, chunk in ((192, 128), (512, 128), (1600, 128), (32, 364),
                     (16, 1817), (64, 1024), (16, 60)):
        assert mamba.ssm_scan_takes(512, N, chunk), (N, chunk)
    for dtype in (torch.bfloat16, torch.float32):
        for H, d, N, R, chunk in ((256, 512, 192, 16, 128),
                                  (256, 512, 16, 65, 128),
                                  (1536, 3072, 16, 96, 128),
                                  (4096, 8192, 16, 256, 128),
                                  (256, 512, 64, 16, 1024)):
            assert mamba.mamba_inner_takes(H, d, N, R, 4, dtype, chunk), (
                H, d, N, R, chunk)
    # What no kernel takes.
    for N, R, chunk in ((16, 0, 128), (16, 16, 0)):
        assert not mamba.ssm_scan_dtlr_takes(512, N, R, chunk), (N, R, chunk)
    assert not mamba.ssm_scan_takes(512, 0, 128)
    assert not mamba.mamba_inner_takes(256, 520, 16, 16, 4, torch.bfloat16)
    assert not mamba.mamba_inner_takes(260, 512, 16, 16, 4, torch.bfloat16)
    assert not mamba.mamba_inner_takes(256, 512, 16, 16, 9, torch.bfloat16)
    assert not mamba.mamba_inner_takes(256, 512, 16, 0, 4, torch.bfloat16)


def test_plain_versions_match_pallas_past_the_old_limits():
    """d_state 48 (three groups) with dt_rank 80 (past the old 64): the
    plain forward and all nine gradients against
    `selective_scan_pallas_dtlr` in interpret mode, in float32, at the bars
    of tests/test_torch_mamba_dtlr.py."""
    Bt, L, d, N, R, chunk = 1, 256, 16, 48, 80, 128
    args, ct = _inputs(11, Bt, L, d, N, R)
    np_args = [a.numpy() for a in args]

    def jscan(*a):
        return selective_scan_pallas_dtlr(*a, chunk=chunk, seg=64,
                                          interpret=True)

    def loss(*a):
        return jnp.sum(jscan(*a) * ct.numpy())

    want_y, want_g = jax.jit(lambda *a: (
        jscan(*a), jax.grad(loss, argnums=tuple(range(9)))(*a)))(
            *[jnp.asarray(a) for a in np_args])
    want_y = np.asarray(want_y)
    ts = [a.clone().requires_grad_(True) for a in args]
    y = mamba.ssm_scan_dtlr(*ts, chunk=chunk)
    assert np.abs(y.detach().numpy() - want_y).max() \
        <= 1e-4 * np.abs(want_y).max()
    (y * ct).sum().backward()
    names = ('u', 'dt_lr', 'W_dt', 'b_dt', 'A', 'B', 'C', 'D', 'z')
    for name, t, w in zip(names, ts, want_g):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
