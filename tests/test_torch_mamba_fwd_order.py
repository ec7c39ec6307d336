"""A torch emulation of the one association order of the forward scan that
K14, K16 and K18 share (`csrc/mamba.cu`): the walk, `scan_fwd_kernel`,
where a batch fills the card, and the three chunk passes,
`scan_chunk_kernel`, `scan_carry_kernel` and `scan_out_kernel`, at a
smaller batch, each emulated with the same elementwise operations and held
bit-equal to the other; and of the delta K18's front forms; held against
the float64 recurrence, against the plain versions (`ops.mamba.
scan_chunks`, `ssm_scan_plain`, `mamba_inner_plain`) and against JAX's
`selective_scan_pallas` and `mamba_inner_pallas` in interpret mode; with
the wrappers' mirror of the kernels' shared memory and what the card takes.

The order: every chunk runs from its entry state h0s[c] (h0s[0] = 0), h =
a_t h + b_t with a_t = exp(delta_t A) and b_t = (delta_t u_t) B_t; the next
entry state is h0s[c + 1] = P h0s[c] + E, with E the chunk's end state from
a zero state and P = exp(S A), S the chunk's delta_t summed row by row in
order. The walk steps h over L in order beside E and S and takes the carry
as h at each chunk's last row; the passes run every chunk from zero (E, S),
chain the carries, and run every chunk again from h0s. A row's C . h over a
group of 16 states: the pairs (2 j, 2 j + 1), then
((Y0 + Y4) + (Y2 + Y6)) + ((Y1 + Y5) + (Y3 + Y7)), as the walk's 8 lanes
sum their shares by a reduce-scatter (lanes j and j ^ 4, then j ^ 2, then
j ^ 1) and pass 3 sums a thread's 16 states; past 16 states the groups run
in order and their sums are added in order. Rows past L have delta = 0 (a
= 1, b = 0). Nothing in this order depends on the batch or the card, so
the card may pick either design by speed. (The kernels' fmaf is a multiply
and an add here; the two emulations share every elementwise operation, the
exps included, so they agree bit for bit.)
K18's delta is the front's: pre = sum over k of dt_lr[k] W_dt[k], k
ascending (in fours, zeros past dt_rank), then softplus(pre + b_dt):
`dt_pre`'s order.

In float64 the emulation equals the recurrence to rounding (the sums are
exact algebra). In float32 it is held to K14's and K18's card bars (1e-4
abs for y; h0s to 1e-5 of its largest magnitude, `chip_smoke._close_states`)
against the plain versions, JAX and float64, and no further from float64
than four times the plain version's own distance plus one part in 1e-6 of
the largest magnitude (the bar the adjoint's order test sets), at B=1 and
2, L 256, 200 (a padded last chunk) and 600, d 40 (channels are
independent in this order; the card's checks run a ragged tile), d_state
16 and 24 (two groups), chunk 16, 60 and 128.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddg_tpu.ops.mamba_block_pallas import mamba_inner_pallas
from ddg_tpu.ops.selective_scan_pallas import selective_scan_pallas
from ddg_tpu_torch.ops import mamba

torch.set_num_threads(1)
GROUP = 16  # states of a group; a lane holds two


def _lane_sum(pr):
    """Each row's C . h over a group, (..., 16) -> (...), as the kernel's
    lanes and reduce-scatter sum it."""
    y = pr[..., 0::2] + pr[..., 1::2]          # lane j: states 2 j, 2 j + 1
    y = y[..., :4] + y[..., 4:]                 # lanes j, j ^ 4
    y = y[..., :2] + y[..., 2:]                 # then j ^ 2
    return y[..., 0] + y[..., 1]                # then j ^ 1


def _pad_states(A, B, C):
    """A, B and C with zero states up to whole groups of 16."""
    pad = -(-A.shape[1] // GROUP) * GROUP - A.shape[1]
    return F.pad(A, (0, pad)), F.pad(B, (0, pad)), F.pad(C, (0, pad))


def _step_terms(u, delta, A, B):
    """(a_t, b_t), each (Bt, L, d, states): a_t = exp(delta_t A) and b_t =
    (delta_t u_t) B_t, formed once for both emulations (the kernels take
    the same exp at each use)."""
    return (torch.exp(delta[..., None] * A),
            (delta * u)[..., None] * B[:, :, None, :])


def _chunk_sums(delta, chunk):
    """S (Bt, n_chunks, d): each chunk's delta_t summed row by row in
    order."""
    Bt, L, d = delta.shape
    S = torch.zeros((Bt, -(-L // chunk), d), dtype=delta.dtype)
    for t in range(L):
        S[:, t // chunk] = S[:, t // chunk] + delta[:, t]
    return S


def scan_in_kernel_order(u, delta, A, B, C, chunk):
    """(C . h (Bt, L, d), h0s (Bt, n_chunks, N, d)) as `scan_chunks`
    returns them, in the walk's steps (`scan_fwd_kernel`): each row in
    order, E and S beside h, the carry taken as h at a chunk's last row;
    every input of one float dtype, A round-tripped (d, N)."""
    Bt, L, d = u.shape
    N = A.shape[1]
    nc = -(-L // chunk)
    Ap, Bp, Cp = _pad_states(A, B, C)
    a, b = _step_terms(u, delta, Ap, Bp)
    P = torch.exp(_chunk_sums(delta, chunk)[..., None] * Ap)
    h0s = torch.zeros((Bt, nc, Ap.shape[1], d), dtype=u.dtype)
    ysum = None
    for g in range(Ap.shape[1] // GROUP):
        sl = slice(g * GROUP, (g + 1) * GROUP)
        h = h0 = E = torch.zeros((Bt, d, GROUP), dtype=u.dtype)
        ys = []
        for t in range(L):
            h = a[:, t, :, sl] * h + b[:, t, :, sl]
            E = a[:, t, :, sl] * E + b[:, t, :, sl]
            ys.append(_lane_sum(Cp[:, t, None, sl] * h))
            c = (t + 1) // chunk
            if (t + 1) % chunk == 0 and c < nc:
                h0 = P[:, c - 1, :, sl] * h0 + E
                h, E = h0, torch.zeros_like(E)
                h0s[:, c, sl] = h0.transpose(1, 2)
        y = torch.stack(ys, dim=1)
        ysum = y if ysum is None else ysum + y
    return ysum, h0s[:, :, :N]


def scan_in_pass_order(u, delta, A, B, C, chunk):
    """The same, in the three passes' steps (`scan_chunk_kernel`,
    `scan_carry_kernel`, `scan_out_kernel`): every chunk from zero for E
    (and S, then P), the carries chained into h0s, every chunk again from
    h0s and read out through C; the chunks side by side."""
    Bt, L, d = u.shape
    N = A.shape[1]
    nc = -(-L // chunk)
    Ap, Bp, Cp = _pad_states(A, B, C)
    a, b = _step_terms(u, delta, Ap, Bp)
    pad = nc * chunk - L

    def split(x, value=0.0):
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad), value=value)
        return x.reshape(Bt, nc, chunk, *x.shape[2:])

    a, b, Cs = split(a, 1.0), split(b), split(Cp)
    P = torch.exp(_chunk_sums(delta, chunk)[..., None] * Ap)
    E = torch.zeros((Bt, nc, d, Ap.shape[1]), dtype=u.dtype)
    for j in range(chunk):
        E = a[:, :, j] * E + b[:, :, j]
    e, entries = torch.zeros_like(E[:, 0]), []
    for c in range(nc):
        entries.append(e)
        e = P[:, c] * e + E[:, c]
    h0 = torch.stack(entries, dim=1)
    ysum = None
    for g in range(Ap.shape[1] // GROUP):
        sl = slice(g * GROUP, (g + 1) * GROUP)
        h, ys = h0[..., sl], []
        for j in range(chunk):
            h = a[:, :, j, :, sl] * h + b[:, :, j, :, sl]
            ys.append(_lane_sum(Cs[:, :, j, None, sl] * h))
        y = torch.stack(ys, dim=2).reshape(Bt, nc * chunk, d)[:, :L]
        ysum = y if ysum is None else ysum + y
    return ysum, h0.transpose(2, 3)[:, :, :N].contiguous()


def delta_in_kernel_order(lr, W_dt, b_dt):
    """softplus(dt_lr W_dt + b_dt), the sum k ascending in fours with zeros
    past dt_rank, as K18's front forms it."""
    R = W_dt.shape[0]
    R4 = -(-R // 4) * 4
    lr = F.pad(lr, (0, R4 - R))
    W = F.pad(W_dt, (0, 0, 0, R4 - R))
    acc = torch.zeros(lr.shape[:-1] + (W.shape[1],), dtype=lr.dtype)
    for k in range(R4):
        acc = lr[..., k, None] * W[k] + acc
    return mamba.softplus(acc + b_dt)


def _inputs(seed, Bt, L, d, N, dtype=torch.float32):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy(r.randn(*shape) * scale).to(dtype)

    u, z = f(Bt, L, d), f(Bt, L, d)
    delta = mamba.softplus(f(Bt, L, d) - 2.0)
    A = -torch.exp(f(d, N, scale=0.5))
    return u, delta, A, f(Bt, L, N), f(Bt, L, N), f(d), z


def _gate(y, u, D, z):
    return (y + D * u) * (z * torch.sigmoid(z))


# (L, d_state, chunk): chunk ends every 16, 60 or 128 rows, a padded last
# chunk (200), several chunks with a ragged end (600); one and two groups
# of 16 states.
CASES = [(256, 16, 128), (256, 24, 16), (200, 16, 60), (200, 24, 128),
         (600, 16, 60), (600, 24, 128)]
D = 40      # d_inner: channels are independent in the kernel's order


@pytest.mark.parametrize('Bt', [1, 2])
@pytest.mark.parametrize('L, N, chunk', CASES)
def test_float64_emulation_is_the_recurrence(L, N, chunk, Bt):
    u, delta, A, B, C, _, _ = (t.double() for t in _inputs(1, Bt, L, D, N))
    A_rt = mamba._round_trip(A).double()
    want = mamba.scan_chunks(u, delta, A_rt, B, C, chunk)
    got = scan_in_kernel_order(u, delta, A_rt, B, C, chunk)
    for name, x, y in zip(('y', 'h0s'), got, want):
        torch.testing.assert_close(x, y, rtol=1e-10,
                                   atol=1e-10 * float(y.abs().max()),
                                   msg=name)


@pytest.mark.parametrize('Bt', [1, 2])
@pytest.mark.parametrize('L, N, chunk', CASES)
def test_float32_emulation_within_k14_bars(L, N, chunk, Bt):
    """The gated y and h0s against the plain version and float64: y to
    1e-4 abs, h0s to 1e-5 of its largest magnitude, each no further from
    float64 than four times the plain version's distance plus 1e-6 of the
    largest magnitude."""
    ins = _inputs(2, Bt, L, D, N)
    u, delta, A, B, C, Dv, z = ins
    A_rt = mamba._round_trip(A)
    y, h0s = scan_in_kernel_order(u, delta, A_rt, B, C, chunk)
    got = (_gate(y, u, Dv, z), h0s)
    plain = mamba.ssm_scan_plain(u, delta, A, B, C, Dv, z, chunk=chunk,
                                 return_h0s=True)
    d64 = [t.double() for t in ins]
    y64, h64 = mamba.scan_chunks(d64[0], d64[1], A_rt.double(), d64[3],
                                 d64[4], chunk)
    exact = (_gate(y64, d64[0], d64[5], d64[6]), h64)
    for name, x, p, e in zip(('y', 'h0s'), got, plain, exact):
        m = float(e.abs().max())
        tol = 1e-4 if name == 'y' else 1e-5 * m
        for ref in (p.double(), e):
            assert float((x.double() - ref).abs().max()) <= tol, name
        gap = float((x.double() - e).abs().max())
        plain_gap = float((p.double() - e).abs().max())
        assert gap <= 4 * plain_gap + 1e-6 * m, (name, gap, plain_gap)


@pytest.mark.parametrize('N', [16, 24])
@pytest.mark.parametrize('chunk', [16, 60, 128])
@pytest.mark.parametrize('Bt', [1, 2, 4])
def test_walk_and_passes_give_the_same_bits(Bt, chunk, N):
    """The walk's steps and the passes' steps, on the same elementwise
    operations, give equal float32 y and h0s: the card may run either at
    any batch (chunk 60 ends inside a 16-row batch of the walk; L = 200
    pads the last chunk)."""
    u, delta, A, B, C, _, _ = _inputs(7, Bt, 200, D, N)
    A_rt = mamba._round_trip(A)
    walk = scan_in_kernel_order(u, delta, A_rt, B, C, chunk)
    passes = scan_in_pass_order(u, delta, A_rt, B, C, chunk)
    for name, x, y in zip(('y', 'h0s'), walk, passes):
        assert torch.equal(x, y), name


def test_emulated_rows_do_not_depend_on_the_batch():
    """A row's y and h0s are the same bits alone and as the first row of a
    batch of four, in the walk's steps and in the passes' (the card picks
    the design by the batch): no part of the order follows the batch."""
    u, delta, A, B, C, _, _ = _inputs(6, 4, 200, D, 24)
    A_rt = mamba._round_trip(A)
    one = [t[:1] for t in (u, delta)] + [A_rt, B[:1], C[:1]]
    ref = scan_in_kernel_order(*one, 60)
    for emulate in (scan_in_kernel_order, scan_in_pass_order):
        y4, h4 = emulate(u, delta, A_rt, B, C, 60)
        y1, h1 = emulate(*one, 60)
        assert torch.equal(y4[:1], y1) and torch.equal(h4[:1], h1)
        assert torch.equal(y1, ref[0]) and torch.equal(h1, ref[1])


@pytest.mark.parametrize('L, chunk', [(256, 128), (200, 64)],
                         ids=['aligned', 'padded'])
def test_emulation_matches_pallas_ssm_scan(L, chunk):
    """The emulated, gated scan against `selective_scan_pallas` in
    interpret mode (float32, the pps3 schedule) at K14's bar."""
    u, delta, A, B, C, Dv, z = _inputs(3, 2, L, D, 16)
    want = jax.jit(functools.partial(
        selective_scan_pallas, chunk=chunk, seg=chunk // 2,
        scan_impl='pps3', interpret=True))(
            *(jnp.asarray(t.numpy()) for t in (u, delta, A, B, C, Dv, z)))
    y, _ = scan_in_kernel_order(u, delta, mamba._round_trip(A), B, C, chunk)
    got = _gate(y, u, Dv, z)
    assert float((got - torch.from_numpy(np.asarray(want))).abs().max()) \
        <= 1e-4


def _block_weights(seed, L, H=32, d=D, N=16, R=3, K=4, Bt=2):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return (r.randn(*shape) * scale).astype(np.float32)

    return (f(Bt, L, H), f(H, 2 * d, scale=H ** -0.5), f(K, 1, d, scale=0.5),
            f(d, scale=0.1), f(d, R + 2 * N, scale=d ** -0.5),
            f(R, d, scale=R ** -0.5), f(d, scale=0.5) - 3.0,
            -np.exp(f(d, N, scale=0.5)), f(d), f(d, H, scale=d ** -0.5))


def mamba_inner_in_kernel_order(h, W_in, conv_w, conv_b, W_x, W_dt, b_dt, A,
                                Dv, W_out, *, d_state, dt_rank, chunk):
    """K18 in float32 with the plain version's conv and products, delta
    formed as its front forms it and the scan in its order."""
    d = W_in.shape[1] // 2
    R, N = dt_rank, d_state
    x, zz = h @ W_in[:, :d], h @ W_in[:, d:]
    xc = mamba._conv_taps(x, conv_w, conv_b)
    u = xc * torch.sigmoid(xc)
    x_dbl = u @ W_x
    delta = delta_in_kernel_order(x_dbl[..., :R], W_dt, b_dt)
    y, h0s = scan_in_kernel_order(u, delta, mamba._round_trip(A),
                                  x_dbl[..., R:R + N], x_dbl[..., R + N:],
                                  chunk)
    return _gate(y, u, Dv, zz) @ W_out, h0s


@pytest.mark.parametrize('L, chunk, N, R', [(256, 128, 16, 3),
                                            (240, 60, 24, 6),
                                            (600, 120, 16, 5)])
def test_block_order_matches_the_plain_block(L, chunk, N, R):
    """K18's order (the front's delta, the scan above) against
    `mamba_inner_plain` in float32: out to 1e-4 abs, h0s to 1e-5 of its
    largest magnitude; and the front's delta against softplus(dt_lr W_dt +
    b_dt) by matmul to 1e-12 relative in float64."""
    args = [torch.from_numpy(a) for a in _block_weights(4, L, N=N, R=R)]
    kw = dict(d_state=N, dt_rank=R, chunk=chunk)
    got = mamba_inner_in_kernel_order(*args, **kw)
    want = mamba.mamba_inner_plain(*args, **kw, compute_dtype=torch.float32,
                                   return_h0s=True)
    assert float((got[0] - want[0]).abs().max()) <= 1e-4
    assert float((got[1] - want[1]).abs().max()) \
        <= 1e-5 * float(want[1].abs().max())
    lr = torch.randn(2, 64, R, dtype=torch.float64)
    W, b = args[5].double(), args[6].double()
    torch.testing.assert_close(delta_in_kernel_order(lr, W, b),
                               mamba.softplus(lr @ W + b), rtol=1e-12,
                               atol=0.0)


def test_block_order_matches_pallas_block():
    """The emulated K18 against `mamba_inner_pallas` in interpret mode
    (float32) at K18's bar, chunk 60 (seg 30), d_state 24."""
    L, chunk, N, R = 240, 60, 24, 6
    args = _block_weights(5, L, N=N, R=R)
    want = jax.jit(functools.partial(
        mamba_inner_pallas, d_state=N, dt_rank=R, chunk=chunk, seg=30,
        seg_bwd=30, interpret=True, compute_dtype=jnp.float32))(
            *(jnp.asarray(a) for a in args))
    got, _ = mamba_inner_in_kernel_order(
        *(torch.from_numpy(a) for a in args), d_state=N, dt_rank=R,
        chunk=chunk)
    assert float((got - torch.from_numpy(np.asarray(want))).abs().max()) \
        <= 1e-4


@pytest.mark.parametrize('chunk', [1, 16, 60, 128, 1024, 4096])
@pytest.mark.parametrize('N', [1, 16, 17, 192, 4096])
def test_forward_scan_smem_is_the_same_for_every_chunk_and_d_state(chunk, N):
    """The walk's larger block (fp32 operands, 16 channels, tiles of 64
    rows, 8 lanes a channel) holds two raw tiles (u, z and delta of its
    channels, B and C of 16 states) and the staged tile (a float2 a row and
    channel, a float4 a row and lane): 2 64 (4 16 + 4 16 + 4 16 + 2 4 16) +
    64 (8 16 + 16 8) bytes, whatever the chunk and d_state (the three
    passes run only where a chunk fits them). With the adjoint's passes on
    sub-chunks of 64 rows, nothing the scans launch grows with the chunk
    past 64, so every chunk is taken."""
    assert mamba._SCAN_FWD_SMEM == 2 * 64 * 320 + 64 * 256 == 57344
    assert mamba.scan_smem(chunk, N) >= mamba._SCAN_FWD_SMEM
    if chunk >= 64:
        assert mamba.scan_smem(chunk, N) == mamba.scan_smem(64, N)
    assert mamba.ssm_scan_takes(40, N, chunk)


@pytest.mark.parametrize('R, taken', [(16, True), (248, True), (249, True),
                                      (300, True), (360, True)])
def test_k17_pass3_bounds_the_dt_rank(R, taken):
    """At chunk 128, d_state 16: K17's passes 1 and 3 hold one rank tile
    (min(round4(R), 128) ranks) of dt_lr's rows and W_dt's columns beside
    the adjoint's own, and K16's delta kernel one of up to 360 ranks; their
    sums set `scan_smem` (beside the forward scan's). So the rank tiles
    bound the blocks, not dt_rank: every rank is taken, past 248 (where
    the pass 3 that held all the ranks stopped fitting) as below it."""
    lr = min(-(-R // 4) * 4, 128)
    bwd1 = 4 * (64 * 16 + 2 * 16 * 64 + 64 * lr + 64 * (lr + 5))
    bwd_lr = max(mamba._scan_bwd_smem(128, 16, R))
    assert bwd_lr == max(bwd1, mamba._scan_bwd_smem(128, 16, R)[1])
    assert (bwd_lr <= mamba._SMEM) == taken
    delta_kernel = 4 * min(-(-R // 4) * 4, 360) * 160
    assert mamba.scan_smem(128, 16, R) == max(mamba._SCAN_FWD_SMEM,
                                              delta_kernel, bwd_lr)
    assert mamba.ssm_scan_dtlr_takes(512, 16, R, 128) == taken


@pytest.mark.parametrize('N', [16, 17, 64])
@pytest.mark.parametrize('R', [128, 129, 249, 360, 361, 512, 4096])
def test_scan_smem_counts_rank_tiles(R, N):
    """Past one rank tile the dt-lowrank blocks stop growing: K17's passes
    hold 128 ranks (a 129th starts a second tile) and K16's delta kernel
    360, so `scan_smem` at any larger dt_rank equals its value at the
    tiles' width, and the card takes it at every chunk."""
    for chunk in (16, 60, 128, 1024):
        bwd = mamba._scan_bwd_smem(chunk, N, R)
        assert bwd == mamba._scan_bwd_smem(chunk, N, min(R, 128))
        want = max(mamba._SCAN_FWD_SMEM, 4 * min(-(-R // 4) * 4, 360) * 160,
                   *bwd)
        assert mamba.scan_smem(chunk, N, R) == want <= mamba._SMEM
        assert mamba.ssm_scan_dtlr_takes(512, N, R, chunk)


@pytest.mark.parametrize('esize, want', [(2, 18432), (4, 35072)])
def test_front_smem_is_one_k_step(esize, want):
    """The front's block: a 64-row tile of one k step of u (64 channels,
    rows of 72) and W_x's 64 columns (rows of 72 in bfloat16, 65 in
    float32); the same for every d_inner and dt_rank, and under the card's
    limit, so `mamba_inner_takes` takes any d_inner on the products' rows."""
    assert mamba._front_smem(esize) == want
    dtype = torch.bfloat16 if esize == 2 else torch.float32
    for d, R in ((512, 16), (3072, 96), (8192, 256), (16384, 1024)):
        assert mamba.mamba_inner_takes(d // 2, d, 16, R, 4, dtype)
