"""A torch emulation of the association order of the scan adjoint's pass 3
(`csrc/mamba_bwd.cu`, `scan_bwd_out_kernel`, which K15, K17 and K19 share),
held against the float64 recurrence and against the plain version
(`ops.mamba.ssm_scan_bwd_plain`, the sequential order).

The kernel's order: passes 1 and 2 on sub-chunks of up to 64 rows of
each chunk (`sub_rows`); pass 3 walks a chunk's sub-chunks left to right
and cuts each into segments of 8 rows. Per segment, from its own a_t =
exp(delta_t A) taken once: P = prod a_t, H = the state at its end from a
zero state, E = a_t0 dh_t0 from a zero adjoint at its end. Segment s
enters with the sub-chunk's entry state chained through segments 0 .. s -
1 (h = P h + H) and leaves with the carry chained through the segments
after it, last first (X = P X + E); then dh is walked back from X and h
forward. Rows past a sub-chunk's end, or past L, have delta = 0 (a = 1, b
= 0).

In float64 the emulation equals the recurrence to rounding (the split is
exact algebra); in float32 it is held to K15's bars of
tests/test_torch_mamba_grad.py, rtol 1e-4 with atol 1e-4 of the largest
magnitude, against both, at chunk 128 (two sub-chunks), 16 and 60 (a
partial segment), 200 (four, the last partial) and 64 (one), L ragged or
not."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddg_tpu_torch.ops import mamba

torch.set_num_threads(1)
SUB, SEG = 64, 8


def adjoint_in_kernel_order(u, delta, A, B, C, D, z, g, h0s, chunk):
    """(ddelta, du, dB, dC, y_pre, dz, dA, dD) as `scan_bwd_chunks`
    returns them, in the kernel's association order; every input of one
    float dtype, A round-tripped (d, N), h0s (Bt, n_chunks, N, d)."""
    Bt, L, d = u.shape
    N = A.shape[1]
    nc = -(-L // chunk)
    sc, ns = min(chunk, SUB), -(-chunk // SUB)
    nseg = -(-sc // SEG)

    def split(x):
        """(Bt, nc, ns, nseg, SEG, width): chunks, sub-chunks, segments,
        rows; zeros past L, past a chunk's last sub-chunk and past a
        sub-chunk's last segment."""
        x = F.pad(x, (0, 0, 0, nc * chunk - L)).reshape(Bt, nc, chunk, -1)
        x = F.pad(x, (0, 0, 0, ns * sc - chunk)).reshape(Bt, nc, ns, sc, -1)
        return F.pad(x, (0, 0, 0, nseg * SEG - sc)).reshape(
            Bt, nc, ns, nseg, SEG, -1)

    def join(x):
        """The inverse of `split` for (..., SEG, width) rows."""
        x = x.reshape(Bt, nc, ns, nseg * SEG, -1)[:, :, :, :sc]
        x = x.reshape(Bt, nc, ns * sc, -1)[:, :, :chunk]
        return x.reshape(Bt, nc * chunk, -1)[:, :L]

    sig = torch.sigmoid(z)
    sg = z * sig
    gy = g * sg
    dt, uu, gys, Bs, Cs = (split(t) for t in (delta, u, gy, B, C))
    a = torch.exp(dt[..., None] * A)               # (..., SEG, d, N)
    b = (dt * uu)[..., None] * Bs[..., None, :]
    w = gys[..., None] * Cs[..., None, :]

    # Pass 1 per sub-chunk (its rows from the last, as the kernel's pass 1
    # walks them), pass 2 right to left over every sub-chunk of a row.
    rows = a.reshape(Bt, nc * ns, nseg * SEG, d, N)
    wr = w.reshape(rows.shape)
    dh = torch.zeros_like(rows[:, :, 0])
    p = torch.ones_like(dh)
    a_up = torch.ones_like(dh)
    for j in reversed(range(nseg * SEG)):
        dh = wr[:, :, j] + a_up * dh
        a_up = rows[:, :, j]
        p = p * rows[:, :, j]
    left = a_up * dh
    carry = torch.zeros_like(dh)
    chi = torch.zeros_like(dh[:, 0])
    for k in reversed(range(nc * ns)):
        carry[:, k] = chi
        chi = p[:, k] * chi + left[:, k]
    carry = carry.reshape(Bt, nc, ns, d, N)

    # Each segment's summaries.
    P = torch.ones_like(a[..., 0, :, :])
    H = torch.zeros_like(P)
    Dl = torch.zeros_like(P)
    a_up = torch.ones_like(P)
    for j in range(SEG):
        H = a[..., j, :, :] * H + b[..., j, :, :]
        P = P * a[..., j, :, :]
    for j in reversed(range(SEG)):
        Dl = a_up * Dl + w[..., j, :, :]
        a_up = a[..., j, :, :]
    E = a_up * Dl

    out = {k: torch.zeros(Bt, nc, ns, nseg, SEG, *s, dtype=u.dtype)
           for k, s in (('ddt', (d,)), ('du', (d,)), ('y', (d,)),
                        ('dB', (N,)), ('dC', (N,)))}
    dA_parts = []
    entry = h0s.transpose(2, 3)                    # (Bt, nc, d, N)
    for k in range(ns):
        exit_state = None
        seg_dA = []
        for s in range(nseg):
            h = entry
            for t in range(s):
                h = P[:, :, k, t] * h + H[:, :, k, t]
            X = carry[:, :, k]
            for t in reversed(range(s + 1, nseg)):
                X = P[:, :, k, t] * X + E[:, :, k, t]
            ak, wk, bk = a[:, :, k, s], w[:, :, k, s], b[:, :, k, s]
            dhs = [None] * SEG
            for j in reversed(range(SEG)):
                dhs[j] = (X if j == SEG - 1 else ak[:, :, j + 1] * dhs[j + 1]) \
                    + wk[:, :, j]
            dA = torch.zeros_like(h)
            for j in range(SEG):
                hn = ak[:, :, j] * h + bk[:, :, j]
                daa = dhs[j] * h * ak[:, :, j]
                dtj = dt[:, :, k, s, j][..., None]
                dhB = (dhs[j] * Bs[:, :, k, s, j, None, :]).sum(-1)
                out['ddt'][:, :, k, s, j] = (daa * A).sum(-1) \
                    + dhB * uu[:, :, k, s, j]
                out['du'][:, :, k, s, j] = dhB * dt[:, :, k, s, j] \
                    + gys[:, :, k, s, j] * D
                out['y'][:, :, k, s, j] = (hn * Cs[:, :, k, s, j, None, :]
                                           ).sum(-1) + D * uu[:, :, k, s, j]
                out['dB'][:, :, k, s, j] = (
                    dhs[j] * (dt * uu)[:, :, k, s, j, :, None]).sum(-2)
                out['dC'][:, :, k, s, j] = (
                    hn * gys[:, :, k, s, j, :, None]).sum(-2)
                dA = dA + daa * dtj
                h = hn
            seg_dA.append(dA)
            exit_state = h
        total = seg_dA[0]
        for t in seg_dA[1:]:
            total = total + t
        dA_parts.append(total)                     # (Bt, nc, d, N)
        entry = exit_state
    # Slices (b, chunk, sub-chunk) summed in order.
    dA = torch.stack(dA_parts, 2).reshape(Bt * nc * ns, d, N).sum(0)
    ddt, du, dB, dC, y_pre = (join(out[k]) for k in
                              ('ddt', 'du', 'dB', 'dC', 'y'))
    dz = g * y_pre * (sig + sg * (1.0 - sig))
    dD = (gy * u).sum((0, 1))
    return ddt, du, dB, dC, y_pre, dz, dA, dD


def _inputs(seed, Bt, L, d, N):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((r.randn(*shape) * scale).astype(np.float32))

    u, z, g = f(Bt, L, d), f(Bt, L, d), f(Bt, L, d)
    delta = mamba.softplus(f(Bt, L, d) - 1.0)
    A = -torch.exp(f(d, N, scale=0.5))
    B, C, D = f(Bt, L, N), f(Bt, L, N), f(d)
    return u, delta, A, B, C, D, z, g


# (L, chunk): Species10's chunk (two sub-chunks), a small chunk with a
# ragged L, a partial segment, four sub-chunks (the last partial) with a
# ragged L, one whole sub-chunk.
CASES = [(256, 128), (80, 16), (120, 60), (330, 200), (192, 64)]


@pytest.mark.parametrize('L, chunk', CASES)
def test_float64_emulation_is_the_recurrence(L, chunk):
    u, delta, A, B, C, D, z, g = (t.double() for t in
                                  _inputs(1, 2, L, 8, 4))
    A_rt = mamba._round_trip(A).double()
    _, h0s = mamba.scan_chunks(u, delta, A_rt, B, C, chunk)
    want = mamba.scan_bwd_chunks(u, delta, A_rt, B, C, D, z, g, h0s, chunk)
    got = adjoint_in_kernel_order(u, delta, A_rt, B, C, D, z, g, h0s, chunk)
    for name, x, y in zip(('ddt', 'du', 'dB', 'dC', 'y', 'dz', 'dA', 'dD'),
                          got, want):
        torch.testing.assert_close(x, y, rtol=1e-10,
                                   atol=1e-10 * float(y.abs().max()),
                                   msg=name)


@pytest.mark.parametrize('L, chunk', CASES)
def test_float32_emulation_within_k15_bars(L, chunk):
    """Against the float64 recurrence and the plain version's outputs, at
    rtol 1e-4 with atol 1e-4 of the largest magnitude, and no further from
    float64 than four times the plain version's own distance (plus one
    part in 1e-6 of the largest magnitude)."""
    ins = _inputs(2, 2, L, 16, 8)
    u, delta, A, B, C, D, z, g = ins
    A_rt = mamba._round_trip(A)
    _, h0s = mamba.scan_chunks(u, delta, A_rt, B, C, chunk)
    got = adjoint_in_kernel_order(u, delta, A_rt, B, C, D, z, g, h0s, chunk)
    plain = mamba.scan_bwd_chunks(u, delta, A_rt, B, C, D, z, g, h0s, chunk)
    d64 = [t.double() for t in ins]
    A64 = A_rt.double()
    _, h64 = mamba.scan_chunks(d64[0], d64[1], A64, d64[3], d64[4], chunk)
    exact = mamba.scan_bwd_chunks(d64[0], d64[1], A64, d64[3], d64[4],
                                  d64[5], d64[6], d64[7], h64, chunk)
    for name, x, p, e in zip(('ddt', 'du', 'dB', 'dC', 'y', 'dz', 'dA',
                              'dD'), got, plain, exact):
        m = float(e.abs().max())
        for ref in (p.double(), e):
            torch.testing.assert_close(x.double(), ref, rtol=1e-4,
                                       atol=1e-4 * m, msg=name)
        gap = float((x.double() - e).abs().max())
        plain_gap = float((p.double() - e).abs().max())
        assert gap <= 4 * plain_gap + 1e-6 * m, (name, gap, plain_gap)


def test_plain_backward_agrees_with_the_emulation():
    """`ssm_scan_bwd_plain` (what the wrapper runs on the CPU, in the
    sequential order) against the emulation at Species10's chunk, with its
    outputs as the wrapper returns them (dA as dA_log, transposed)."""
    u, delta, A, B, C, D, z, g = _inputs(3, 2, 256, 16, 16)
    _, h0s = mamba.ssm_scan(u, delta, A, B, C, D, z, return_h0s=True)
    du, ddt, dB, dC, dA_log, dz, dD = mamba.ssm_scan_bwd_plain(
        u, delta, A, B, C, D, z, h0s, g)
    A_rt = mamba._round_trip(A)
    e = adjoint_in_kernel_order(u, delta, A_rt, B, C, D, z, g, h0s, 128)
    for name, x, y in (('du', du, e[1]), ('ddelta', ddt, e[0]),
                       ('dB', dB, e[2]), ('dC', dC, e[3]), ('dz', dz, e[5]),
                       ('dA_log', dA_log, (e[6] * A_rt).t()), ('dD', dD,
                                                                e[7])):
        torch.testing.assert_close(x, y, rtol=1e-4,
                                   atol=1e-4 * float(y.abs().max()), msg=name)


def test_emulated_row_gradients_do_not_depend_on_the_batch():
    """A row's outputs of the adjoint (ddelta, du, dB, dC, y, dz) are the
    same bits alone and as the first row of a batch of four, given the
    row's h0s (the forward's, whose bits no longer follow the batch): the
    adjoint's order follows the shape of a row only. dA and dD sum over
    the batch and are left out."""
    u, delta, A, B, C, D, z, g = _inputs(4, 4, 120, 16, 8)
    A_rt = mamba._round_trip(A)
    _, h0s = mamba.scan_chunks(u, delta, A_rt, B, C, 60)
    four = adjoint_in_kernel_order(u, delta, A_rt, B, C, D, z, g, h0s, 60)
    one = adjoint_in_kernel_order(u[:1], delta[:1], A_rt, B[:1], C[:1], D,
                                  z[:1], g[:1], h0s[:1], 60)
    for name, x, y in zip(('ddt', 'du', 'dB', 'dC', 'y', 'dz'), four, one):
        assert torch.equal(x[:1], y), name
