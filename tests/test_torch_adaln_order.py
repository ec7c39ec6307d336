"""The association of the adaLN backward kernels (K4, K6 in
`ddg_tpu_torch/csrc/adaln.cu`), emulated in fp32 with PyTorch on the CPU,
against the plain backwards (`ddg_tpu_torch.ops.adaln.*_bwd_plain`) and
against `jax.vjp` of `ddg_tpu/ops/adaln_pallas.py` in interpret mode, on
numpy-seeded inputs at B = 3, L = 40 (not a multiple of a block's 64
rows), in float32 and bfloat16; and the launch arithmetic the wrappers
compute (`ops.adaln.bwd_plan`).

The emulation follows `bwd_plan`'s mapping: a row to a team of warps,
lane t of it holding vectors t, t + 32 G, ... of the row; each lane's
sums over its elements in order, a shuffle butterfly over the warp, the
team's warps in order; each team's per-column partials over its rows in
row order, the block's teams added in team order; per batch row the
blocks' partials in tile order; dw over groups of 8 batch rows in order,
then the groups in order. D = 64 takes one warp a row; D = 1280 in
bfloat16 (160 vectors) two warps a row of 3 vectors a lane, in float32
(320 vectors) three of 4.

Bars, the card's (`chip_smoke.check_adaln_bwd`): the row grads in float32
to 1e-4 absolute, in bfloat16 to 2 ulp of the reference's largest
magnitude; the sums (dw and the conditioning grads) in float32 to 1e-5 of
the reference's largest magnitude, in bfloat16 to 2 ulp of it. The
emulation's rsqrt and products are PyTorch's, not the card's, so it is
held to the bars and not to bits.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddg_tpu.ops import adaln_pallas as jad
from ddg_tpu_torch.ops import adaln as tad

torch.set_num_threads(1)
B, L = 3, 40
_DT = {'f32': (jnp.float32, torch.float32),
       'bf16': (jnp.bfloat16, torch.bfloat16)}


def _inputs(D, seed=7):
    r = np.random.RandomState(seed)
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    return dict(x=f(B, L, D) + 3.0, y=f(B, L, D), skip=f(B, L, D),
                gate=f(B, D), w=(1.0 + 0.1 * f(D)).astype(np.float32),
                shift=f(B, D), scale=0.5 * f(B, D), dx=f(B, L, D),
                dh=f(B, L, D))


def _team_sum(v, G):
    """(..., 32 G) lane values -> the team's sum: a shuffle butterfly per
    warp (lane l and l + 16, then 8, ...), then the warps in order."""
    w = v.reshape(*v.shape[:-1], G, 32)
    n = 32
    while n > 1:
        n //= 2
        w = w[..., :n] + w[..., n:2 * n]
    w = w[..., 0]
    total = w[..., 0]
    for g in range(1, G):
        total = total + w[..., g]
    return total


def emulate_bwd(x, w, scale, dh, dx=None, y=None, gate=None):
    """The kernels' fp32 association; returns what the wrapper returns:
    (dx, dw, dshift, dscale), or with dx, y and gate (the residual form)
    (dy, dskip, dgate, dw, dshift, dscale)."""
    res = dx is not None
    Bx, Lx, D = x.shape
    plan = tad.bwd_plan(Bx, Lx, D, x.element_size(), res)
    N = 16 // x.element_size()
    G, V, Tm = (plan['warps_per_row'], plan['vectors_per_lane'],
                plan['teams'])
    TT, rows, tiles = 32 * G, plan['rows'], plan['tiles']
    pad = V * TT * N - D

    def lanes(a):           # (..., D) -> (..., V, TT, N), zeros past D
        return F.pad(a.float(), (0, pad)).reshape(*a.shape[:-1], V, TT, N)

    def cols(a):            # back to (..., D)
        return a.reshape(*a.shape[:-3], V * TT * N)[..., :D]

    X, DH = lanes(x), lanes(dh)
    mul = lanes(w.float() * (1.0 + scale.float()))[:, None]
    s1 = torch.zeros(Bx, Lx, TT)
    s2 = torch.zeros(Bx, Lx, TT)
    for k in range(V):
        for i in range(N):
            v = X[:, :, k, :, i]
            s1 = s1 + v
            s2 = s2 + v * v
    m1 = (_team_sum(s1, G) / D)[..., None, None, None]
    rr = torch.rsqrt(torch.clamp_min(_team_sum(s2, G) / D - m1[..., 0, 0, 0]
                                     ** 2, 0.0) + 1e-5)[..., None, None, None]
    XN = (X - m1) * rr
    DXN = DH * mul
    a = torch.zeros(Bx, Lx, TT)
    c = torch.zeros(Bx, Lx, TT)
    for k in range(V):
        for i in range(N):
            a = a + DXN[:, :, k, :, i]
            c = c + DXN[:, :, k, :, i] * XN[:, :, k, :, i]
    md = (_team_sum(a, G) / D)[..., None, None, None]
    mdx = (_team_sum(c, G) / D)[..., None, None, None]
    O = rr * (DXN - md - XN * mdx)
    terms = [DH, DH * XN]
    if res:
        O = O + lanes(dx)
        terms.append(O * lanes(y))
        DY = O * lanes(gate.float())[:, None]
    # Per (b, tile, team) over the team's rows in order, then the teams in
    # order, then per b the tiles in order.
    P = len(terms)
    part = torch.zeros(P, Bx, tiles, Tm, V, TT, N)
    for tile in range(tiles):
        for j in range(rows):
            r = tile * rows + j
            if r >= Lx:
                break
            for p in range(P):
                part[p, :, tile, j % Tm] = part[p, :, tile, j % Tm] \
                    + terms[p][:, r]
    blocks = part[:, :, :, 0]
    for tm in range(1, Tm):
        blocks = blocks + part[:, :, :, tm]
    sums = blocks[:, :, 0]
    for tile in range(1, tiles):
        sums = sums + blocks[:, :, tile]
    sums = cols(sums)                           # (P, B, D)
    dshift, s_dhxn = sums[0], sums[1]
    dscale = s_dhxn * w.float()
    acc_groups = []
    for g0 in range(0, Bx, 8):
        acc = torch.zeros(D)
        for b in range(g0, min(Bx, g0 + 8)):
            acc = acc + s_dhxn[b] * (1.0 + scale[b].float())
        acc_groups.append(acc)
    dw = acc_groups[0]
    for acc in acc_groups[1:]:
        dw = dw + acc
    cd = scale.dtype
    if not res:
        return (cols(O).to(x.dtype), dw, dshift.to(cd), dscale.to(cd))
    return (cols(DY).to(x.dtype), cols(O).to(x.dtype), sums[2].to(cd), dw,
            dshift.to(cd), dscale.to(cd))


def _ulp2(ref):
    m = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def _hold(name, got, want, n_rows):
    """The card's bars: row grads first (n_rows of them), then the sums."""
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        r = torch.as_tensor(np.asarray(r, np.float32)) \
            if not isinstance(r, torch.Tensor) else r
        assert tuple(g.shape) == tuple(r.shape), (name, i)
        err = float((g.float() - r.float()).abs().max())
        if g.dtype == torch.bfloat16 or r.dtype == torch.bfloat16:
            tol = _ulp2(r)
        elif i < n_rows:
            tol = 1e-4
        else:
            tol = 1e-5 * float(r.float().abs().max())
        assert err <= tol, (name, i, err, tol)


def _torch(t, key, tdt):
    a = torch.from_numpy(t[key])
    return a if key == 'w' else a.to(tdt)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('D', [64, 1280])
def test_ln_modulate_order_matches_plain_and_pallas(D, dtype):
    jdt, tdt = _DT[dtype]
    t = _inputs(D)
    x, w, scale, dh = (_torch(t, k, tdt) for k in ('x', 'w', 'scale', 'dh'))
    got = emulate_bwd(x, w, scale, dh)
    _hold('plain', got, tad.ln_modulate_bwd_plain(x, w, scale, dh), 1)
    args = [jnp.asarray(t[k], jnp.float32 if k == 'w' else jdt)
            for k in ('x', 'w', 'shift', 'scale')]
    _, vjp = jax.vjp(lambda *a: jad.ln_modulate(*a, interpret=True), *args)
    want = jax.block_until_ready(vjp(jnp.asarray(t['dh'], jdt)))
    _hold('pallas', got, [torch.from_numpy(np.array(a.astype(jnp.float32)))
                          .to(g.dtype) for a, g in zip(want, got)], 1)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('D', [64, 1280])
def test_gate_res_ln_modulate_order_matches_plain_and_pallas(D, dtype):
    jdt, tdt = _DT[dtype]
    t = _inputs(D, seed=8)
    keys = ('y', 'skip', 'gate', 'w', 'shift', 'scale')
    (x_new, _), vjp = jax.vjp(
        lambda *a: jad.gate_res_ln_modulate(*a, interpret=True),
        *(jnp.asarray(t[k], jnp.float32 if k == 'w' else jdt) for k in keys))
    want = jax.block_until_ready(vjp((jnp.asarray(t['dx'], jdt),
                                      jnp.asarray(t['dh'], jdt))))
    x = torch.from_numpy(np.array(x_new.astype(jnp.float32))).to(tdt)
    y, gate, w, scale, dx, dh = (_torch(t, k, tdt) for k in
                                 ('y', 'gate', 'w', 'scale', 'dx', 'dh'))
    got = emulate_bwd(x, w, scale, dh, dx=dx, y=y, gate=gate)
    _hold('plain', got, tad.gate_res_ln_modulate_bwd_plain(
        x, y, gate, w, scale, dx, dh), 2)
    # JAX returns (dy, dskip, dgate, dw, dshift, dscale) in that order.
    _hold('pallas', got, [torch.from_numpy(np.array(a.astype(jnp.float32)))
                          .to(g.dtype) for a, g in zip(want, got)], 2)


@pytest.mark.parametrize('B_, L_, D, esize, res, want', [
    (256, 128, 768, 2, True,
     dict(rows=64, tiles=2, groups=32, warps_per_row=1, vectors_per_lane=3,
          teams=8, threads=256, smem=4 * 768 * (2 + 3 * 8),
          workspace=(3 * 256 * 2 + 32) * 768)),
    (256, 256, 768, 2, False,
     dict(rows=64, tiles=4, groups=32, warps_per_row=1, vectors_per_lane=3,
          teams=8, threads=256, smem=4 * 768 * (1 + 2 * 8),
          workspace=(2 * 256 * 4 + 32) * 768)),
    (1, 100, 768, 4, True,
     dict(rows=64, tiles=2, groups=1, warps_per_row=2, vectors_per_lane=3,
          teams=4, threads=256, smem=4 * (768 * (2 + 3 * 4) + 4 * 4 * 2),
          workspace=(3 * 2 + 1) * 768)),
    (3, 40, 64, 2, False,
     dict(rows=64, tiles=1, groups=1, warps_per_row=1, vectors_per_lane=1,
          teams=8, threads=256, smem=4 * 256 * (1 + 2 * 8),
          workspace=(2 * 3 + 1) * 64)),
    (2, 64, 8192, 2, True,
     dict(rows=64, tiles=1, groups=1, warps_per_row=8, vectors_per_lane=4,
          teams=1, threads=256, smem=4 * (8192 * (2 + 3) + 4 * 8),
          workspace=(3 * 2 + 1) * 8192)),
    (9, 65, 4096, 4, False,
     dict(rows=64, tiles=2, groups=2, warps_per_row=8, vectors_per_lane=4,
          teams=1, threads=256, smem=4 * (4096 * (1 + 2) + 4 * 8),
          workspace=(2 * 9 * 2 + 2) * 4096)),
    (2, 64, 1280, 2, True,
     dict(rows=64, tiles=1, groups=1, warps_per_row=2, vectors_per_lane=3,
          teams=4, threads=256, smem=4 * (1536 * (2 + 3 * 4) + 4 * 4 * 2),
          workspace=(3 * 2 + 1) * 1280)),
])
def test_bwd_plan_grid_and_workspace(B_, L_, D, esize, res, want):
    """The wrapper's launch arithmetic: every row tile of every batch row
    a block, every column owned by one lane of a row's team, the shared
    memory under a block's 227 KB, and the workspace the kernels index."""
    plan = tad.bwd_plan(B_, L_, D, esize, res)
    assert plan == want
    N = 16 // esize
    TT = 32 * plan['warps_per_row']
    owned = sorted((t + k * TT) * N + i for k in range(plan['vectors_per_lane'])
                   for t in range(TT) for i in range(N)
                   if t + k * TT < D // N)
    assert owned == list(range(D))
    assert plan['tiles'] * plan['rows'] >= L_ > (plan['tiles'] - 1) * 64
    assert plan['smem'] <= 232448
    assert plan['threads'] == 32 * plan['warps_per_row'] * plan['teams'] \
        <= 256
