"""The association of the adaLN kernels of `ddg_tpu_torch/csrc/adaln.cu`
emulated in fp32 with PyTorch on the CPU: the forward K3 (`ln_modulate`)
and the backwards K4, K6, against the plain versions
(`ddg_tpu_torch.ops.adaln.*_plain`) and against `ddg_tpu/ops/
adaln_pallas.py` (its forward, and `jax.vjp` of it) in interpret mode, on
numpy-seeded inputs at B = 3, L = 40 (not a multiple of a block's rows),
in float32 and bfloat16; and the launch arithmetic the wrappers compute
(`ops.adaln.fwd_plan`, `bwd_plan`).

The emulations follow the plans' mapping: a row to a team of warps, lane
t of it holding vectors t, t + 32 G, ... of the row; each lane's sums
over its elements in order, a shuffle butterfly over the warp, the team's
warps in order. K3 then normalises each element in fp32. For the
backwards, each team's per-column partials over its rows in row order,
the block's teams added in team order; per batch row the blocks' partials
in tile order; dw over groups of 8 batch rows in order, then the groups
in order. D = 64 takes one warp a row; D = 768 one warp of 3 vectors a
lane in bfloat16 (96 vectors), two warps in float32 (192 vectors); D =
1280 in bfloat16 (160 vectors) two warps a row of 3 vectors a lane, in
float32 (320 vectors) three of 4.

Bars, the card's (`chip_smoke.check_adaln`, `check_adaln_bwd`): rows (h,
the row grads) in float32 to 1e-4 absolute, in bfloat16 to 2 ulp of the
reference's largest magnitude; the sums (dw and the conditioning grads) in
float32 to 1e-5 of the reference's largest magnitude, in bfloat16 to 2
ulp of it. The emulations' rsqrt and products are PyTorch's, not the
card's, so they are held to the bars and not to bits.
"""

import math
import re
from pathlib import Path

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


CSRC = Path(__file__).resolve().parents[1] / 'ddg_tpu_torch' / 'csrc'
SRC = (CSRC / 'adaln.cu').read_text()


def _const(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', SRC).group(1))


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


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def emulate_fwd(x, w, shift, scale):
    """K3's fp32 association (`fwd_plan`'s mapping): h in x's dtype."""
    Bx, Lx, D = x.shape
    plan = tad.fwd_plan(Bx, Lx, D, x.element_size())
    N = 16 // x.element_size()
    G, V = plan['warps_per_row'], plan['vectors_per_lane']
    TT = 32 * G
    pad = V * TT * N - D

    def lanes(a):           # (..., D) -> (..., V, TT, N), zeros past D
        return F.pad(a.float(), (0, pad)).reshape(*a.shape[:-1], V, TT, N)

    X = lanes(x)
    s1 = torch.zeros(Bx, Lx, TT)
    s2 = torch.zeros(Bx, Lx, TT)
    for k in range(V):
        for i in range(N):
            v = X[:, :, k, :, i]
            s1 = s1 + v
            s2 = _fma(v, v, s2)
    m1 = _team_sum(s1, G) / D
    m2 = _team_sum(s2, G) / D
    r = torch.rsqrt(torch.clamp_min(m2 - m1 * m1, 0.0) + 1e-5)
    mul = w.float() * (1.0 + scale.float())              # (B, D)
    xn = (x.float() - m1[..., None]) * r[..., None]
    return (xn * mul[:, None] + shift.float()[:, None]).to(x.dtype)


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
@pytest.mark.parametrize('D', [64, 768, 1280])
def test_ln_modulate_fwd_order_matches_plain_and_pallas(D, dtype):
    """K3's association against the plain forward and the Pallas kernel,
    with the conditioning as chunks of one (B, 6 D) projection."""
    jdt, tdt = _DT[dtype]
    t = _inputs(D, seed=9)
    mod = np.concatenate([t['shift'], t['scale']] + [t['gate']] * 4, 1)
    cond = torch.from_numpy(mod).to(tdt)
    shift, scale = cond[:, :D], cond[:, D:2 * D]
    x, w = _torch(t, 'x', tdt), _torch(t, 'w', tdt)
    got = emulate_fwd(x, w, shift, scale)
    _hold('plain', [got], [tad.ln_modulate_plain(x, w, shift, scale)], 1)
    want = jax.block_until_ready(jax.jit(
        lambda *a: jad.ln_modulate(*a, interpret=True))(
        *(jnp.asarray(t[k], jnp.float32 if k == 'w' else jdt)
          for k in ('x', 'w', 'shift', 'scale'))))
    _hold('pallas', [got], [torch.from_numpy(np.array(
        want.astype(jnp.float32))).to(tdt)], 1)


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


def _fwd_plan_from_source(B_, L_, D, esize):
    """K3's plan computed from `adaln.cu`'s own constants and rule."""
    body = SRC[SRC.index('FwdPlan fwd_plan(int B, int L, int nvec) {'):]
    body = ' '.join(body[:body.index('\n}\n')].split())
    assert ('p.R = 32; for (int r = 128; r > 32; r /= 2) if (static_cast<long '
            'long>(B) * ((L + r - 1) / r) >= kFwdMinBlocks) { p.R = r; '
            'break; }' in body)
    assert ('p.hold = p.G <= kFwdWarps; p.T = p.hold ? kFwdWarps / p.G : 1;'
            in body)
    lane_vec, warps = _const('kLaneVec'), _const('kFwdWarps')
    min_blocks = _const('kFwdMinBlocks')
    nvec = D // (16 // esize)
    assert nvec <= _const('kMaxRowVec')
    R = next((r for r in (128, 64) if B_ * -(-L_ // r) >= min_blocks), 32)
    G = -(-nvec // (32 * lane_vec))
    hold = G <= warps
    T = warps // G if hold else 1
    tiles = -(-L_ // R)
    return dict(rows=R, tiles=tiles, blocks=B_ * tiles, warps_per_row=G,
                vectors_per_lane=-(-nvec // (32 * G)), teams=T,
                threads=T * G * 32, hold=int(hold))


@pytest.mark.parametrize('B_, L_, D, esize, want', [
    (48, 128, 768, 2,
     dict(rows=32, tiles=4, blocks=192, warps_per_row=1, vectors_per_lane=3,
          teams=8, threads=256, hold=1)),
    (256, 128, 768, 2,
     dict(rows=128, tiles=1, blocks=256, warps_per_row=1, vectors_per_lane=3,
          teams=8, threads=256, hold=1)),
    (256, 256, 768, 2,
     dict(rows=128, tiles=2, blocks=512, warps_per_row=1, vectors_per_lane=3,
          teams=8, threads=256, hold=1)),
    (128, 128, 768, 4,
     dict(rows=64, tiles=2, blocks=256, warps_per_row=2, vectors_per_lane=3,
          teams=4, threads=256, hold=1)),
    (3, 40, 64, 2,
     dict(rows=32, tiles=2, blocks=6, warps_per_row=1, vectors_per_lane=1,
          teams=8, threads=256, hold=1)),
    (3, 1, 1280, 2,
     dict(rows=32, tiles=1, blocks=3, warps_per_row=2, vectors_per_lane=3,
          teams=4, threads=256, hold=1)),
    (2, 40, 8192, 2,
     dict(rows=32, tiles=2, blocks=4, warps_per_row=8, vectors_per_lane=4,
          teams=1, threads=256, hold=1)),
    (2, 40, 8192, 4,
     dict(rows=32, tiles=2, blocks=4, warps_per_row=16, vectors_per_lane=4,
          teams=1, threads=512, hold=0)),
    (2, 3, 32768, 2,
     dict(rows=32, tiles=1, blocks=2, warps_per_row=32, vectors_per_lane=4,
          teams=1, threads=1024, hold=0)),
])
def test_fwd_plan_grid_and_teams(B_, L_, D, esize, want):
    """K3's launch arithmetic, as `adaln.cu`'s constants and tile rule give
    it: every row of every batch row in one block's tile, every column
    owned by one lane of a row's team, at most 1024 threads a block, at
    most 8 warps a block where the block holds the modulation in
    registers, and the exchange slots (two (s1, s2) pairs a warp of each
    team) inside the kernel's 128 floats."""
    plan = tad.fwd_plan(B_, L_, D, esize)
    assert plan == want == _fwd_plan_from_source(B_, L_, D, esize)
    N = 16 // esize
    TT = 32 * plan['warps_per_row']
    owned = sorted((t + k * TT) * N + i
                   for k in range(plan['vectors_per_lane'])
                   for t in range(TT) for i in range(N)
                   if t + k * TT < D // N)
    assert owned == list(range(D))
    assert plan['tiles'] * plan['rows'] >= L_ > (plan['tiles'] - 1) \
        * plan['rows']
    assert plan['threads'] == 32 * plan['warps_per_row'] * plan['teams'] \
        <= (256 if plan['hold'] else 1024)
    assert plan['teams'] * 4 * plan['warps_per_row'] <= 128
