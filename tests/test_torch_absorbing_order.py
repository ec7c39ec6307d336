"""A torch emulation of the work split of K7 and K8 (`ddg_tpu_torch/csrc/
absorbing_sample.cu`), held against the plain versions
(`ddg_tpu_torch.ops.fused_sampling`) and the Pallas kernels of
`ddg_tpu/ops/fused_sampling.py` in interpret mode, all fed one external
Gumbel made with numpy from a seed.

The emulation follows the kernel step by step: one block a row of
kRowWarps warps (read from the source), each warp a contiguous run of the
row's column groups; a group of N = 8 bf16 or 4 fp32 columns starts at a
multiple of 4 and is formed from the lane's 16-byte vector and the first
words of the next lane's (lane 31: lane 0's vector of the next turn), by
the source's word selects and funnel shift; a vector is loaded only while
it holds a column of the row and lies in or just past the warp's run. Per
group: the max of z, one exp2 a column into the online sum, the best
z + g against the thread's running best (the first group kept on ties);
then the lanes' butterfly merges, the warps in order, and the winning
group formed again to take its first column with the best z + g, scored
((z - lse) + log_move) + g against log_stay + g_mask. The exp2 is the
CPU's, not the SFU's: the emulation holds the order, not the bits.

Tokens must equal the plain version's and JAX's wherever the plain
version's top-two gap exceeds 1e-4; decoded tokens are copied over; equal
scores go to the lowest index; the mask column wins where log_stay
dominates. Parametrised over V (37, 257 and 1031: one group a lane or
less, and a few), the first row's offset into a 16-byte-aligned buffer
(every phase mod 8; an odd V then puts the other rows at every phase),
the mask index (0, mid-row, V - 1), bf16 and fp32, CFG on and off. The
noise's polynomial inner log (its coefficients read from `common.cuh`,
where K7 shares it with K10 and K12) is held against float64."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops import fused_sampling as jfs
from ddg_tpu_torch.ops import fused_sampling as tfs

torch.set_num_threads(1)
CSRC = Path(__file__).resolve().parents[1] / 'ddg_tpu_torch' / 'csrc'
SRC = (CSRC / 'absorbing_sample.cu').read_text()
# The noise (`ddg::neg_log`, `ddg::gumbel`) that K7 and K8 share with K10
# and K12.
NOISE_SRC = (CSRC / 'common.cuh').read_text()
ROW_WARPS = int(re.search(r'constexpr int kRowWarps = (\d+);', SRC).group(1))
B, L = 2, 8
MARGIN = 1e-4
GAMMA = 2.0
PAD = 8                      # elements before and after the data
NEG = np.float32(-1e30)
L2E = np.float32(1.44269504088896341)
M32 = 0xFFFFFFFF


def _f32(bits):
    """float32 values of 32-bit patterns held in int64."""
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32).view(torch.float32)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


class Buffer:
    """A (B, L, V) logits tensor `off` elements into a 16-byte-aligned
    buffer with PAD elements of other data around it; `words(m)` reads the
    kernel's 16-byte vectors as 32-bit words."""

    def __init__(self, values, dtype, off, gen):
        self.dtype, self.off = dtype, off
        n = values.size
        pad = gen.randn(PAD + off + n + PAD).astype(np.float32)
        pad[PAD + off:PAD + off + n] = values.ravel()
        buf = torch.from_numpy(pad).to(dtype)
        self.data = buf[PAD + off:PAD + off + n].view(values.shape)
        self.bits = (buf.view(torch.int16).long() & 0xFFFF
                     if dtype == torch.bfloat16
                     else buf.view(torch.int32).long() & M32)
        self.N = 8 if dtype == torch.bfloat16 else 4

    def start(self, row, V):
        """The buffer index of the row's column 0."""
        return PAD + self.off + row * V

    def words(self, first, m, ok):
        """The words of vectors m (any shape) whose first element is at
        buffer index first + N m; zeros where not ok."""
        idx = (first + self.N * m)[..., None] + torch.arange(self.N)
        idx = torch.where(ok[..., None], idx, 0)
        e = self.bits[idx]
        if self.N == 8:
            e = e[..., 0::2] | (e[..., 1::2] << 16)
        return torch.where(ok[..., None], e, 0)

    def column(self, row, V, cols):
        """fp32 values of the row's columns (0 outside [0, V))."""
        ok = (cols >= 0) & (cols < V)
        idx = torch.where(ok, self.start(row, V) + cols, 0)
        e = self.bits[idx]
        v = _f32(e << 16 if self.N == 8 else e)
        return torch.where(ok, v, torch.zeros_like(v))


def _shift(cur, head, s, N):
    """Columns s..s+N-1 of (cur, head), as `Cols<T>::shift` forms them."""
    w = [cur[..., k] for k in range(4)] + [head[..., k] for k in range(4)]
    if N == 8:
        t = [w[k + 1] if s & 2 else w[k] for k in range(5)]
        sh = 16 * (s & 1)
        return torch.stack([((t[k + 1] << 32 | t[k]) >> sh) & M32
                            for k in range(4)], -1)
    t = [w[k + 2] if s & 2 else w[k] for k in range(6)]
    t = [t[k + 1] if s & 1 else t[k] for k in range(5)]
    return torch.stack(t[:4], -1)


def _unpack(words, N):
    if N == 4:
        return _f32(words)
    lo, hi = _f32((words << 16) & M32), _f32(words & 0xFFFF0000)
    return torch.stack([lo, hi], -1).flatten(-2)


def _merge_ms(m, s, m2, s2):
    mx = torch.maximum(m, m2)
    return mx, s * torch.exp(m - mx) + s2 * torch.exp(m2 - mx)


def _merge_arg(v, i, v2, i2):
    take = (v2 > v) | ((v2 == v) & (i2 < i))
    return torch.where(take, v2, v), torch.where(take, i2, i)


def _philox(c, k0):
    """Philox4x32-10 on int64 tensors holding 32-bit words (counter c, a
    list of four; key (k0, 0)), as `csrc/common.cuh` runs it."""
    def mulhilo(a, m):
        p = a * m
        return (p >> 32) & M32, p & M32
    k1 = 0
    for _ in range(10):
        hi0, lo0 = mulhilo(c[0], 0xD2511F53)
        hi1, lo1 = mulhilo(c[2], 0xCD9E8D57)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c


def philox_words(seed, b, l, V):
    """The 32-bit words of the in-kernel noise of row (b, l), columns
    0..V-1: counter (v / 4, l, b, 0), key (seed, 0), word v % 4."""
    v = torch.arange(V)
    z = torch.zeros_like(v)
    c = _philox([v >> 2, z + l, z + b, z], seed & M32)
    return torch.stack(c, -1).gather(-1, (v & 3)[:, None])[:, 0]


def gumbel_of(words):
    u = (words >> 8).float() * (1.0 / 16777216.0) + 1e-10
    return -torch.log(-torch.log(u))


class Noise:
    """The row's Gumbel noise: external (a (B, L, V) tensor), or the
    in-kernel Philox draws, formed only where the kernel forms them
    (`prune`) or at every column."""

    def __init__(self, gumbel=None, seed=None, prune=True):
        self.gumbel, self.seed, self.prune = gumbel, seed, prune
        self.formed = self.columns = 0

    def row(self, b, l, V):
        if self.gumbel is not None:
            return self.gumbel[b, l], None
        w = philox_words(self.seed, b, l, V)
        return gumbel_of(w), w >> 8


def _kmax(wbest, vm):
    """The largest top 24 bits of a column whose noise the kernel does not
    form: t = wbest - vm less its margin, c = 2^(-t log2 e) (1 + 2^-16),
    floor(2^24 - 1 - c 2^24)."""
    f = torch.float32
    t = wbest - vm - (torch.tensor(1e-3, dtype=f)
                      + wbest.abs() * torch.tensor(2.0 ** -20, dtype=f))
    c = torch.exp2(-t * L2E) * torch.tensor(1 + 2.0 ** -16, dtype=f)
    x = torch.floor(_fma(-c, torch.tensor(16777216.0), torch.tensor(
        16777215.0)).double())
    x = torch.where(torch.isnan(x), 0.0, x.clamp(-2.0 ** 31, 2.0 ** 31 - 1))
    return x.long()


def _row(row, V, mask, bc, bu, noise, mct, mcs, b, l):
    """The kernel's token for one masked row."""
    N = bc.N
    first = bc.start(row, V)
    a = first % N
    s, a0 = a & 3, a - (a & 3)
    G = -(-(V + a0) // N)
    end = -(-(V + a) // N)
    span = -(-G // ROW_WARPS)
    lane = torch.arange(32)[None, :]
    g0 = (torch.arange(ROW_WARPS) * span)[:, None]
    g1 = torch.clamp(g0 + span, max=G)
    uvec = bu is not None and bu.start(row, V) % N == a
    head_words = 2 if N == 8 else 3

    def load(buf, m):
        ok = (m <= g1) & (m < end)
        return buf.words(buf.start(row, V) - a, m, ok)

    def head(cur, nxt):
        x = torch.where((lane == 0)[..., None], nxt, cur)
        h = x[:, (torch.arange(32) + 1) % 32]
        return torch.where(torch.arange(4) < head_words, h, 0)

    def mix(zc, zu):
        return (torch.tensor(GAMMA, dtype=torch.float32) * zc
                + torch.tensor(1 - GAMMA, dtype=torch.float32) * zu)

    g_row, k_row = noise.row(b, l, V)
    m = torch.full((ROW_WARPS, 32), float(NEG))
    ssum = torch.zeros((ROW_WARPS, 32))
    best = torch.full((ROW_WARPS, 32), -math.inf)
    best_g = torch.full((ROW_WARPS, 32), 2 ** 31 - 1, dtype=torch.long)
    cur_c = load(bc, g0 + lane)
    cur_u = load(bu, g0 + lane) if uvec else None
    for gb in range(0, span, 32):
        g = g0 + gb + lane
        nxt_c = load(bc, g + 32)
        nxt_u = load(bu, g + 32) if uvec else None
        grp_c = _shift(cur_c, head(cur_c, nxt_c), s, N) if s else cur_c
        if uvec:
            grp_u = _shift(cur_u, head(cur_u, nxt_u), s, N) if s else cur_u
        cur_c, cur_u = nxt_c, nxt_u
        wbest = best.amax(1, keepdim=True)
        on = g < g1
        cols = (N * g - a0)[..., None] + torch.arange(N)
        z = _unpack(grp_c, N)
        if bu is not None:
            z = mix(z, _unpack(grp_u, N) if uvec else bu.column(row, V, cols))
        z = torch.where((cols < 0) | (cols >= V) | (cols == mask),
                        -math.inf, z)
        mn = torch.maximum(m, z.amax(-1))
        mnl = mn * L2E
        acc = ssum * torch.exp2((m - mn) * L2E)
        for e in range(N):
            acc = acc + torch.exp2(_fma(z[..., e], torch.tensor(L2E), -mnl))
        ssum, m = torch.where(on, acc, ssum), torch.where(on, mn, m)
        ok = (cols >= 0) & (cols < V)
        at = torch.where(ok, cols, 0)
        gv = torch.where(ok, g_row[at], 0.0)
        sc = z + gv
        if k_row is not None:
            formed = k_row[at] > _kmax(wbest, z.amax(-1))[..., None]
            if noise.prune:
                sc = torch.where(formed, sc, -math.inf)
            live = on[..., None] & ok & (cols != mask)
            noise.formed += int((formed & live).sum())
            noise.columns += int(live.sum())
        sm = sc.amax(-1)
        better = on & (sm > best)
        best = torch.where(better, sm, best)
        best_g = torch.where(better, g, best_g)
    for o in (16, 8, 4, 2, 1):
        src = torch.arange(32) ^ o
        m, ssum = _merge_ms(m, ssum, m[:, src], ssum[:, src])
        best, best_g = _merge_arg(best, best_g, best[:, src], best_g[:, src])
    m, ssum, best, best_g = m[:, 0], ssum[:, 0], best[:, 0], best_g[:, 0]
    mw, sw, bw, gw = m[0], ssum[0], best[0], best_g[0]
    for w in range(1, ROW_WARPS):
        mw, sw = _merge_ms(mw, sw, m[w], ssum[w])
        bw, gw = _merge_arg(bw, gw, best[w], best_g[w])
    if int(gw) == 2 ** 31 - 1:
        return mask
    cols = N * int(gw) - a0 + torch.arange(N)
    z = bc.column(row, V, cols)
    if bu is not None:
        z = mix(z, bu.column(row, V, cols))
    inn = (cols >= 0) & (cols < V) & (cols != mask)
    gv = g_row[torch.where((cols >= 0) & (cols < V), cols, 0)]
    hit = (inn & ((z + gv) == bw)).nonzero()
    assert len(hit), 'the winning group formed again lacks its best'
    e = int(hit[0, 0])
    lse = mw + torch.log(sw)
    log_move = torch.log(mct[b] - mcs[b])
    log_stay = torch.log(mcs[b])
    score = ((z[e] - lse) + log_move) + gv[e]
    score_mask = log_stay + g_row[mask]
    v = int(cols[e])
    return v if score > score_mask or (score == score_mask and v < mask) \
        else mask


def emulate(xt, bc, bu, mct, mcs, noise, mask):
    """The kernel's tokens (B, L) int32, K8 when bu is given; `noise` a
    Noise or an external (B, L, V) Gumbel tensor."""
    if not isinstance(noise, Noise):
        noise = Noise(gumbel=noise)
    Bt, Lt, V = bc.data.shape
    out = xt.clone()
    for b in range(Bt):
        for l in range(Lt):
            if int(xt[b, l]) == mask:
                out[b, l] = _row(b * Lt + l, V, mask, bc, bu, noise, mct,
                                 mcs, b, l)
    return out


def _inputs(V, dtype, mask, off, seed, scale=3.0):
    """Logits (cond at offset off, uncond at off or, for one phase,
    another), xt 70% masked, move chances and a numpy Gumbel."""
    r = np.random.RandomState(seed)
    lc = (r.randn(B, L, V) * scale).astype(np.float32)
    lu = (r.randn(B, L, V) * scale).astype(np.float32)
    x0 = r.randint(0, V, (B, L))
    x0 = np.where(x0 == mask, (x0 + 1) % V, x0)
    xt = np.where(r.rand(B, L) < 0.7, mask, x0).astype(np.int32)
    mct = r.uniform(0.4, 0.9, B).astype(np.float32)
    mcs = (0.6 * mct).astype(np.float32)
    g = r.gumbel(size=(B, L, V)).astype(np.float32)
    bc = Buffer(lc, dtype, off, r)
    bu = Buffer(lu, dtype, off if off % 3 else (off + 5) % 8, r)
    return bc, bu, torch.from_numpy(xt), torch.from_numpy(mct), \
        torch.from_numpy(mcs), torch.from_numpy(g)


def _check_tokens(got, want, z, xt, mct, mcs, g, mask):
    scores = tfs.perturbed_scores(0, z, mct, mcs, mask_index=mask, gumbel=g)
    top2 = scores.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > MARGIN) & (xt == mask)
    assert decided.sum() > 0.8 * (xt == mask).sum()
    np.testing.assert_array_equal(got[decided].numpy(),
                                  want[decided].numpy())
    np.testing.assert_array_equal(got[xt != mask].numpy(),
                                  xt[xt != mask].numpy())


DTYPES = {'bf16': torch.bfloat16, 'f32': torch.float32}


def _masks(V):
    return {'first': 0, 'mid': V // 2, 'last': V - 1}


@pytest.mark.parametrize('cfg', [False, True], ids=['k7', 'k8'])
@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('where', ['first', 'mid', 'last'])
@pytest.mark.parametrize('off', range(8))
@pytest.mark.parametrize('V', [37, 257, 1031])
def test_emulation_matches_plain(V, off, where, dtype, cfg):
    mask = _masks(V)[where]
    bc, bu, xt, mct, mcs, g = _inputs(V, DTYPES[dtype], mask, off,
                                      V + 8 * off + cfg)
    got = emulate(xt, bc, bu if cfg else None, mct, mcs, g, mask)
    if cfg:
        want = tfs.fused_absorbing_cfg_sample(
            0, xt, bc.data, bu.data, GAMMA, mct, mcs, mask_index=mask,
            gumbel=g)
        z = tfs.cfg_mix(bc.data, bu.data, GAMMA)
    else:
        want = tfs.fused_absorbing_sample(0, xt, bc.data, mct, mcs,
                                          mask_index=mask, gumbel=g)
        z = bc.data.float()
    _check_tokens(got, want, z, xt, mct, mcs, g, mask)


@pytest.mark.parametrize('cfg', [False, True], ids=['k7', 'k8'])
@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('where', ['first', 'mid', 'last'])
@pytest.mark.parametrize('V', [37, 257, 1031])
def test_emulation_matches_pallas(V, where, dtype, cfg):
    """JAX's kernels in interpret mode on the same inputs; the emulation at
    two phases of the first row (0 and 3)."""
    mask = _masks(V)[where]
    jdt = jnp.bfloat16 if dtype == 'bf16' else jnp.float32
    for off in (0, 3):
        bc, bu, xt, mct, mcs, g = _inputs(V, DTYPES[dtype], mask, off,
                                          2 * V + off + cfg)
        jl = [jnp.asarray(x.data.float().numpy()).astype(jdt)
              for x in (bc, bu)]
        args = (jnp.asarray(xt.numpy()),)
        margs = (jnp.asarray(mct.numpy()), jnp.asarray(mcs.numpy()))
        if cfg:
            want = jfs.fused_absorbing_cfg_sample(
                3, *args, jl[0], jl[1], GAMMA, *margs, mask_index=mask,
                interpret=True, gumbel=jnp.asarray(g.numpy()))
            z = tfs.cfg_mix(bc.data, bu.data, GAMMA)
        else:
            want = jfs.fused_absorbing_sample(
                3, *args, jl[0], *margs, mask_index=mask, interpret=True,
                gumbel=jnp.asarray(g.numpy()))
            z = bc.data.float()
        want = torch.from_numpy(np.array(want))
        got = emulate(xt, bc, bu if cfg else None, mct, mcs, g, mask)
        _check_tokens(got, want, z, xt, mct, mcs, g, mask)


@pytest.mark.parametrize('scale', [3.0, 40.0])
@pytest.mark.parametrize('cfg', [False, True], ids=['k7', 'k8'])
@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('where', ['first', 'mid', 'last'])
@pytest.mark.parametrize('V', [257, 1031])
def test_pruned_noise_is_exact(V, where, dtype, cfg, scale):
    """The in-kernel noise: the tokens with the noise formed only where the
    kernel forms it equal those with it formed at every column, bit for
    bit, and the plain version's fed the same draws wherever the gap
    exceeds 1e-4."""
    mask = _masks(V)[where]
    bc, bu, xt, mct, mcs, _ = _inputs(V, DTYPES[dtype], mask, 3, V + cfg,
                                      scale)
    bu = bu if cfg else None
    seed = 1234 + V
    pruned, full = Noise(seed=seed), Noise(seed=seed, prune=False)
    got = emulate(xt, bc, bu, mct, mcs, pruned, mask)
    assert torch.equal(got, emulate(xt, bc, bu, mct, mcs, full, mask))
    g = torch.stack([torch.stack([gumbel_of(philox_words(seed, b, l, V))
                                  for l in range(L)]) for b in range(B)])
    if cfg:
        want = tfs.fused_absorbing_cfg_sample(
            0, xt, bc.data, bu.data, GAMMA, mct, mcs, mask_index=mask,
            gumbel=g)
        z = tfs.cfg_mix(bc.data, bu.data, GAMMA)
    else:
        want = tfs.fused_absorbing_sample(0, xt, bc.data, mct, mcs,
                                          mask_index=mask, gumbel=g)
        z = bc.data.float()
    _check_tokens(got, want, z, xt, mct, mcs, g, mask)


def test_noise_formed_for_few_columns():
    """A row of 8 turns a warp (V = 16411): past each warp's first turn the
    noise of most columns is never formed, and the tokens are those of the
    noise formed everywhere."""
    V, mask = 16411, 16410
    r = np.random.RandomState(5)
    bc = Buffer((r.randn(1, 2, V) * 3).astype(np.float32), torch.bfloat16,
                1, r)
    xt = torch.full((1, 2), mask, dtype=torch.int32)
    mct, mcs = torch.tensor([0.8]), torch.tensor([0.3])
    pruned, full = Noise(seed=77), Noise(seed=77, prune=False)
    got = emulate(xt, bc, None, mct, mcs, pruned, mask)
    assert torch.equal(got, emulate(xt, bc, None, mct, mcs, full, mask))
    assert pruned.formed < 0.3 * pruned.columns, (pruned.formed,
                                                  pruned.columns)


@pytest.mark.parametrize('where', ['first', 'mid', 'last'])
@pytest.mark.parametrize('V', [37, 1031])
def test_ties_and_the_mask_channel(V, where):
    """Every score equal outside the mask: the lowest index wins; log_stay
    far above the rest: the mask channel wins."""
    mask = _masks(V)[where]
    r = np.random.RandomState(V)
    zero = np.zeros((B, L, V), np.float32)
    xt = torch.full((B, L), mask, dtype=torch.int32)
    g = torch.zeros((B, L, V))
    mct = torch.full((B,), 0.9)
    for mcs_value, want in ((1e-6, 1 if mask == 0 else 0), (0.8999, mask)):
        mcs = torch.full((B,), mcs_value)
        for off in range(4):
            bc = Buffer(zero, torch.bfloat16, off, r)
            for bu in (None, Buffer(zero, torch.bfloat16, off + 1, r)):
                got = emulate(xt, bc, bu, mct, mcs, g, mask)
                assert bool((got == want).all())
        plain = tfs.fused_absorbing_sample(0, xt, bc.data, mct, mcs,
                                           mask_index=mask, gumbel=g)
        assert bool((plain == want).all())


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('V', [1, 2, 5, 9, 37, 130, 257, 1031])
def test_groups_cover_the_row_once(V, dtype):
    """Every phase of the row's start: the warps' runs of groups cover the
    columns [0, V) once each, each group starts at a multiple of 4, and
    every vector a group takes a column from is one the lanes load (it
    holds a column of the row and lies in or just past the warp's run)."""
    N = 8 if dtype == 'bf16' else 4
    for a in range(N):
        s, a0 = a & 3, a - (a & 3)
        G = -(-(V + a0) // N)
        end = -(-(V + a) // N)
        span = -(-G // ROW_WARPS)
        seen = np.zeros(V, int)
        for w in range(ROW_WARPS):
            g0, g1 = w * span, min(G, w * span + span)
            for g in range(g0, g1):
                cols = np.arange(N * g - a0, N * g - a0 + N)
                seen[cols[(cols >= 0) & (cols < V)]] += 1
                assert (N * g - a0) % 4 == 0
                for m in (g, g + 1) if s else (g,):
                    need = [c for c in range(N * m - a, N * m - a + N)
                            if c in set(cols) and 0 <= c < V]
                    if need:
                        assert m < end and m <= g1
        assert (seen == 1).all(), (V, a)


def _neg_log_coefficients():
    body = NOISE_SRC[NOISE_SRC.index('float neg_log(float u)'):]
    body = body[:body.index('\n}\n')]
    first = float(re.search(r'float r = ([-0-9.e]+)f;', body).group(1))
    rest = [float(x) for x in re.findall(
        r'r = __fmaf_rn\(r, f, ([-0-9.e]+)f\);', body)]
    return [first] + rest


def test_gumbel_inner_log_polynomial():
    """The noise's -log(u) (`neg_log`: u = 2^e m, m in [2/3, 4/3), log1p by
    the source's polynomial, fp32 FMAs) within 2e-7 of itself against
    float64 at every 24-bit uniform at a stride and at both ends, so g =
    -log(-log(u)) is within 2e-7 absolute before the outer log's
    rounding."""
    coef = [np.float32(c) for c in _neg_log_coefficients()]
    assert len(coef) == 7
    top = np.concatenate([np.arange(0, 1 << 24, 97),
                          np.arange(0, 1 << 15),
                          np.arange((1 << 24) - (1 << 15), 1 << 24)])
    u = (top.astype(np.float32) * np.float32(1 / 16777216)
         + np.float32(1e-10)).astype(np.float32)

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)
    ib = u.view(np.int32).astype(np.int64)
    e = (ib - 0x3f2aaaab) >> 23
    f = ((ib - (e << 23)).astype(np.int32).view(np.float32)
         - np.float32(1)).astype(np.float32)
    r = np.full_like(f, coef[0])
    for c in coef[1:]:
        r = fma(r, f, c)
    q = fma(r, f, np.float32(-0.5))
    p = fma(q, (f * f).astype(np.float32), f)
    w = -fma(e.astype(np.float32), np.float32(math.log(2)), p)
    ref = -np.log(u.astype(np.float64))
    rel = np.abs(w.astype(np.float64) / ref - 1)
    assert rel.max() < 2e-7, rel.max()


if __name__ == '__main__':
    # The share of the logits whose noise the kernel forms, at the main
    # path's V with logits of scale 2 (as chip_smoke.py draws them), two
    # rows:  PYTHONPATH=. python3 tests/test_torch_absorbing_order.py
    V = 30523
    r = np.random.RandomState(5)
    bc = Buffer((r.randn(1, 2, V) * 2).astype(np.float32), torch.bfloat16,
                1, r)
    noise = Noise(seed=77)
    emulate(torch.full((1, 2), V - 1, dtype=torch.int32), bc, None,
            torch.tensor([0.8]), torch.tensor([0.3]), noise, V - 1)
    print(f'V={V}: noise formed for {noise.formed} of {noise.columns} '
          f'logits ({noise.formed / noise.columns:.4f})')
