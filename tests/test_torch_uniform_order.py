"""A torch emulation of the work split of K9 and K10, the uniform steps
with one and two logits tensors (`ddg_tpu_torch/csrc/uniform_sample.cu`:
`uniform_narrow_kernel`, `uniform_wide_kernel`), held against the plain
versions (`ddg_tpu_torch.ops.fused_sampling.fused_uniform_sample_plain`,
`fused_uniform_cfg_sample_plain`) and the Pallas kernels of
`ddg_tpu/ops/fused_sampling.py` in interpret mode, all fed one external
Gumbel made with numpy from a seed.

The emulation follows the kernels as `uniform_plan` chooses them: a
thread a row holding 12, 16 or 32 columns where the vocabulary has at most
32 (columns past it -inf), else a warp a row, a lane 8 consecutive columns
a turn of 256. Each tensor's row max first (the lanes' by a butterfly of
max), then one exp a column, 2^((z - max) log2 e), summed in the thread's
order and over the lanes by the butterfly of adds (past one turn: each
lane's online max and sum, merged by the butterfly of `merge_ms`, and a
second read); p = e * (1 / sum), the numerator's formula and its log, and
with two tensors the mix; then each thread's best score, the lowest index
winning ties, and the warp's. The exps and logs are the CPU's, not the
SFU's: the emulation holds the order, not the bits.

With the in-kernel noise (the Philox words of counter (v / 4, l, b) under
key (seed, 0)) the emulation forms a column's noise only where the kernel
does (`pick_first`, `pick_rest`: each thread's column of the largest lq
first, the rest only where their Philox word's top 24 bits exceed
`ddg::noise_kmax` of the best so far and the largest of their lq, its
constants read from `common.cuh`), and the tokens must equal those of the
noise formed everywhere, bit for bit.

Parametrised over one and two logits tensors (K9, K10), the widths of the
port's uniform paths and the edges of the plan (V = 12, the Species10 DNA
vocabulary; V = 20 with a vocabulary of 16; V = 40 with 30; V = 250 with
243; V = 256, the UNet's pixels; V = 600 with 597, three turns), bf16 and
fp32, and ties."""

import itertools
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
SRC = (CSRC / 'uniform_sample.cu').read_text()
COMMON = (CSRC / 'common.cuh').read_text()
B, L = 2, 8
MARGIN = 1e-4
GAMMA = 2.0
NEG = -1e30
L2E = np.float32(1.44269504088896341)
M32 = 0xFFFFFFFF
F32 = torch.float32


def _const(name, src=SRC):
    return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))


WIDE_COLS = _const('kWideCols')
THREADS = _const('kThreads')
NARROW_ROWS = THREADS
assert 'constexpr int kNarrowRows = kThreads;' in SRC
TURN = 32 * WIDE_COLS
assert 'constexpr int kTurn = 32 * kWideCols;' in SRC


def _kmax_constants():
    """The margin and the scale of `ddg::noise_kmax` from common.cuh."""
    body = COMMON[COMMON.index('int noise_kmax(float best, float x)'):]
    body = body[:body.index('\n}\n')]
    m = re.search(r'best - x - \(([0-9.e-]+)f \+ fabsf\(best\) \* '
                  r'0x1p-(\d+)f\)', body)
    c = re.search(r'\* \(1\.f \+ 0x1p-(\d+)f\)', body)
    assert m and c and '__fmaf_rn(-c, 16777216.f, 16777215.f)' in body
    return float(m.group(1)), 2.0 ** -int(m.group(2)), 2.0 ** -int(c.group(1))


ABS_MARGIN, REL_MARGIN, C_SCALE = _kmax_constants()


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


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


def philox_words(seed, Bt, Lt, V):
    """(Bt, Lt, V) words of the in-kernel noise: counter (v / 4, l, b, 0),
    key (seed, 0), word v % 4."""
    b, l, v = torch.meshgrid(torch.arange(Bt), torch.arange(Lt),
                             torch.arange(V), indexing='ij')
    c = _philox([v >> 2, l, b, torch.zeros_like(v)], seed & M32)
    return torch.stack(c, -1).gather(-1, (v & 3)[..., None])[..., 0]


def gumbel_of(words):
    u = (words >> 8).float() * (1.0 / 16777216.0) + 1e-10
    return -torch.log(-torch.log(u))


def _kmax(best, x):
    """`ddg::noise_kmax`: the largest top 24 bits of a column whose noise
    cannot beat `best` when its score is x + g."""
    t = best - x - (torch.tensor(ABS_MARGIN, dtype=F32)
                    + best.abs() * torch.tensor(REL_MARGIN, dtype=F32))
    c = torch.exp2(-t * L2E) * torch.tensor(1 + C_SCALE, dtype=F32)
    k = torch.floor(_fma(-c, torch.tensor(16777216.0),
                         torch.tensor(16777215.0)).double())
    k = torch.where(torch.isnan(k), 0.0, k.clamp(-2.0 ** 31, 2.0 ** 31 - 1))
    return k.long()


def _take(best, idx, sc, v):
    t = (sc > best) | ((sc == best) & (v < idx))
    return torch.where(t, sc, best), torch.where(t, v, idx)


def _butterfly(x, op):
    """A warp's xor-butterfly over the last dim (32 lanes); every lane ends
    with the result."""
    for o in (16, 8, 4, 2, 1):
        x = op(x, x[..., torch.arange(32) ^ o])
    return x


def _merge_ms(a, b):
    (m, s), (m2, s2) = a, b
    mx = torch.maximum(m, m2)
    return mx, s * torch.exp(m - mx) + s2 * torch.exp(m2 - mx)


def _exps(z, m):
    """2^((z - m) log2 e) in place and their sum in column order."""
    e = torch.exp2(_fma(z, torch.tensor(L2E), -(m * L2E)[..., None]))
    s = torch.zeros(e.shape[:-1])
    for c in range(e.shape[-1]):
        s = s + e[..., c]
    return e, s


class Noise:
    """The in-kernel Philox noise, formed only where the kernel forms it
    (`prune`) or at every column; counts what it forms."""

    def __init__(self, seed, Bt, Lt, V, prune=True):
        self.words = philox_words(seed, Bt, Lt, V)
        self.g = gumbel_of(self.words)
        self.prune = prune
        self.formed = self.columns = 0


def _log_nums(e, inv, cols, xt, k):
    """log(num + 1e-35) of columns `cols` from their exps e (rows, n) and
    1 / sum (rows,), in the source's order of roundings."""
    x = (cols == xt[..., None]).float()
    p = e * inv[..., None]
    num = ((p * (k['a'][..., None] + x * k['axt'][..., None]))
           + x * k['bxt'][..., None]) + k['c'][..., None]
    return torch.log(num + torch.tensor(1e-35, dtype=F32))


def _num_constants(a_t, a_s, vocab):
    vs = torch.tensor(float(vocab), dtype=F32)
    a_ts = a_t / a_s
    return {'a': a_s - a_t, 'axt': a_t * vs, 'bxt': a_ts - a_t,
            'c': ((1 - a_ts) * (1 - a_s)) / vs}


def _mix(lqs, g_mix, omg):
    """K10's mix of its two tensors' log numerators; K9's one as it is."""
    return lqs[0] if len(lqs) == 1 else g_mix * lqs[0] + omg * lqs[1]


def emulate(xt, lc, lu, a_t, a_s, vocab, noise, gamma=GAMMA):
    """K10's tokens (B, L) int32, or K9's where `lu` is None; `noise`: an
    external (B, L, V) Gumbel tensor, or a Noise."""
    Bt, Lt, V = lc.shape
    tensors = [t for t in (lc, lu) if t is not None]
    plan = tfs.uniform_plan(V, vocab, lc.dtype, True)
    rows = Bt * Lt
    x = xt.reshape(rows).long()
    bi = torch.arange(rows) // Lt
    k = _num_constants(a_t[bi], a_s[bi], vocab)
    ext = not isinstance(noise, Noise)
    g_all = (noise if ext else noise.g).reshape(rows, V)
    w_all = None if ext else noise.words.reshape(rows, V)
    g_mix = torch.tensor(gamma, dtype=F32)
    omg = torch.tensor(1 - gamma, dtype=F32)
    if plan['kernel'] == 1:                         # a thread a row
        N = plan['cols']
        cols = torch.arange(N)
        lqs = []
        for t in tensors:
            z = torch.full((rows, N), -math.inf)
            z[:, :vocab] = t.reshape(rows, V)[:, :vocab].float()
            m = torch.clamp(z.amax(-1), min=NEG)
            e, s = _exps(z, m)
            lqs.append(_log_nums(e, 1 / s, cols, x, k))
        lq = _mix(lqs, g_mix, omg)
        valid = cols < vocab
        best = torch.full((rows,), -math.inf)
        idx = torch.full((rows,), 2 ** 31 - 1)
        gv = torch.zeros((rows, N))
        gv[:, :vocab] = g_all[:, :vocab]
        if ext:
            for c in range(vocab):
                best, idx = _take(best, idx, lq[:, c] + gv[:, c],
                                  torch.full((rows,), c))
            return idx.to(torch.int32).reshape(Bt, Lt)
        top = torch.zeros((rows, N), dtype=torch.long)
        top[:, :vocab] = w_all[:, :vocab] >> 8
        first = torch.where(valid, lq, -math.inf).argmax(-1)
        ar = torch.arange(rows)
        best, idx = lq[ar, first] + gv[ar, first], first
        noise.formed += rows
        noise.columns += rows * vocab
        others = valid & (cols != first[:, None])
        kmax = _kmax(best, torch.where(others, lq, -math.inf).amax(-1))
        for c in range(vocab):
            formed = top[:, c] > kmax
            if not noise.prune:
                formed = torch.ones_like(formed)
            formed &= first != c
            noise.formed += int(formed.sum())
            b2, i2 = _take(best, idx, lq[:, c] + gv[:, c],
                           torch.full((rows,), c))
            best, idx = torch.where(formed, b2, best), torch.where(formed,
                                                                     i2, idx)
        return idx.to(torch.int32).reshape(Bt, Lt)
    # A warp a row: (rows, turns, 32 lanes, 8 columns).
    turns = -(-vocab // TURN)
    cols = (torch.arange(turns)[:, None, None] * TURN
            + torch.arange(32)[None, :, None] * WIDE_COLS
            + torch.arange(WIDE_COLS)[None, None, :])
    valid = cols < vocab
    cl = cols.clamp(max=V - 1)

    def grid(t):
        return torch.where(valid, t.reshape(rows, V)[:, cl].float(),
                           -math.inf)
    lqs = []
    for t in tensors:
        z = grid(t)
        if turns == 1:
            m = _butterfly(torch.clamp(z[:, 0].amax(-1), min=NEG),
                           torch.maximum)[:, 0]
            e, s = _exps(z, m[:, None, None].expand(rows, 1, 32))
            s = _butterfly(s[:, 0], torch.add)[:, 0]
        else:
            m = torch.full((rows, 32), NEG)
            s = torch.zeros((rows, 32))
            for u in range(turns):
                nm = torch.maximum(m, z[:, u].amax(-1))
                eu, su = _exps(z[:, u], nm)
                s = s * torch.exp2((m - nm) * L2E) + su
                m = nm
            for o in (16, 8, 4, 2, 1):
                m, s = _merge_ms((m, s), (m[:, torch.arange(32) ^ o],
                                          s[:, torch.arange(32) ^ o]))
            m, s = m[:, 0], s[:, 0]
            e, _ = _exps(z, m[:, None, None].expand(rows, turns, 32))
        inv = 1 / s
        lqs.append(_log_nums(e.reshape(rows, -1), inv, cols.reshape(-1), x, k)
                   .reshape(rows, turns, 32, WIDE_COLS))
    lq = _mix(lqs, g_mix, omg)
    gv = torch.where(valid, g_all[:, cl], 0.0)
    best = torch.full((rows, 32), -math.inf)
    idx = torch.full((rows, 32), 2 ** 31 - 1)
    for u in range(turns):
        if ext:
            for c in range(WIDE_COLS):
                sc = lq[:, u, :, c] + gv[:, u, :, c]
                b2, i2 = _take(best, idx, sc, cols[u, :, c])
                ok = valid[u, :, c]
                best, idx = torch.where(ok, b2, best), torch.where(ok, i2,
                                                                   idx)
            continue
        top = torch.where(valid, w_all[:, cl] >> 8, 0)[:, u]
        lqu, gu, vu = lq[:, u], gv[:, u], valid[u]
        first = torch.full((rows, 32), -1)
        if u == 0:
            lm = torch.where(vu, lqu, -math.inf)
            has = vu.any(-1).expand(rows, 32)
            first = torch.where(has, lm.argmax(-1), -1)
            f = first.clamp(min=0)
            sc = lqu.gather(-1, f[..., None])[..., 0] + gu.gather(
                -1, f[..., None])[..., 0]
            b2, i2 = _take(best, idx, sc, cols[u, :, 0] + f)
            best, idx = torch.where(has, b2, best), torch.where(has, i2, idx)
            noise.formed += int(has.sum())
        floor = _butterfly(best, torch.maximum)
        noise.columns += int(vu.sum()) * rows
        others = vu & (torch.arange(WIDE_COLS) != first[..., None])
        kmax = _kmax(torch.maximum(floor, best),
                     torch.where(others, lqu, -math.inf).amax(-1))
        for c in range(WIDE_COLS):
            ok = vu[:, c] & (first != c)
            formed = top[..., c] > kmax
            if not noise.prune:
                formed = torch.ones_like(formed)
            formed &= ok
            noise.formed += int(formed.sum())
            b2, i2 = _take(best, idx, lqu[..., c] + gu[..., c],
                           cols[u, :, c].expand(rows, 32))
            best, idx = torch.where(formed, b2, best), torch.where(formed,
                                                                     i2, idx)
    for o in (16, 8, 4, 2, 1):
        src = torch.arange(32) ^ o
        best, idx = _take(best, idx, best[:, src], idx[:, src])
    return idx[:, 0].to(torch.int32).reshape(Bt, Lt)


# (V, vocab_size)
WIDTHS = [(12, 12), (20, 16), (40, 30), (250, 243), (256, 256), (600, 597)]
WIDTH_IDS = ['v12', 'v20_vocab16', 'v40_vocab30', 'v250_vocab243', 'v256',
             'v600_vocab597_three_turns']
DTYPES = {'bf16': torch.bfloat16, 'f32': torch.float32}


def _inputs(V, vocab, dtype, seed, scale=3.0):
    r = np.random.RandomState(seed)
    lc = (r.randn(B, L, V) * scale).astype(np.float32)
    lu = (r.randn(B, L, V) * scale).astype(np.float32)
    xt = r.randint(0, vocab, (B, L)).astype(np.int32)
    a_t = r.uniform(0.05, 0.8, B).astype(np.float32)
    a_s = (a_t + (1 - a_t) * r.uniform(0.1, 0.9, B)).astype(np.float32)
    g = r.gumbel(size=(B, L, V)).astype(np.float32)
    tl = [torch.from_numpy(a).to(dtype) for a in (lc, lu)]
    return tl, torch.from_numpy(xt), torch.from_numpy(a_t), \
        torch.from_numpy(a_s), torch.from_numpy(g)


# The number of logits tensors: 2 (K10, `fused_uniform_cfg_sample`) and 1
# (K9, `fused_uniform_sample`); K9's cases carry '-k9' after K10's ids.
N_IN = [1, 2]


def _both(*axes):
    """pytest params of every combination of `axes` (each a list of
    (value, id), the id's parts joined by '-'), for K10 and then for K9,
    the tensor count last."""
    out = []
    for n_in in (2, 1):
        for combo in itertools.product(*axes):
            values = [v for part, _ in combo
                      for v in (part if isinstance(part, tuple) else (part,))]
            ident = '-'.join(i for _, i in combo) + ('-k9' if n_in == 1
                                                      else '')
            out.append(pytest.param(*values, n_in, id=ident))
    return out


_WIDTH_AXIS = list(zip(WIDTHS, WIDTH_IDS))
_DTYPE_AXIS = [(k, k) for k in DTYPES]


def _log_q(lc, lu, xt, a_t, a_s, vocab):
    if lu is None:
        return tfs.uniform_log_num(lc, xt, a_t, a_s, vocab_size=vocab)
    return tfs.uniform_cfg_log_num(lc, lu, GAMMA, xt, a_t, a_s,
                                   vocab_size=vocab)


def _plain(xt, lc, lu, a_t, a_s, vocab, g):
    if lu is None:
        return tfs.fused_uniform_sample_plain(0, xt, lc, a_t, a_s,
                                              vocab_size=vocab, gumbel=g)
    return tfs.fused_uniform_cfg_sample_plain(0, xt, lc, lu, GAMMA, a_t, a_s,
                                              vocab_size=vocab, gumbel=g)


def _pallas(xt, lc, lu, a_t, a_s, vocab, g):
    """JAX's kernel in interpret mode, its logits in the rows' dtype."""
    jdt = jnp.bfloat16 if lc.dtype == torch.bfloat16 else jnp.float32
    jl = [jnp.asarray(t.float().numpy()).astype(jdt)
          for t in (lc, lu) if t is not None]
    args = (jnp.asarray(a_t.numpy()), jnp.asarray(a_s.numpy()))
    kw = dict(vocab_size=vocab, interpret=True, gumbel=jnp.asarray(g.numpy()))
    x = jnp.asarray(xt.numpy())
    if lu is None:
        out = jfs.fused_uniform_sample(3, x, jl[0], *args, **kw)
    else:
        out = jfs.fused_uniform_cfg_sample(3, x, jl[0], jl[1], GAMMA, *args,
                                           **kw)
    return torch.from_numpy(np.array(out))


def _decided(lc, lu, xt, a_t, a_s, g, vocab):
    scores = tfs.uniform_perturbed_scores(
        0, _log_q(lc, lu, xt, a_t, a_s, vocab), vocab_size=vocab, gumbel=g)
    top2 = scores.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > MARGIN


def _check(got, want, decided):
    assert decided.float().mean() > 0.8
    np.testing.assert_array_equal(got[decided].numpy(),
                                  want[decided].numpy())


@pytest.mark.parametrize('V,vocab,dtype,n_in',
                         _both(_WIDTH_AXIS, _DTYPE_AXIS))
def test_emulation_matches_plain_and_pallas(V, vocab, dtype, n_in):
    (lc, lu), xt, a_t, a_s, g = _inputs(V, vocab, DTYPES[dtype],
                                        V + vocab + len(dtype))
    lu = lu if n_in == 2 else None
    got = emulate(xt, lc, lu, a_t, a_s, vocab, g)
    assert got.dtype == torch.int32 and bool(((got >= 0)
                                              & (got < vocab)).all())
    decided = _decided(lc, lu, xt, a_t, a_s, g, vocab)
    _check(got, _plain(xt, lc, lu, a_t, a_s, vocab, g), decided)
    _check(got, _pallas(xt, lc, lu, a_t, a_s, vocab, g), decided)


@pytest.mark.parametrize('V,vocab,dtype,scale,n_in', _both(
    _WIDTH_AXIS, _DTYPE_AXIS, [(3.0, '3.0'), (12.0, '12.0')]))
def test_pruned_noise_is_exact(V, vocab, dtype, scale, n_in):
    """The in-kernel noise: the tokens with the noise formed only where the
    kernel forms it equal those with it formed at every column, bit for
    bit, and the plain version's fed the same draws wherever the gap
    exceeds 1e-4."""
    (lc, lu), xt, a_t, a_s, _ = _inputs(V, vocab, DTYPES[dtype], 7 * V,
                                        scale)
    lu = lu if n_in == 2 else None
    seed = 4321 + V
    pruned = Noise(seed, B, L, V)
    got = emulate(xt, lc, lu, a_t, a_s, vocab, pruned)
    full = emulate(xt, lc, lu, a_t, a_s, vocab,
                   Noise(seed, B, L, V, prune=False))
    assert torch.equal(got, full)
    assert pruned.formed <= pruned.columns
    g = gumbel_of(philox_words(seed, B, L, V))
    _check(got, _plain(xt, lc, lu, a_t, a_s, vocab, g),
           _decided(lc, lu, xt, a_t, a_s, g, vocab))


def _main_path_inputs(V, vocab, n_in, Bt, Lt, seed):
    """Logits of scale 2 (as chip_smoke.py draws them) and the rest, bf16."""
    r = np.random.RandomState(seed)
    lc, lu = (torch.from_numpy((r.randn(Bt, Lt, V) * 2).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    xt = torch.from_numpy(r.randint(0, vocab, (Bt, Lt)).astype(np.int32))
    a_t = torch.from_numpy(r.uniform(0.05, 0.85, Bt).astype(np.float32))
    a_s = a_t + (1 - a_t) * torch.from_numpy(r.rand(Bt).astype(np.float32))
    return xt, lc, (lu if n_in == 2 else None), a_t, a_s


@pytest.mark.parametrize('V,vocab,n_in', _both(
    [((12, 12), 'species10'), ((256, 256), 'unet')]))
def test_noise_formed_for_few_columns(V, vocab, n_in):
    """At the main paths' widths, with logits of scale 2 (as
    chip_smoke.py draws them), the kernel forms the noise of fewer than
    half the logits, and the tokens are those of the noise formed
    everywhere."""
    Bt, Lt = 4, 16
    xt, lc, lu, a_t, a_s = _main_path_inputs(V, vocab, n_in, Bt, Lt, 3)
    pruned = Noise(55, Bt, Lt, V)
    got = emulate(xt, lc, lu, a_t, a_s, vocab, pruned)
    assert torch.equal(got, emulate(xt, lc, lu, a_t, a_s, vocab,
                                    Noise(55, Bt, Lt, V, prune=False)))
    assert pruned.formed < 0.5 * pruned.columns, (pruned.formed,
                                                  pruned.columns)


@pytest.mark.parametrize('V,vocab,n_in', _both(_WIDTH_AXIS))
def test_ties_go_to_the_lowest_index(V, vocab, n_in):
    """alpha(s) = 1 makes xt's numerator that of its probability: with xt's
    logit far below the rest and no noise, every other column ties and the
    lowest wins, in the emulation, the plain version and JAX's kernel."""
    for x_col, want in ((0, 1), (vocab // 2, 0)):
        z = torch.zeros((B, L, V))
        z[..., x_col] = -100.0
        zu = z if n_in == 2 else None
        xt = torch.full((B, L), x_col, dtype=torch.int32)
        a_t, a_s = torch.full((B,), 0.5), torch.ones((B,))
        g = torch.zeros_like(z)
        for tok in (emulate(xt, z, zu, a_t, a_s, vocab, g),
                    _plain(xt, z, zu, a_t, a_s, vocab, g),
                    _pallas(xt, z, zu, a_t, a_s, vocab, g)):
            assert bool((tok == want).all())


def test_plan_matches_the_source():
    """`uniform_plan` mirrors csrc `plan`: the limits (12, 16 and 32
    columns a thread, one turn of 32 lanes x kWideCols), the rows a block
    (kNarrowRows, a thread a row; a warp a row: kThreads / 32), the
    vector-load rule (V % 8, aligned rows; the narrow kernel loads
    scalars), the same for one logits tensor and two (`cfg` picks the
    kernels' kIn, not the plan)."""
    body = SRC[SRC.index('Plan plan(int vocab_size, int vec)'):]
    body = ' '.join(body[:body.index('\n}\n')].split())
    assert ('if (vocab_size <= 32) return {kNarrow, kNarrowRows, vocab_size '
            '<= 12 ? 12 : vocab_size <= 16 ? 16 : 32, 0};' in body)
    assert ('return {vocab_size <= kTurn ? kWideOne : kWideTurns, '
            'kRowsPerBlock, kWideCols, vec ? 1 : 0};' in body)
    assert 'const Plan p = plan(vocab_size, vec);' in SRC
    assert re.search(r'return cfg \? launch_noise<T, 2>\(.*: launch_noise<T, 1>\(',
                     ' '.join(SRC.split()))
    assert 'constexpr int kRowsPerBlock = kThreads / 32;' in SRC
    assert re.search(r'enum Kernel : int \{ kNarrow = 1, kWideOne = 2, '
                     r'kWideTurns = 3 \};', SRC)
    for vocab in (1, 12, 13, 16, 17, 32, 33, 256, 257, 30522):
        for V, aligned in ((vocab, True), (vocab + 8 - vocab % 8, True),
                           (vocab + 8 - vocab % 8, False)):
            got = tfs.uniform_plan(V, vocab, torch.float32, aligned)
            if vocab <= 32:
                want = dict(kernel=1, rows=NARROW_ROWS,
                            cols=next(c for c in (12, 16, 32) if vocab <= c),
                            vec=0)
            else:
                want = dict(kernel=2 if vocab <= TURN else 3,
                            rows=THREADS // 32, cols=WIDE_COLS,
                            vec=int(V % 8 == 0 and aligned))
            assert got == want, (V, vocab, aligned)
    for bad in ((10, 11, torch.float32, True),
                (12, 0, torch.float32, True),
                (12, 12, torch.float16, True)):
        with pytest.raises(ValueError):
            tfs.uniform_plan(*bad)


if __name__ == '__main__':
    # The share of the logits whose noise the kernel forms at the main
    # paths' widths, logits of scale 2, for one and two tensors:
    #   PYTHONPATH=. python3 tests/test_torch_uniform_order.py
    for n_in in N_IN:
        for V in (12, 256):
            xt, lc, lu, a_t, a_s = _main_path_inputs(V, V, n_in, 8, 64, 5)
            noise = Noise(77, 8, 64, V)
            emulate(xt, lc, lu, a_t, a_s, V, noise)
            print(f'{n_in} tensor(s), V={V}: noise formed for '
                  f'{noise.formed} of {noise.columns} logits '
                  f'({noise.formed / noise.columns:.4f})')
