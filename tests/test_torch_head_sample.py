"""The port's head-fused absorbing step (`ddg_tpu_torch.ops.fused_sampling`
K11/K12, plain versions on the CPU) against the Pallas kernels of
`ddg_tpu/ops/fused_sampling.py` (`fused_absorbing_head_sample` and its
int8 variant) in interpret mode, fed the same Gumbel noise in JAX's (B, Vp,
L) layout; the port takes the features as (B, L, D), so the JAX side gets
them transposed. Tokens are asserted equal wherever the top-two perturbed
scores of the fp32 logits differ by more than 1e-4; at these sizes that is
over 90% of the masked tokens, and in practice every one of them.

Also: the head preparations against JAX's, the sampler's head-fused step
against the unfused chain (`dit_head_matmul` + K7's plain version) under a
shared Gumbel, and the samplers' precedence (the NFE cache wins, the CPU
takes the unfused chain).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.ops import fused_sampling as jfs
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.convert import make_reference_dit_state_dict
from ddg_tpu_torch.diffusion import DiffusionSpec
from ddg_tpu_torch.models import DIT, DITConfig, make_model_apply
from ddg_tpu_torch.models.dit import dit_head_matmul
from ddg_tpu_torch.ops import fused_sampling as tfs
from ddg_tpu_torch.ops import quant as tq
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise

torch.set_num_threads(1)
B, L, D = 2, 16, 64
MARGIN = 1e-4

# (V, tile_v, mask_index): several vocab tiles with the mask in the first,
# a middle and the last tile (V off the tile multiple), and a single tile.
CASES = [(300, 128, 5), (300, 128, 200), (300, 128, 299), (100, 128, 99)]
CASE_IDS = ['mask_first_tile', 'mask_middle_tile', 'mask_last_tile',
            'one_tile']


def _inputs(V, tile_v, seed, Dm=D):
    r = np.random.RandomState(seed)
    Vp = -(-V // tile_v) * tile_v
    feats = r.randn(B, L, Dm).astype(np.float32)
    kernel = (r.randn(Dm, V) * 0.4).astype(np.float32)
    bias = (r.randn(V) * 0.5).astype(np.float32)
    x0 = r.randint(0, V, (B, L))
    xt = np.where(r.rand(B, L) < 0.7, -1, x0).astype(np.int32)
    mct = r.uniform(0.4, 0.9, B).astype(np.float32)
    mcs = (0.6 * mct).astype(np.float32)
    g = r.gumbel(size=(B, Vp, L)).astype(np.float32)
    return feats, kernel, bias, xt, mct, mcs, g


def _scores(logits, xt, mct, mcs, mask, g, V):
    s = tfs.perturbed_scores(0, logits[..., :V], torch.from_numpy(mct),
                             torch.from_numpy(mcs), mask_index=mask,
                             gumbel=torch.from_numpy(g).transpose(1, 2)
                             [..., :V])
    top2 = s.topk(2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1]) > MARGIN) & (
        torch.from_numpy(xt) == mask)


def _check_tokens(got, want, decided, xt, mask):
    want = torch.from_numpy(np.array(want))
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, L)
    masked = torch.from_numpy(xt) == mask
    assert decided.sum() > 0.9 * masked.sum()
    np.testing.assert_array_equal(got[decided].numpy(),
                                  want[decided].numpy())
    np.testing.assert_array_equal(got[~masked].numpy(), xt[xt != mask])


@pytest.mark.parametrize('V,tile_v,mask', CASES, ids=CASE_IDS)
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_head_sample_matches_pallas(V, tile_v, mask, dtype):
    feats, kernel, bias, xt, mct, mcs, g = _inputs(V, tile_v, V + mask)
    xt = np.where(xt < 0, mask, xt).astype(np.int32)
    jdt = jnp.float32 if dtype == 'f32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    jw, jb = jfs.pad_head_weights(jnp.asarray(kernel).astype(jdt),
                                  jnp.asarray(bias), tile_v=tile_v)
    want = jfs.fused_absorbing_head_sample(
        3, jnp.asarray(xt), jnp.swapaxes(jnp.asarray(feats), 1, 2).astype(jdt),
        jw, jb, jnp.asarray(mct), jnp.asarray(mcs), vocab_size=V,
        mask_index=mask, tile_v=tile_v, interpret=True,
        gumbel_t=jnp.asarray(g))
    tf = torch.from_numpy(feats).to(tdt)
    w_t, bias_col = tfs.pad_head_weights(
        torch.from_numpy(kernel.T.copy()).to(tdt), torch.from_numpy(bias),
        tile_v=tile_v)
    got = tfs.fused_absorbing_head_sample(
        3, torch.from_numpy(xt), tf, w_t, bias_col, torch.from_numpy(mct),
        torch.from_numpy(mcs), vocab_size=V, mask_index=mask, tile_v=tile_v,
        gumbel_t=torch.from_numpy(g))
    decided = _scores(tfs.head_logits(tf, w_t, bias_col), xt, mct, mcs,
                      mask, g, V)
    _check_tokens(got, want, decided, xt, mask)


@pytest.mark.parametrize('V,tile_v,mask', CASES, ids=CASE_IDS)
def test_head_sample_int8_matches_pallas(V, tile_v, mask):
    feats, kernel, bias, xt, mct, mcs, g = _inputs(V, tile_v, 7 * V + mask)
    xt = np.where(xt < 0, mask, xt).astype(np.int32)
    jwq, jws, jb = jfs.quantize_head_weights(
        jnp.asarray(kernel), jnp.asarray(bias), tile_v=tile_v)
    jfq, jxs = jfs.quantize_head_inputs(jnp.asarray(feats))
    want = jfs.fused_absorbing_head_sample_int8(
        3, jnp.asarray(xt), jfq, jxs, jwq, jws, jb, jnp.asarray(mct),
        jnp.asarray(mcs), vocab_size=V, mask_index=mask, tile_v=tile_v,
        interpret=True, gumbel_t=jnp.asarray(g))
    w_q, w_scale, bias_col = tfs.quantize_head_weights(
        torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias),
        tile_v=tile_v)
    fq, xs = tfs.quantize_head_inputs(torch.from_numpy(feats))
    got = tfs.fused_absorbing_head_sample_int8(
        3, torch.from_numpy(xt), fq, xs, w_q, w_scale, bias_col,
        torch.from_numpy(mct), torch.from_numpy(mcs), vocab_size=V,
        mask_index=mask, tile_v=tile_v, gumbel_t=torch.from_numpy(g))
    logits = tfs.head_logits_int8(fq, xs, w_q, w_scale, bias_col)
    # The plain version's logits are the unfused int8 head's, bit for bit.
    np.testing.assert_array_equal(
        logits[..., :V].numpy(),
        tq.int8_dense(torch.from_numpy(feats), torch.from_numpy(kernel),
                      torch.from_numpy(bias)).numpy())
    _check_tokens(got, want, _scores(logits, xt, mct, mcs, mask, g, V), xt,
                  mask)


@pytest.mark.parametrize('V,mask', [(1000, 500), (1000, 999), (643, 0)],
                         ids=['mask_mid', 'mask_last', 'mask_first'])
def test_head_sample_int8_matches_pallas_at_kernel_k(V, mask):
    """K12's plain version against JAX's at D = 128 (one K tile of the int8
    wgmma kernel) and a V that is no multiple of 128, one external Gumbel
    for both."""
    Dm = 128
    feats, kernel, bias, xt, mct, mcs, g = _inputs(V, 128, 11 * V + mask, Dm)
    xt = np.where(xt < 0, mask, xt).astype(np.int32)
    jwq, jws, jb = jfs.quantize_head_weights(
        jnp.asarray(kernel), jnp.asarray(bias), tile_v=128)
    jfq, jxs = jfs.quantize_head_inputs(jnp.asarray(feats))
    want = jfs.fused_absorbing_head_sample_int8(
        3, jnp.asarray(xt), jfq, jxs, jwq, jws, jb, jnp.asarray(mct),
        jnp.asarray(mcs), vocab_size=V, mask_index=mask, tile_v=128,
        interpret=True, gumbel_t=jnp.asarray(g))
    w_q, w_scale, bias_col = tfs.quantize_head_weights(
        torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias),
        tile_v=128)
    fq, xs = tfs.quantize_head_inputs(torch.from_numpy(feats))
    got = tfs.fused_absorbing_head_sample_int8(
        3, torch.from_numpy(xt), fq, xs, w_q, w_scale, bias_col,
        torch.from_numpy(mct), torch.from_numpy(mcs), vocab_size=V,
        mask_index=mask, tile_v=128, gumbel_t=torch.from_numpy(g))
    logits = tfs.head_logits_int8(fq, xs, w_q, w_scale, bias_col)
    _check_tokens(got, want, _scores(logits, xt, mct, mcs, mask, g, V), xt,
                  mask)


HEAD_SRC = (Path(__file__).resolve().parents[1] / 'ddg_tpu_torch' / 'csrc'
            / 'head_sample.cu').read_text()


def _s8_source():
    """The int8 kernel's namespace of `head_sample.cu` and its integer
    constants (the derived ones computed from the source's expressions,
    each of which is asserted)."""
    body = HEAD_SRC[HEAD_SRC.index('namespace s8 {'):
                    HEAD_SRC.index('}  // namespace s8')]
    c = {name: int(value) for name, value in re.findall(
        r'constexpr int (k\w+) = (\d+);', body)}
    for text in ('constexpr int kEpiThreads = 32 * kEpiWarps;',
                 'constexpr int kSplitChunks = kSplitRows / kVt;',
                 'constexpr int kHt = kTok * kVt / (kRows * kEpiThreads);',
                 'constexpr int kTpw = 32 * kRows / kVt;',
                 'constexpr int kTileBytes = kTok * kK;',
                 'constexpr int kStageBytes = kVt * kK;',
                 'constexpr int kZRow = kVt + 4;'):
        assert text in body, text
    c.update(kEpiThreads=32 * c['kEpiWarps'],
             kSplitChunks=c['kSplitRows'] // c['kVt'], kZRow=c['kVt'] + 4,
             kTpw=32 * c['kRows'] // c['kVt'])
    c['kHt'] = c['kTok'] * c['kVt'] // (c['kRows'] * c['kEpiThreads'])
    return body, c


@pytest.mark.parametrize('D', [64, 128, 768, 784, 896, 1024, 1040, 1280,
                               1296, 1536, 4096])
def test_int8_head_plan_matches_the_source(D):
    """`head_plan` for int8 against the int8 kernel's constants read from
    `head_sample.cu` (s8: tokens a block, chunk and split, W slots, shared
    memory, `smem_bytes` recomputed here): path 1 where D is a multiple of
    16 and the feature tiles leave room for kMinStages W slots (one more
    than the products in flight), else path 0 with no splits
    (`head_splits` sets them). The LM1B slice takes path 1."""
    body, c = _s8_source()
    assert ('return kAlign + nk * kTileBytes + stages * kStageBytes + '
            'kTok * kZRow * 4 +' in ' '.join(body.split()))
    assert (tfs._S8_TOKENS, tfs._S8_CHUNK, tfs._S8_SPLIT_CHUNKS, tfs._S8_K,
            tfs._S8_MIN_STAGES) == (c['kTok'], c['kVt'], c['kSplitChunks'],
                                    c['kK'], c['kMinStages'])

    def smem(nk, stages):
        return (c['kAlign'] + nk * c['kTok'] * c['kK']
                + stages * c['kVt'] * c['kK']
                + c['kTok'] * c['kZRow'] * 4 + 8 * (2 * stages + 3))
    nk = -(-D // c['kK'])
    stages = c['kMaxStages']
    while stages > 0 and smem(nk, stages) > c['kSmemMax']:
        stages -= 1
    for n_tok, Vp in ((3072, 30720), (40, 2944), (7, 128)):
        got = tfs.head_plan(n_tok, D, Vp, torch.int8)
        if D % 16 == 0 and stages >= c['kMinStages']:
            rows = c['kSplitChunks'] * c['kVt']
            assert got == dict(path=1, tokens=c['kTok'], chunk=c['kVt'],
                               split_chunks=c['kSplitChunks'],
                               splits=-(-Vp // rows), stages=stages,
                               smem=smem(nk, stages))
            assert got['smem'] <= c['kSmemMax']
        else:
            assert got == dict(path=0, tokens=0, chunk=0, split_chunks=0,
                               splits=0, stages=0, smem=0)
    assert tfs.head_plan(3072, 768, 30720, torch.int8)['path'] == 1


def test_int8_epilogue_rescale_is_int8_dense():
    """The int8 kernel's logits, emulated on the CPU from its layout: the
    product warpgroup's s32 sums (thread (warp w, lane 4 g + t) holds token
    rows 16 w + g + 8 h and vocab rows 8 j + 2 t + e at 4 j + 2 h + e, the
    wgmma m64n128 layout) written to the block's s32 tile; each epilogue
    thread (warp w, lane kTpw q + r) reading token rows kTpw w + r + kTpw
    kEpiWarps h (h < kHt) and vocab rows kRows q .. kRows q + kRows - 1 and
    rescaling them in the source's order, (float(acc) * xs) * ws + bias
    with each step rounded. Bit-equal to `head_logits_int8` (so to
    `ops.quant.int8_dense`) over a block of kTok tokens and one chunk,
    every cell written and read once."""
    body, c = _s8_source()
    flat = ' '.join(body.split())
    assert ('z[4 * k + e] = __fadd_rn( __fmul_rn(__fmul_rn(static_cast<float>('
            'acc[4 * k + e]), xs), wv[e]), bv[e]);' in flat)
    for text in ('const int r0 = 16 * warp + g;',
                 '*reinterpret_cast<int2*>(zt + (r0 + 8 * h) * kZRow + 8 * j + '
                 '2 * t) = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + '
                 '1]);',
                 'const int row0 = kTpw * (e >> 5) + lane % kTpw;',
                 'const int row = row0 + kTpw * kEpiWarps * h;',
                 'const int v0 = vrow(i) + kRows * q;'):
        assert ' '.join(text.split()) in flat, text
    T, Vt, R, tpw = c['kTok'], c['kVt'], c['kRows'], c['kTpw']
    r = np.random.RandomState(8)
    Dm = 2 * c['kK']
    feats = torch.from_numpy(r.randn(1, T, Dm).astype(np.float32) * 3)
    weight = torch.from_numpy(r.randn(Vt, Dm).astype(np.float32) * 0.05)
    bias = torch.from_numpy(r.randn(Vt).astype(np.float32))
    w_q, w_scale, bias_col = tfs.quantize_head_weights(weight, bias,
                                                       tile_v=Vt)
    fq, xs = tfs.quantize_head_inputs(feats)
    want = tfs.head_logits_int8(fq, xs, w_q, w_scale, bias_col)[0]
    acc = tq.int8_matmul(fq[0], w_q)                       # (T, Vt) s32
    tile = torch.full((T, c['kZRow']), -(2 ** 31), dtype=torch.int32)
    written = torch.zeros((T, Vt), dtype=torch.int32)
    assert c['kProdThreads'] == 128 and T == 64
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(Vt // 8):
                for q in range(4):
                    row = 16 * w + g + 8 * (q >> 1)
                    col = 8 * j + 2 * t + (q & 1)
                    tile[row, col] = acc[row, col]
                    written[row, col] += 1
    assert bool((written == 1).all())
    got = torch.full((T, Vt), float('nan'))
    seen = torch.zeros((T, Vt), dtype=torch.int32)
    for w in range(c['kEpiWarps']):
        for lane in range(32):
            q, row0 = lane // tpw, tpw * w + lane % tpw
            for h in range(c['kHt']):
                row = row0 + tpw * c['kEpiWarps'] * h
                cols = slice(R * q, R * q + R)
                a = tile[row, cols].float()
                got[row, cols] = (a * xs[0, row, 0]) * w_scale[cols, 0] \
                    + bias_col[cols, 0]
                seen[row, cols] += 1
    assert bool((seen == 1).all())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_head_preparations_match_jax():
    feats, kernel, bias, *_ = _inputs(300, 128, 0)
    weight = torch.from_numpy(kernel.T.copy())
    tb = torch.from_numpy(bias)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        w_t, bias_col = tfs.pad_head_weights(weight.to(dt), tb, tile_v=128)
        jw, jb = jfs.pad_head_weights(jnp.asarray(kernel).astype(jdt),
                                      jnp.asarray(bias), tile_v=128)
        assert w_t.dtype == dt and tuple(w_t.shape) == (384, D)
        np.testing.assert_array_equal(w_t.float().numpy(),
                                      np.asarray(jw.astype(jnp.float32)))
        np.testing.assert_array_equal(bias_col.numpy(), np.asarray(jb))
    got = tfs.quantize_head_weights(weight, tb, tile_v=128)
    want = jfs.quantize_head_weights(jnp.asarray(kernel), jnp.asarray(bias),
                                     tile_v=128)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fq, xs = tfs.quantize_head_inputs(torch.from_numpy(feats))
    jfq, jxs = jfs.quantize_head_inputs(jnp.asarray(feats))
    np.testing.assert_array_equal(fq.transpose(1, 2).numpy(),
                                  np.asarray(jfq))
    np.testing.assert_array_equal(xs.transpose(1, 2).numpy(),
                                  np.asarray(jxs))


def test_head_splits_fill_the_card():
    """The bf16 head kernel's plan at the LM1B slice (3072 tokens, D = 768,
    Vp = 30720), from the shape alone (`head_plan` takes no SM count): 48
    token tiles of 64 times 30 vocab splits of 8 chunks of 128 rows, 1440
    blocks (more than 10 a multiprocessor on a 132-multiprocessor card),
    each split whole and none empty; 6 W slots beside the 12 feature tiles
    and the logits tile, within the card's shared memory; D up to 1280 (2
    slots); a Vp off 1024 rows leaves a last split of what is left; past
    D = 1280 the bf16 head takes the first kernel in the same splits.
    The int8 head takes its own wgmma kernel at the slice (path 1; its
    plan is held by `test_int8_head_plan_matches_the_source`). The fp32
    head keeps the first kernel, whose splits follow the card
    (`head_splits`: 24 token tiles x 11 splits at 132 multiprocessors,
    every split a whole number of 128-row chunks and none empty)."""
    import inspect
    assert list(inspect.signature(tfs.head_plan).parameters) == [
        'n_tokens', 'D', 'Vp', 'dtype']
    p = tfs.head_plan(3072, 768, 30720, torch.bfloat16)
    assert p == dict(path=1, tokens=64, chunk=128, split_chunks=8,
                     splits=30, stages=6,
                     smem=1024 + 12 * 8192 + 6 * 16384 + 64 * 132 * 4
                     + 8 * 15)
    assert -(-3072 // p['tokens']) * p['splits'] == 1440 > 10 * 132
    assert p['splits'] * p['split_chunks'] * p['chunk'] == 30720
    assert p['smem'] <= 232448
    for n_tok, D, Vp, stages in ((64, 768, 2048, 6), (3072, 1280, 30720, 2),
                                 (100, 128, 1024, 8), (7, 1024, 4096, 4),
                                 (3072, 768, 30720 + 128, 6),
                                 (40, 768, 2944, 6)):
        q = tfs.head_plan(n_tok, D, Vp, torch.bfloat16)
        assert (q['path'], q['stages'], q['splits']) == (1, stages,
                                                          -(-Vp // 1024))
        assert q['smem'] <= 232448
    q = tfs.head_plan(3072, 1344, 30720, torch.bfloat16)
    assert (q['path'], q['split_chunks'], q['splits']) == (0, 8, 30)
    assert tfs.head_plan(3072, 768, 30720, torch.float32) == dict(
        path=0, tokens=0, chunk=0, split_chunks=0, splits=0, stages=0,
        smem=0)
    assert tfs.head_plan(3072, 768, 30720, torch.int8)['path'] == 1
    assert tfs.head_splits(3072, 30720, 132) == 11
    for n_tok, Vp in ((64, 384), (3072, 30720), (4, 128), (40000, 256)):
        s = tfs.head_splits(n_tok, Vp, 132)
        chunks = Vp // tfs.HEAD_CHUNK
        per = -(-chunks // s)
        assert 1 <= s <= chunks and (s - 1) * per < chunks


@pytest.mark.parametrize('n_tok,D,Vp', [
    (3072, 768, 30720), (3072, 768, 30848), (40, 768, 2944), (7, 64, 128),
    (64, 1280, 9088), (3072, 1344, 30720), (5, 1600, 4224),
    (3072, 4096, 128 * 73)])
def test_bf16_head_splits_follow_the_shape(n_tok, D, Vp):
    """On either path the bf16 head's vocab splits are 1024 rows, the last
    split 1 to 8 chunks of 128, so a token's merge order follows its
    shape only. On path 0 the first kernel derives its chunks a split as
    ceil(chunks / splits) and refuses a split count that this does not
    give back; 8 chunks a split always gives it back."""
    q = tfs.head_plan(n_tok, D, Vp, torch.bfloat16)
    chunks = Vp // tfs.HEAD_CHUNK
    assert q['path'] == (1 if D <= 1280 else 0)
    assert q['split_chunks'] == 8 and q['splits'] == -(-chunks // 8)
    assert 1 <= chunks - 8 * (q['splits'] - 1) <= 8
    per = -(-chunks // q['splits'])
    assert -(-chunks // per) == q['splits']


# ---------------------------------------------------------------------------
# The sampler's head-fused step
# ---------------------------------------------------------------------------

TV, TH = 203, 128


def _dit(int8, logits_dtype):
    cfg = DITConfig(hidden_size=TH, cond_dim=32, length=L, n_blocks=1,
                    n_heads=2, vocab_size=TV, num_classes=2,
                    compute_dtype=torch.float32, logits_dtype=logits_dtype,
                    quant_int8=int8)
    sd = make_reference_dit_state_dict(np.random.RandomState(4), hidden=TH,
                                       cond_dim=32, n_blocks=1, vocab=TV,
                                       with_cond=True)
    sd['output_layer.linear.weight'] *= 20.0
    m = DIT(cfg)
    m.load_state_dict(sd, strict=True)
    apply = make_model_apply(m.eval())
    spec = DiffusionSpec(diffusion='absorbing_state',
                         parameterization='subs', noise=LogLinearNoise(),
                         vocab_size=TV, mask_index=TV - 1, num_classes=2)
    return spec, cfg, apply


@pytest.mark.parametrize('int8', [False, True], ids=['bf16_or_f32', 'int8'])
@pytest.mark.parametrize('logits_dtype', [torch.float32, torch.bfloat16],
                         ids=['f32_head', 'bf16_head'])
def test_head_fused_step_matches_unfused_chain(int8, logits_dtype,
                                               monkeypatch):
    """`samplers._head_fused_sample` (K11 or K12, plain here) against the
    feature-mix path's unfused chain, `dit_head_matmul` then K7's plain
    version, under one Gumbel draw. The chain rounds the logits to
    `logits_dtype` (and, without int8, the bias too), so a bf16 head's
    tokens are compared where the top-two gap also exceeds two bf16 ulps
    of the largest logit; an fp32 head's under the 1e-4 margin alone (the
    int8 logits are bit-equal there)."""
    spec, cfg, apply = _dit(int8, logits_dtype)
    params = apply.params
    r = np.random.RandomState(5)
    feats = torch.from_numpy(r.randn(B, L, TH).astype(np.float32))
    xt = torch.from_numpy(np.where(r.rand(B, L) < 0.8, TV - 1,
                                   r.randint(0, TV - 1, (B, L)))
                          .astype(np.int32))
    mct = torch.from_numpy(r.uniform(0.5, 0.9, (B, 1, 1)).astype(np.float32))
    mcs = 0.5 * mct
    head = TS._prepare_head(cfg, params)
    Vp = head[0].shape[0]
    g = torch.from_numpy(r.gumbel(size=(B, Vp, L)).astype(np.float32))
    calls = []

    def with_noise(fn):
        def call(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, gumbel_t=g, **kw)
        return call
    for name in ('fused_absorbing_head_sample',
                 'fused_absorbing_head_sample_int8'):
        monkeypatch.setattr(TS, name, with_noise(getattr(tfs, name)))
    with torch.no_grad():
        got = TS._head_fused_sample(spec, cfg, head, 9, xt, feats, mct, mcs)
        logits = dit_head_matmul(cfg, params, feats)
    assert calls == ['fused_absorbing_head_sample_int8' if int8
                     else 'fused_absorbing_head_sample']
    gl = g.transpose(1, 2)[..., :TV]
    want = tfs.fused_absorbing_sample_plain(9, xt, logits, mct[:, 0, 0],
                                            mcs[:, 0, 0],
                                            mask_index=TV - 1, gumbel=gl)
    scores = tfs.perturbed_scores(9, logits.float(), mct[:, 0, 0],
                                  mcs[:, 0, 0], mask_index=TV - 1, gumbel=gl)
    margin = MARGIN
    if logits_dtype == torch.bfloat16:
        top = logits.float().abs().max().item()
        margin += 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
    top2 = scores.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > margin) & (xt == TV - 1)
    assert decided.sum() > 0.5 * (xt == TV - 1).sum()
    np.testing.assert_array_equal(got[decided].numpy(),
                                  want[decided].numpy())
    np.testing.assert_array_equal(got[xt != TV - 1].numpy(),
                                  xt[xt != TV - 1].numpy())


def _sample(spec, cfg, apply, sampler, guidance, seed=3):
    gen = torch.Generator().manual_seed(seed)
    cond = None if guidance is None else torch.tensor([0, 1, 0, 1],
                                                      dtype=torch.int32)
    return TS.diffusion_sample(spec, sampler, apply, apply.params, gen,
                               batch_size=4, length=L, guidance=guidance,
                               cond=cond, dit_cfg=cfg)


@pytest.mark.parametrize('int8', [False, True], ids=['bf16', 'int8'])
def test_sampler_head_fused_path_cpu_fallback(int8):
    """On the CPU `_fused_ok` is false, so `fused_head=True` takes the
    unfused chain and draws exactly what `fused_head=False` draws (the JAX
    package's test of the same name)."""
    spec, cfg, apply = _dit(int8, torch.bfloat16)
    guide = TS.GuidanceSpec(method='cfg', gamma=2.0)
    a = _sample(spec, cfg, apply, TS.SamplerSpec(
        steps=4, use_cache=False, fused=True, fused_head=True), guide)
    b = _sample(spec, cfg, apply, TS.SamplerSpec(
        steps=4, use_cache=False, fused=True, fused_head=False), guide)
    assert torch.equal(a, b)


@pytest.mark.parametrize('guided', [False, True], ids=['unguided', 'dcfg'])
@pytest.mark.parametrize('int8', [False, True], ids=['bf16', 'int8'])
def test_sampler_head_fused_precedence(int8, guided, monkeypatch):
    """With the fused steps forced on (plain kernel versions), the
    head-fused kernel serves every step of the unguided and the D-CFG
    feature-mix samplers, once a step and never K7; with the NFE cache on
    it serves none (the cache's route wins, as in `ddg_tpu`). The head
    weights are prepared once a sampling call."""
    monkeypatch.setattr(TS, '_fused_ok',
                        lambda spec, sampler, guidance, xt: sampler.fused)
    spec, cfg, apply = _dit(int8, torch.bfloat16)
    counts = {'head': 0, 'k7': 0, 'k8': 0, 'prep': 0}

    def counted(key, fn):
        def call(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return call
    head_fn = ('fused_absorbing_head_sample_int8' if int8
               else 'fused_absorbing_head_sample')
    monkeypatch.setattr(TS, head_fn, counted('head', getattr(TS, head_fn)))
    monkeypatch.setattr(TS, 'fused_absorbing_sample',
                        counted('k7', TS.fused_absorbing_sample))
    monkeypatch.setattr(TS, 'fused_absorbing_cfg_sample',
                        counted('k8', TS.fused_absorbing_cfg_sample))
    monkeypatch.setattr(TS, '_prepare_head',
                        counted('prep', TS._prepare_head))
    guide = TS.GuidanceSpec(method='cfg', gamma=2.0) if guided else None
    x = _sample(spec, cfg, apply, TS.SamplerSpec(
        steps=5, use_cache=False, fused=True, fused_head=True), guide)
    assert counts == {'head': 5, 'k7': 0, 'k8': 0, 'prep': 1}
    assert x.dtype == torch.int32 and tuple(x.shape) == (4, L)
    assert bool(((x >= 0) & (x < TV)).all())
    counts.update(head=0, k7=0, k8=0, prep=0)
    _sample(spec, cfg, apply, TS.SamplerSpec(
        steps=5, use_cache=True, fused=True, fused_head=True), guide)
    assert counts['head'] == 0 and counts['prep'] == 0
    assert counts['k8' if guided else 'k7'] >= 1
