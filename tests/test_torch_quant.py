"""The port's int8 dynamic quantization (`ddg_tpu_torch.ops.quant`) and
int8 DiT (`DITConfig.quant_int8`) against `ddg_tpu.ops.quant` and the JAX
`quant_int8=True` DiT, on the same numpy inputs and weights.

Codes, scales and the int32 products are compared for equality (exact .5
ties and a zero row included). The fp32 outputs of `int8_dense` are
compared for equality too: XLA on the CPU forms (acc * x_scale) * w_scale
+ bias as separate roundings, as PyTorch does (no FMA contraction was
found); bf16 outputs to one bf16 ulp (the cast of equal fp32 values; the
bar leaves room for a contraction in another XLA build).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.models import dit as jdit
from ddg_tpu.ops import quant as jq
from ddg_tpu_torch import convert as tconvert
from ddg_tpu_torch.models import DIT, DITConfig
from ddg_tpu_torch.ops import quant as tq

torch.set_num_threads(1)


def _activations(seed, shape=(3, 5, 40)):
    """Random rows, one row of exact ties (absmax 127 gives scale 1, so
    x.5 values sit on a rounding tie) and one zero row."""
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 2).astype(np.float32)
    tie = np.zeros(shape[-1], np.float32)
    tie[:8] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    rows = x.reshape(-1, shape[-1])
    rows[0] = tie
    rows[7] = 0.0
    return x


def test_quantize_rowwise_matches_jax():
    x = _activations(0)
    jcode, jscale = jq.quantize_rowwise(jnp.asarray(x))
    code, scale = tq.quantize_rowwise(torch.from_numpy(x))
    assert code.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    # Half to even on the tie row; the zero row gets scale 1 / 127.
    np.testing.assert_array_equal(code[0, 0, :8].numpy(),
                                  [127, 2, -4, 0, 0, 2, 126, -126])
    assert scale[1, 2, 0].item() == np.float32(1.0) / np.float32(127.0)
    assert not code[1, 2].any()     # row 7, zeroed


def test_quantize_colwise_matches_jax():
    w = _activations(1, (40, 24))
    w[:, 3] = 0.0
    w[:8, 5] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    w[8:, 5] = 0.25
    jcode, jscale = jq.quantize_colwise(jnp.asarray(w))
    code, scale = tq.quantize_colwise(torch.from_numpy(w))
    assert tuple(scale.shape) == (24,)
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize('M,K,N', [(15, 40, 24), (64, 96, 40),
                                   (7, 13, 5)])
def test_int8_matmul_pads_exactly(M, K, N):
    """Zero padding to what `torch._int_mm` takes leaves the int32 sums
    exact, for M <= 16 and K, N off the multiple of 8."""
    r = np.random.RandomState(M)
    a = r.randint(-127, 128, (M, K)).astype(np.int8)
    b = r.randint(-127, 128, (N, K)).astype(np.int8)
    got = tq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.T.astype(np.int64))


@pytest.mark.parametrize('use_bias', [True, False], ids=['bias', 'nobias'])
def test_int8_dense_matches_jax(use_bias):
    x = _activations(2, (4, 16, 64))
    r = np.random.RandomState(3)
    kernel = (r.randn(64, 40) * 0.3).astype(np.float32)
    bias = (r.randn(40) * 0.5).astype(np.float32) if use_bias else None
    # The int32 products.
    jxq, _ = jq.quantize_rowwise(jnp.asarray(x))
    jwq, _ = jq.quantize_colwise(jnp.asarray(kernel))
    jacc = jax.lax.dot_general(jxq, jwq, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    xq, _ = tq.quantize_rowwise(torch.from_numpy(x))
    wq, _ = tq.quantize_colwise(torch.from_numpy(kernel))
    acc = tq.int8_matmul(xq.reshape(-1, 64), wq.t()).reshape(4, 16, 40)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    # fp32 outputs: equal (separate roundings on both sides).
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(kernel), jb))
    got = tq.int8_dense(torch.from_numpy(x), torch.from_numpy(kernel), tb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # bf16 outputs: within one bf16 ulp.
    want16 = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(kernel),
                                      jb, out_dtype=jnp.bfloat16)
                        .astype(jnp.float32))
    got16 = tq.int8_dense(torch.from_numpy(x), torch.from_numpy(kernel), tb,
                          out_dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want16), 1e-30))) - 7)
    assert np.all(np.abs(got16.float().numpy() - want16) <= ulp)


@pytest.mark.parametrize('n_in,n_out', [(32, 24), (13, 5)])
def test_qlinear_is_a_drop_in_for_linear(n_in, n_out):
    """Same parameters and state-dict keys as nn.Linear; the output is
    int8_dense of the transposed weight (also where the cached codes are
    padded to multiples of 8); the weight's quantization is kept until the
    weight changes."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(n_in, n_out)
    q = tq.QLinear(n_in, n_out)
    assert list(q.state_dict()) == list(lin.state_dict())
    q.load_state_dict(lin.state_dict(), strict=True)
    x = torch.randn(3, 7, n_in)
    with torch.no_grad():
        want = tq.int8_dense(x, lin.weight.t(), lin.bias)
        got = q(x)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        codes = tq.quantized_weight(q.weight)[0]
        assert tq.quantized_weight(q.weight)[0] is codes     # reused
        q.weight.mul_(2.0)                                   # in place
        assert tq.quantized_weight(q.weight)[0] is not codes
        np.testing.assert_array_equal(
            q(x).numpy(), tq.int8_dense(x, q.weight.t(), q.bias).numpy())


# ---------------------------------------------------------------------------
# The int8 DiT against JAX's
# ---------------------------------------------------------------------------

HID, COND, NB, NH, L, V, NC = 128, 32, 2, 2, 16, 37, 2


def _jax_cfg():
    return jdit.DITConfig(hidden_size=HID, cond_dim=COND, length=L,
                          n_blocks=NB, n_heads=NH, dropout=0.0, vocab_size=V,
                          num_classes=NC, compute_dtype=jnp.float32,
                          quant_int8=True)


def _torch_cfg(**kw):
    kw = dict(dict(compute_dtype=torch.float32, quant_int8=True), **kw)
    return DITConfig(hidden_size=HID, cond_dim=COND, length=L, n_blocks=NB,
                     n_heads=NH, vocab_size=V, num_classes=NC, **kw)


@pytest.fixture(scope='module')
def int8_weights():
    """A JAX quant_int8=True DiT's params (the nn.Dense tree), perturbed by
    seeded noise so that the zero-initialised adaLN and head move."""
    params = jdit.DIT(_jax_cfg()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, L), jnp.int32), jnp.ones((1,)),
        jnp.zeros((1,), jnp.int32))['params']
    r = np.random.RandomState(1)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * r.randn(*p.shape).astype(np.float32),
        params)


def _int8_model(weights, **kw):
    m = DIT(_torch_cfg(**kw))
    m.load_state_dict(tconvert.dit_state_dict_from_jax(weights, n_blocks=NB),
                      strict=True)
    return m.eval()


def test_int8_dit_loads_the_jax_int8_tree(int8_weights):
    """The int8 DiT's parameter tree is the float one's: the converter
    carries a JAX quant_int8 DiT across and it loads strictly, into
    QLinear layers where JAX has QDense."""
    m = _int8_model(int8_weights)
    blk = m.blocks[0]
    for lin in (blk.attn_qkv, blk.attn_out, blk.mlp[0], blk.mlp[2],
                m.output_layer.linear):
        assert isinstance(lin, tq.QLinear)
    assert not isinstance(blk.adaLN_modulation, tq.QLinear)
    float_model = DIT(DITConfig(hidden_size=HID, cond_dim=COND, length=L,
                                n_blocks=NB, n_heads=NH, vocab_size=V,
                                num_classes=NC))
    assert list(m.state_dict()) == list(float_model.state_dict())


BF16 = dict(compute_dtype=torch.bfloat16, logits_dtype=torch.bfloat16)


def test_int8_codes_under_bf16_compute_are_jax_codes(int8_weights):
    """Under bf16 compute and a bf16 head, every int8 layer quantizes the
    float32 parameter, as `QDense` does (its kernel is a float32 flax
    param, `compute_dtype` sets only its output dtype): the codes and
    scales of each trunk product and of the head, the cached ones
    (`quantized_weight`) and K12's prepared ones (`quantize_head_weights`
    through the sampler's `_prepare_head`), equal JAX's
    `quantize_colwise(kernel)` of the float32 kernel exactly, and the bias
    is JAX's float32 bias. A layer's output is `int8_dense` on the float32
    kernel and bias, cast to the layer's output dtype."""
    from ddg_tpu_torch import samplers as TS
    sd = tconvert.dit_state_dict_from_jax(int8_weights, n_blocks=NB)
    m = _int8_model(int8_weights, **BF16)
    layers = {n: mod for n, mod in m.named_modules()
              if isinstance(mod, tq.QLinear)}
    assert len(layers) == 4 * NB + 1
    x = torch.from_numpy(_activations(4, (3, 5, HID)))
    for name, mod in layers.items():
        kernel = sd[name + '.weight'].numpy().T
        jcode, jscale = jq.quantize_colwise(jnp.asarray(kernel))
        code, scale = tq.quantized_weight(mod.weight)
        N, K = mod.weight.shape
        np.testing.assert_array_equal(code[:N, :K].numpy().T,
                                      np.asarray(jcode), err_msg=name)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale),
                                      err_msg=name)
        out_dtype = (torch.bfloat16 if name == 'output_layer.linear'
                     else m.cfg.compute_dtype)
        if K == HID:
            bias = sd.get(name + '.bias')
            with torch.no_grad():
                got = mod(x)
            want = tq.int8_dense(x, torch.from_numpy(kernel), bias,
                                 out_dtype=out_dtype)
            assert got.dtype == out_dtype, name
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.float().numpy(), err_msg=name)
    with torch.no_grad():
        w_q, w_scale, bias_col = TS._prepare_head(
            m.cfg, dict(m.named_parameters()))
    jcode, jscale = jq.quantize_colwise(jnp.asarray(
        int8_weights['output_linear']['kernel']))
    np.testing.assert_array_equal(w_q[:V].numpy().T, np.asarray(jcode))
    np.testing.assert_array_equal(w_scale[:V, 0].numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        bias_col[:V, 0].numpy(), int8_weights['output_linear']['bias'])


def test_int8_dit_bf16_logits_match_jax(int8_weights):
    """bf16 compute and a bf16 head on both sides (JAX's `quant_int8` DiT
    with `compute_dtype=logits_dtype=bf16`), fused flags off. The two
    sides sum the bf16 trunk (LayerNorm, attention, GELU) in different
    orders, so the hidden states differ by bf16 ulps, and the head
    features, whose bf16 error is about a code step, quantize to other
    codes at about half of their positions (the count is recorded, not
    bounded). Given the features' codes and scales, the int8 head is
    exact, so each logit is held to what those differences can move it:
    the float32 test's code-flip term taken per logit, sum over the
    flipped codes of |code step| x |W code| x x_scale x w_scale, plus
    |JAX's int32 sum| x |x_scale difference| x w_scale (the bf16 trunk's
    rounding seen through the row scale), times (1 + 1e-5) for the fp32
    rescale, plus one bf16 ulp of the output (each side rounds once)."""
    from ddg_tpu_torch.models.dit import dit_head_features
    cfg = dataclasses.replace(_jax_cfg(), compute_dtype=jnp.bfloat16,
                              logits_dtype=jnp.bfloat16)
    r = np.random.RandomState(2)
    x = r.randint(0, V, (3, L)).astype(np.int32)
    sigma = r.uniform(0, 2, 3).astype(np.float32)
    cond = np.array([0, 1, NC], np.int32)
    args = (jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(cond))
    model = jdit.DIT(cfg)
    want = np.asarray(jax.jit(model.apply)({'params': int8_weights}, *args)
                      .astype(jnp.float32))
    jh, jc = jax.jit(lambda p, *a: model.apply({'params': p}, *a,
                                               skip_head=True))(
        int8_weights, *args)
    jfeats = jdit.dit_head_features(cfg, int8_weights, jh, jc)
    m = _int8_model(int8_weights, **BF16)
    params = dict(m.named_parameters())
    targs = (torch.from_numpy(x), torch.from_numpy(sigma),
             torch.from_numpy(cond))
    with torch.no_grad():
        got = m(*targs)
        th, tc = m(*targs, skip_head=True)
        feats = dit_head_features(m.cfg, params, th, tc)
    assert got.dtype == torch.bfloat16 and np.abs(want).max() > 0.1
    jcode, jscale = (np.asarray(a) for a in jq.quantize_rowwise(jfeats))
    code, scale = (a.numpy() for a in tq.quantize_rowwise(feats))
    wq, ws = (np.asarray(a) for a in jq.quantize_colwise(
        jnp.asarray(int8_weights['output_linear']['kernel'])))
    step = np.abs(code.astype(np.int64) - jcode) @ np.abs(wq.astype(np.int64))
    acc = jcode.astype(np.int64) @ wq.astype(np.int64)
    got = got.float().numpy()
    out = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(out, 1e-30))) - 7)
    bar = ((step * scale + np.abs(acc) * np.abs(scale - jscale)) * ws
           * (1 + 1e-5) + ulp)
    assert np.all(np.abs(got - want) <= bar)


@pytest.mark.parametrize('flags', [
    dict(), dict(fused_adaln=True, fused_rope_attn=True)],
    ids=['unfused', 'fused'])
def test_int8_dit_logits_match_jax(int8_weights, flags):
    """fp32 compute on both sides. The trunk's outputs and the head
    features agree to 1e-5 (no trunk code flip shows). The head's int8
    product is exact: fed JAX's features, the port's head gives JAX's
    logits bit for bit. But a head feature that sits within fp32 noise of a
    rounding tie of its code can quantize to the next code on one side
    (one did here, under XLA's and PyTorch's different summation orders).
    So the logits are held to 1e-3 on token rows whose head codes agree,
    and, on a row with n flipped codes, to 1e-3 plus n quantization steps
    of the head: n x x_scale x max |W|, what one code step can move a
    logit. Flips stay rare (at most 1 in 1000 codes)."""
    from ddg_tpu_torch.models.dit import dit_head_features, dit_head_matmul
    cfg = _jax_cfg()
    r = np.random.RandomState(2)
    x = r.randint(0, V, (3, L)).astype(np.int32)
    sigma = r.uniform(0, 2, 3).astype(np.float32)
    cond = np.array([0, 1, NC], np.int32)
    args = (jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(cond))
    want = np.asarray(jdit.DIT(cfg).apply({'params': int8_weights}, *args))
    jh, jc = jdit.DIT(cfg).apply({'params': int8_weights}, *args,
                                 skip_head=True)
    jfeats = np.array(jdit.dit_head_features(cfg, int8_weights, jh, jc))
    m = _int8_model(int8_weights, **flags)
    params = dict(m.named_parameters())
    targs = (torch.from_numpy(x), torch.from_numpy(sigma),
             torch.from_numpy(cond))
    with torch.no_grad():
        got = m(*targs).numpy()
        th, tc = m(*targs, skip_head=True)
        feats = dit_head_features(m.cfg, params, th, tc)
        same = dit_head_matmul(m.cfg, params, torch.from_numpy(jfeats))
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(feats.numpy(), jfeats, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        same.numpy(),
        np.asarray(jdit.dit_head_matmul(cfg, int8_weights, jfeats)))
    jcode, jscale = jq.quantize_rowwise(jnp.asarray(jfeats))
    code, _ = tq.quantize_rowwise(feats)
    flips = (code.numpy() != np.asarray(jcode)).sum(-1, keepdims=True)
    assert flips.sum() <= code.numel() // 1000
    w_max = np.abs(int8_weights['output_linear']['kernel']).max()
    bar = 1e-3 + flips * np.asarray(jscale) * w_max
    assert np.all(np.abs(got - want) <= bar)
    # The head function (first-hitting) takes the int8 head too.
    from ddg_tpu_torch.models.dit import dit_head_fn
    with torch.no_grad():
        rows = dit_head_fn(m.cfg, params, th[:, 3], tc)
    jrows = jdit.dit_head_fn(cfg, int8_weights, jh[:, 3], jc)
    assert np.all(np.abs(rows.numpy() - np.asarray(jrows)) <= bar[:, 3])


def test_int8_dit_refuses_training(int8_weights):
    m = _int8_model(int8_weights)
    x = torch.zeros((1, L), dtype=torch.int32)
    with pytest.raises(ValueError, match='inference-only'):
        m(x, torch.ones(1), train=True, rng=torch.Generator())
