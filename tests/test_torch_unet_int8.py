"""The port's int8 convolution (`ops.quant.int8_conv2d`, `QConv`) and int8 UNet (`UNetConfig(quant_int8=True)`) against
`ddg_tpu.ops.quant.int8_conv` and the JAX `quant_int8=True` UNet, on the
same numpy inputs and weights (carried across by
`convert.unet_state_dict_from_jax`), at `bench.py --unet --quick`'s size
(ch 16, one res block, 2 scales, 8 x 8 x 3 images: L=192, V=256).

- `int8_conv2d`: codes and scales equal JAX's (a zero sample and exact .5
  ties included); the int32 sums equal an int64 numpy convolution of the
  codes exactly; the fp32 outputs agree with JAX's to one fp32 ulp, bf16
  ones to one bf16 ulp; at stride 1 / padding 1 and at stride 2 / VALID
  after the Downsample's (0, 1) pad, Cin 3 and 16, Cout 6 and 16.
- The int8 UNet in float32: the activation codes of every int8 layer
  agree with JAX's on all but at most 1 in 1000 codes; on the samples with
  no flipped code, the trunk's output to 1e-4 and the logits to the float
  UNet's bar (1e-3 abs + 5e-3 relative, the logistic head's cancelling
  tail: `tests/test_torch_unet.py`).
- The int8 scheme's own shift of the posteriors (float32 int8 UNet
  against the float32 UNet) is JAX's, within 0.1% in mean and 95th
  percentile TV, and it is past twice the binomial floor of 4000 draws.
- The int8 UNet in bf16 (bf16 GroupNorm outputs, the `unet_int8` line's
  dtypes): its posteriors are as close to JAX's float32 int8 UNet's as
  JAX's own bf16 ones are, within 25%.
- The int8 UNet's state-dict keys are the float model's; its int8 layers
  hold float32 weights; it refuses training; its flagship samples pixel
  tokens.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddg_tpu.models import unet as junet
from ddg_tpu.ops import quant as jq
from ddg_tpu_torch import samplers as TS
from ddg_tpu_torch.convert import unet_state_dict_from_jax
from ddg_tpu_torch.entry import unet_flagship
from ddg_tpu_torch.models import UNet, UNetConfig
from ddg_tpu_torch.models import unet as tunet
from ddg_tpu_torch.ops import quant as tq

torch.set_num_threads(1)
IMG, V, NC = 8, 256, 10
L = 3 * IMG * IMG
SMALL = dict(ch=16, num_res_blocks=1, num_scales=2, ch_mult=(1, 1),
             image_size=IMG, num_classes=NC, dropout=0.0)
JCFG = junet.UNetConfig(**SMALL, compute_dtype=jnp.float32)
TCFG = UNetConfig(**SMALL, compute_dtype=torch.float32)


def _ulp(a, mantissa):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30)))
                   - mantissa)


# ---------------------------------------------------------------------------
# int8_conv2d
# ---------------------------------------------------------------------------

def _conv_inputs(cin, cout, seed):
    """x (3, 8, 8, cin) with sample 1 all zero and exact .5 ties in sample
    2 (absmax 127 gives scale 1); an HWIO kernel and a bias."""
    r = np.random.RandomState(seed)
    x = (r.randn(3, 8, 8, cin) * 2).astype(np.float32)
    x[1] = 0.0
    x[2] = np.round(x[2] * 20) / 2
    x[2, 0, 0, 0] = 127.0
    x[2] = np.clip(x[2], -127, 127)
    kernel = (r.randn(3, 3, cin, cout) * 0.3).astype(np.float32)
    bias = (r.randn(cout) * 0.5).astype(np.float32)
    return x, kernel, bias


def _np_conv(xq, wq, stride, pad):
    """int64 convolution of codes xq (B, H, W, Cin) by wq (kh, kw, Cin,
    Cout), zero padding `pad` a side."""
    xq = np.pad(xq.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    kh, kw, _, cout = wq.shape
    B, H, W, _ = xq.shape
    Ho, Wo = (H - kh) // stride + 1, (W - kw) // stride + 1
    out = np.zeros((B, Ho, Wo, cout), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            patch = xq[:, dy:dy + stride * (Ho - 1) + 1:stride,
                       dx:dx + stride * (Wo - 1) + 1:stride]
            out += patch @ wq[dy, dx].astype(np.int64)
    return out


MODES = {'same': (1, 1), 'down': (2, 0)}   # (stride, padding)


@pytest.mark.parametrize('mode', list(MODES))
@pytest.mark.parametrize('cin,cout', [(3, 6), (16, 16)])
def test_int8_conv_matches_jax(cin, cout, mode):
    x, kernel, bias = _conv_inputs(cin, cout, cin + cout)
    stride, pad = MODES[mode]
    if mode == 'down':            # the Downsample's asymmetric (0, 1) pad
        x = np.pad(x, ((0, 0), (0, 1), (0, 1), (0, 0)))
    jpad = [(pad, pad)] * 2 if pad else 'VALID'
    # Codes and scales: JAX's int8_conv quantizes x per sample and the
    # kernel per output channel, as these two calls do.
    B = x.shape[0]
    jxq, jxs = jq.quantize_rowwise(jnp.asarray(x.reshape(B, -1)))
    jwq, jws = jq.quantize_colwise(jnp.asarray(kernel.reshape(-1, cout)))
    xq, xs = tq.quantize_per_sample(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy().reshape(B, -1), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy().reshape(B, 1), np.asarray(jxs))
    assert not xq[1].any()
    wq, ws = tq.quantized_weight(
        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), 'conv')
    K = 9 * cin
    np.testing.assert_array_equal(wq[:cout, :K].numpy().T, np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    # The int32 sums: exact.
    acc = tq.int8_conv_acc(xq, wq, 3, 3, cout, stride=stride, padding=pad)
    assert acc.dtype == torch.int32
    want_acc = _np_conv(xq.numpy(), np.asarray(jwq).reshape(3, 3, cin, cout),
                        stride, pad)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    # Outputs: one fp32 ulp; bf16 one bf16 ulp.
    w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    for jdt, tdt, mant in ((jnp.float32, torch.float32, 23),
                           (jnp.bfloat16, torch.bfloat16, 7)):
        want = np.asarray(jq.int8_conv(
            jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
            strides=(stride, stride), padding=jpad, out_dtype=jdt)
            .astype(jnp.float32))
        got = tq.int8_conv2d(torch.from_numpy(x), w, torch.from_numpy(bias),
                             stride=stride, padding=pad, out_dtype=tdt)
        assert got.dtype == tdt and got.shape == want.shape
        assert np.all(np.abs(got.float().numpy() - want)
                      <= _ulp(want, mant))


def test_qconv_is_a_drop_in_for_conv2d():
    """The same parameters and state-dict keys as `nn.Conv2d`, float32
    whatever `dtype` is (which sets the output dtype); channels-last in
    and out; the weight's codes are kept until the weight changes."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(16, 8, 3, padding=1)
    q = tq.QConv(16, 8, 3, padding=1, dtype=torch.bfloat16)
    assert list(q.state_dict()) == list(conv.state_dict())
    assert q.weight.dtype == torch.float32 and q.bias.dtype == torch.float32
    q.load_state_dict(conv.state_dict(), strict=True)
    x = torch.randn(2, 8, 8, 16)
    with torch.no_grad():
        got = q(x)
        assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 8, 8)
        want = tq.int8_conv2d(x, conv.weight, conv.bias, padding=1,
                              out_dtype=torch.bfloat16)
        assert torch.equal(got, want)
        codes = tq.quantized_weight(q.weight, 'conv')[0]
        assert tq.quantized_weight(q.weight, 'conv')[0] is codes
        q.weight.mul_(2.0)
        assert tq.quantized_weight(q.weight, 'conv')[0] is not codes


# ---------------------------------------------------------------------------
# The int8 UNet against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def params():
    """JAX-initialised params, perturbed by seeded noise (flax zero-inits
    the biases and, near, the attention output projection)."""
    x = jnp.zeros((1, L), jnp.int32)
    p = jax.jit(junet.UNet(JCFG).init)(
        jax.random.PRNGKey(0), x, jnp.ones((1,)),
        jnp.zeros((1,), jnp.int32))['params']
    r = np.random.RandomState(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * r.randn(*a.shape).astype(np.float32),
        p)


@pytest.fixture(scope='module')
def inputs():
    r = np.random.RandomState(2)
    return (r.randint(0, V, (3, L)).astype(np.int32),
            r.uniform(0, 1, 3).astype(np.float32),
            np.array([0, 7, NC], np.int32))     # NC is the null class


def _is_int8_layer(module):
    return (isinstance(module, jq.QConv)
            or (isinstance(module, junet.NiN) and module.quant))


def jax_int8(params, inputs, **kw):
    """JAX's int8 UNet: (logits, trunk output, the input of every int8
    layer in call order), read by a flax method interceptor."""
    cfg = dataclasses.replace(JCFG, quant_int8=True, **kw)

    def fn(p, *a):
        seen = []

        def grab(next_fun, args, kwargs, ctx):
            if ctx.method_name == '__call__' and _is_int8_layer(ctx.module):
                seen.append(args[0])
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(grab):
            out = junet.UNet(cfg).apply({'params': p}, *a,
                                        return_hidden_states=True)
        return out, seen

    (logits, hidden), seen = jax.jit(fn)(params, *inputs)
    return (np.array(logits.astype(jnp.float32)), np.asarray(hidden),
            [np.asarray(a.astype(jnp.float32)) for a in seen])


def port_int8(params, inputs, **kw):
    """The port's int8 UNet: (logits, trunk output, [(kind, input of every
    int8 layer)] in call order), read by forward pre-hooks."""
    m = UNet(dataclasses.replace(TCFG, quant_int8=True, **kw))
    m.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    seen = []
    for mod in m.modules():
        if isinstance(mod, tq.QConv) or (isinstance(mod, tunet.NiN)
                                         and mod.int8):
            kind = 'conv' if isinstance(mod, tq.QConv) else 'dense'
            mod.register_forward_pre_hook(
                lambda mod, a, kind=kind: seen.append((kind, a[0].float())))
    with torch.no_grad():
        logits, hidden = m.eval()(*(torch.from_numpy(a) for a in inputs),
                                  return_hidden_states=True)
    return logits.float().numpy(), hidden.float().numpy(), seen


@pytest.fixture(scope='module')
def int8_f32(params, inputs):
    """(JAX's, the port's) float32 int8 UNet outputs."""
    return jax_int8(params, inputs), port_int8(params, inputs)


def test_int8_unet_logits_match_jax(int8_f32):
    (want, want_hidden, jseen), (got, hidden, tseen) = int8_f32
    assert len(jseen) == len(tseen) == 19 + 20
    assert [k for k, _ in tseen].count('conv') == 19
    flips, codes = np.zeros(3, np.int64), 0
    for (kind, tx), jx in zip(tseen, jseen):
        B = jx.shape[0]
        if kind == 'conv':
            code = tq.quantize_per_sample(tx)[0].numpy().reshape(B, -1)
            jcode = np.asarray(jq.quantize_rowwise(jx.reshape(B, -1))[0])
        else:
            code = tq.quantize_rowwise(tx)[0].numpy().reshape(B, -1)
            jcode = np.asarray(jq.quantize_rowwise(jx)[0]).reshape(B, -1)
        flips += (code != jcode).sum(-1)
        codes += code.size
    assert flips.sum() <= codes // 1000
    same = flips == 0
    assert same.sum() >= 2
    assert want.std() > 1.0
    np.testing.assert_allclose(hidden[same], want_hidden[same], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got[same], want[same], atol=1e-3, rtol=5e-3)


def test_int8_posterior_shift_matches_jax(params, inputs, int8_f32):
    """The int8 scheme's own move of the posteriors (softmax of the logits):
    the per-position TV of the float32 int8 UNet from the float32 UNet,
    port against JAX on the same params. The port's mean and 95th
    percentile are JAX's within 0.1% (a flipped activation code would move
    a sample's logits; 3e-6 relative measured); and JAX's own shift is past twice the
    binomial TV floor of 4000 draws at its worst position, so a test that
    holds the int8 posteriors to that floor of the float ones cannot pass
    for JAX's int8 UNet either."""
    def float_logits():
        jl = jax.jit(junet.UNet(JCFG).apply)({'params': params}, *inputs)
        m = UNet(TCFG)
        m.load_state_dict(unet_state_dict_from_jax(params), strict=True)
        with torch.no_grad():
            tl = m.eval()(*(torch.from_numpy(a) for a in inputs))
        return torch.from_numpy(np.array(jl)), tl

    (j32, t32), (j8, t8) = float_logits(), (r[0] for r in int8_f32)

    def tv(a, b):
        return (torch.tensor(a).softmax(-1)
                - torch.tensor(b).softmax(-1)).abs().sum(-1).flatten() / 2

    jt, tt = tv(j8, j32), tv(t8, t32)
    stats = [(t.mean().item(), torch.quantile(t, 0.95).item())
             for t in (jt, tt)]
    (jm, jp), (tm, tp) = stats
    assert abs(tm - jm) <= 1e-3 * jm and abs(tp - jp) <= 1e-3 * jp, stats
    q = j32.softmax(-1).double().flatten(0, -2)
    floor = 0.5 * torch.sqrt(2 * q * (1 - q) / (np.pi * 4000)).sum(-1)
    assert (jt.double() / floor).max() > 2.0


def test_int8_unet_bf16_as_close_as_jax(params, inputs, int8_f32):
    """bf16 compute and bf16 GroupNorm outputs on both sides. The two sides
    round the trunk differently (orders of sums, and a rounding near a
    code's tie quantizes to the next code), so they are not compared with
    each other: each is compared with JAX's float32 int8 UNet by the
    per-position TV of the posteriors, and the port's mean and 95th
    percentile must be at most 1.25 x JAX's own."""
    ref = torch.from_numpy(int8_f32[0][0]).softmax(-1)
    bf16 = dict(compute_dtype=jnp.bfloat16, norm_dtype=jnp.bfloat16)
    jax_bf16 = torch.from_numpy(jax_int8(params, inputs, **bf16)[0])
    port_bf16 = torch.from_numpy(port_int8(
        params, inputs, compute_dtype=torch.bfloat16,
        norm_dtype=torch.bfloat16)[0])

    def tv(logits):
        t = (logits.softmax(-1) - ref).abs().sum(-1) / 2
        return t.mean().item(), torch.quantile(t, 0.95).item()

    (jm, jp), (tm, tp) = tv(jax_bf16), tv(port_bf16)
    assert jm > 1e-3            # bf16 moves the posteriors: a real bar
    assert tm <= 1.25 * jm and tp <= 1.25 * jp, ((tm, tp), (jm, jp))


def test_int8_unet_keeps_the_float_tree_and_refuses_training():
    m = UNet(dataclasses.replace(TCFG, quant_int8=True,
                                 compute_dtype=torch.bfloat16))
    assert list(m.state_dict()) == list(UNet(TCFG).state_dict())
    n_conv = sum(isinstance(mod, tq.QConv) for mod in m.modules())
    n_nin = sum(isinstance(mod, tunet.NiN) and mod.int8
                for mod in m.modules())
    assert (n_conv, n_nin) == (19, 20)
    for name, p in m.named_parameters():
        int8_layer = (name.startswith('conv_in') or '.conv' in name
                      or name.endswith(('.W', '.b')))
        want = torch.float32 if int8_layer else torch.bfloat16
        if 'norm' in name or name.startswith('conv_out'):
            want = torch.float32
        assert p.dtype == want, name
    with pytest.raises(ValueError, match='inference-only'):
        m(torch.zeros((1, L), dtype=torch.int32), torch.zeros(1),
          train=True, rng=torch.Generator())


def test_int8_flagship_is_the_unet_int8_line():
    """`unet_flagship(int8=True)` at full width (no forward): the same
    weights as the bf16 flagship, 51 int8 convs and 37 int8 NiNs, bf16
    GroupNorm outputs through the fused norm."""
    _, cfg, m8, _, p8 = unet_flagship(device='cpu', int8=True)
    _, _, _, _, p16 = unet_flagship(device='cpu')
    assert cfg.quant_int8 and cfg.fused_norm
    assert cfg.norm_dtype == torch.bfloat16
    assert cfg.compute_dtype == torch.bfloat16
    assert sum(isinstance(mod, tq.QConv) for mod in m8.modules()) == 51
    assert sum(isinstance(mod, tunet.NiN) and mod.int8
               for mod in m8.modules()) == 37
    assert sum(p.numel() for p in p8.values()) == 35_755_398
    assert p8.keys() == p16.keys()
    for k in p16:
        assert torch.equal(p8[k].to(p16[k].dtype), p16[k]), k


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
def test_int8_flagship_samples_pixel_tokens(fused, monkeypatch):
    """`unet_flagship(tiny=True, int8=True)` on the CPU, D-CFG at gamma 2:
    the unfused chain, and the fused step forced (K10's plain version)."""
    if fused:
        monkeypatch.setattr(TS, '_fused_ok',
                            lambda spec, sampler, guidance, xt: sampler.fused)
    spec, cfg, _, apply_fn, params = unet_flagship(tiny=True, device='cpu',
                                                   int8=True)
    assert cfg.quant_int8
    x = TS.diffusion_sample(
        spec, TS.SamplerSpec(steps=3, use_cache=False, fused=fused),
        apply_fn, params, torch.Generator().manual_seed(4), batch_size=2,
        length=cfg.length, guidance=TS.GuidanceSpec(method='cfg', gamma=2.0),
        cond=torch.tensor([1, 9], dtype=torch.int32))
    assert x.dtype == torch.int32 and x.shape == (2, L)
    assert ((x >= 0) & (x < 256)).all()
