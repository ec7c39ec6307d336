#!/usr/bin/env python3
"""Smoke test of `ddg_tpu_torch` on one NVIDIA Hopper card.

    python3 chip_smoke.py        # from the root of a checkout

Each phase prints one JSON line:
  1. environment: nvidia-smi's name and power limit, torch/CUDA versions,
     compute capability (sm_90 required);
  2. build: the CUDA sources under ddg_tpu_torch/csrc, compiled with nvcc
     into build/ddg_tpu_torch/ (seconds, ptxas register/spill lines);
  3. kernels against their plain PyTorch versions on the card, at the
     shapes of the main path, in float32 and bfloat16, with the median
     CUDA-event time of kernel, plain version and (attention only) the
     one PyTorch call that computes the same function;
  4. a tiny DiT on the card against the same weights on the CPU;
  5. the main path at full width: the flagship DiT-small (seeded random
     weights) serving ancestral D-CFG (gamma=2, T=128, B=24) through the
     feature-mix path, the same with the NFE cache (the CFG kernel), and
     first-hitting D-CFG (B=32); samples/s and kernel launches per run.
Then the `kernels` line, the nvidia-smi line, and the result line
{"ok": true, "device": {...}} last. Any failed check raises, so the run
exits non-zero without a result line; so does a machine without a CUDA
card, or a directory without the package.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import torch

MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_BF16_TENSOR = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12                # fp32 FLOP/s outside the tensor cores

# Main-path shapes: DiT-small, CFG doubles the batch of 24 in the trunk.
B, L, V = 24, 128, 30523
B2, D, H = 2 * B, 768, 12
DH = D // H
MASK = V - 1
DEV = 'cuda'
GAMMA = 2.0
FP32_TOL = 1e-4
# Gumbel-argmax tokens are compared where the top-two perturbed scores of
# the plain version differ by more than this; closer calls may go either
# way under another summation order.
MARGIN = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def bf16_tol(ref):
    """2 ulp of bf16 at the magnitude of the largest reference value."""
    m = ref.float().abs().max().item()
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def time_ms(fn, reps=30, warmup=3):
    """Median device time of one call, ms, from CUDA events between
    back-to-back calls. A sleep kernel holds the stream while the host
    queues all of them, so the host's launch cost stays out of the
    measurement."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0       # upper bound of one enqueue
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 2e-3)))  # ~2 GHz
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def bound(nbytes, ops, peak):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_environment():
    cap = torch.cuda.get_device_capability(0)
    emit({'phase': 'environment', 'nvidia_smi': nvidia_smi(),
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'python': sys.version.split()[0], 'capability': list(cap),
          'device_count': torch.cuda.device_count()})
    check(cap == (9, 0), f'need an sm_90 card, found sm_{cap[0]}{cap[1]}')


def phase_build():
    from ddg_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for _, log in libs.values()
             for ln in log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    emit({'phase': 'build', 'seconds': secs,
          'libraries': sorted(str(p) for p, _ in libs.values()),
          'ptxas': ptxas})


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=DEV)
            * scale).to(dtype)


def _close(name, dtype, out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    tol = FP32_TOL if dtype == torch.float32 else bf16_tol(ref)
    check(err <= tol, f'{name} {dtype}: max abs err {err} > {tol}')
    return err, tol


def check_adaln(results):
    from ddg_tpu_torch.ops import adaln
    gen = torch.Generator(device=DEV).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        x = _rand(gen, B2, L, D, dtype=dtype)
        y = _rand(gen, B2, L, D, dtype=dtype)
        # gate/shift/scale as chunks of one adaLN projection, as in the
        # model (row stride 6 D).
        mod = _rand(gen, B2, 6 * D, scale=0.5, dtype=dtype)
        shift, scale, gate = mod[:, :D], mod[:, D:2 * D], mod[:, 2 * D:3 * D]
        w = 1.0 + _rand(gen, D, scale=0.1)

        h = adaln.ln_modulate(x, w, shift, scale)
        h_ref = adaln.ln_modulate_plain(x, w, shift, scale)
        err, tol = _close('ln_modulate', dtype, h, h_ref)
        rec = {'err': err, 'tol': tol}
        if dtype == torch.bfloat16:
            rec['ms'] = time_ms(lambda: adaln.ln_modulate(x, w, shift, scale))
            rec['plain_ms'] = time_ms(
                lambda: adaln.ln_modulate_plain(x, w, shift, scale))
            rec['bound_ms'], rec['bound_by'] = bound(
                2 * B2 * L * D * es + 4 * D + 2 * B2 * D * es,
                8 * B2 * L * D, PEAK_FP32)
        results['ln_modulate'][str(dtype)] = rec

        xn, hn = adaln.gate_res_ln_modulate(y, x, gate, w, shift, scale)
        xr, hr = adaln.gate_res_ln_modulate_plain(y, x, gate, w, shift,
                                                  scale)
        e1, _ = _close('gate_res_ln_modulate x', dtype, xn, xr)
        e2, tol = _close('gate_res_ln_modulate h', dtype, hn, hr)
        rec = {'err': max(e1, e2), 'tol': tol}
        if dtype == torch.bfloat16:
            rec['ms'] = time_ms(lambda: adaln.gate_res_ln_modulate(
                y, x, gate, w, shift, scale))
            rec['plain_ms'] = time_ms(lambda: adaln.gate_res_ln_modulate_plain(
                y, x, gate, w, shift, scale))
            rec['bound_ms'], rec['bound_by'] = bound(
                4 * B2 * L * D * es + 4 * D + 3 * B2 * D * es,
                10 * B2 * L * D, PEAK_FP32)
        results['gate_res_ln_modulate'][str(dtype)] = rec


def check_attention(results):
    import torch.nn.functional as F
    from ddg_tpu_torch.models.dit import rope_cos_sin
    from ddg_tpu_torch.ops import attention
    gen = torch.Generator(device=DEV).manual_seed(4)
    cos, sin = rope_cos_sin(L, DH, device=DEV)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        # q, k, v as views into one fused qkv projection, as in the model.
        qkv = _rand(gen, B2, L, 3, H, DH, dtype=dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        rec = {}
        for causal in (False, True):
            o = attention.fused_rope_attention(q, k, v, cos, sin,
                                               causal=causal)
            ref = attention.fused_rope_attention_plain(q, k, v, cos, sin,
                                                       causal=causal)
            err, tol = _close(f'fused_rope_attention causal={causal}',
                              dtype, o, ref)
            rec['err'] = max(err, rec.get('err', 0.0))
            rec['tol'] = tol
        if dtype == torch.bfloat16:
            rec['ms'] = time_ms(lambda: attention.fused_rope_attention(
                q, k, v, cos, sin))
            rec['plain_ms'] = time_ms(
                lambda: attention.fused_rope_attention_plain(q, k, v, cos,
                                                             sin))
            # The library yardstick: SDPA on already rotated, heads-major
            # q, k, v.
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (
                attention.apply_rope(q, cos, sin),
                attention.apply_rope(k, cos, sin), v))
            rec['library_ms'] = time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh))
            rec['bound_ms'], rec['bound_by'] = bound(
                4 * B2 * L * D * es + 2 * L * (DH // 2) * 4,
                4 * B2 * H * L * L * DH, PEAK_BF16_TENSOR)
        results['fused_rope_attention'][str(dtype)] = rec
    # Shapes off the main path: a ragged L on the bf16 tensor-core path
    # (D = 64) and on the generic path (D = 32).
    for shape in ((4, 40, 3, 64), (4, 40, 2, 32)):
        c2, s2 = rope_cos_sin(shape[1], shape[3], device=DEV)
        for dtype in (torch.float32, torch.bfloat16):
            qkv = _rand(gen, shape[0], shape[1], 3, *shape[2:], dtype=dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            for causal in (False, True):
                _close(f'fused_rope_attention {shape} causal={causal}', dtype,
                       attention.fused_rope_attention(q, k, v, c2, s2,
                                                      causal=causal),
                       attention.fused_rope_attention_plain(
                           q, k, v, c2, s2, causal=causal))


def _sample_inputs(gen, dtype, n_logits):
    logits = [_rand(gen, B, L, V, scale=2.0, dtype=dtype)
              for _ in range(n_logits)]
    x0 = torch.randint(0, V - 1, (B, L), generator=gen, device=DEV,
                       dtype=torch.int32)
    masked = torch.rand((B, L), generator=gen, device=DEV) < 0.7
    xt = torch.where(masked, torch.full_like(x0, MASK), x0)
    mct = 0.4 + 0.5 * torch.rand((B,), generator=gen, device=DEV)
    mcs = 0.6 * mct
    return logits, xt, mct, mcs


def _token_check(name, out, ref, scores, xt):
    """Identical tokens where the top-two perturbed scores differ by more
    than MARGIN; decoded positions copied over exactly."""
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > MARGIN
    masked = xt == MASK
    bad = ((out != ref) & decided & masked).sum().item()
    check(bad == 0, f'{name}: {bad} tokens differ where the margin > '
                    f'{MARGIN}')
    check(torch.equal(out[~masked], xt[~masked]),
          f'{name}: decoded tokens not copied over')
    check(bool(((out >= 0) & (out < V)).all()), f'{name}: token outside V')
    return int(decided[masked].sum().item())


def _tie_check(fs):
    """All scores equal outside the mask channel: the lowest index wins."""
    Bt, Lt, Vt = 2, 4, 40
    z = torch.zeros((Bt, Lt, Vt), device=DEV)
    xt = torch.full((Bt, Lt), Vt - 1, dtype=torch.int32, device=DEV)
    mct = torch.full((Bt,), 0.9, device=DEV)
    mcs = torch.full((Bt,), 1e-3, device=DEV)   # the mask channel loses
    g = torch.zeros_like(z)
    a = fs.fused_absorbing_sample(0, xt, z, mct, mcs, mask_index=Vt - 1,
                                  gumbel=g)
    c = fs.fused_absorbing_cfg_sample(0, xt, z, z, GAMMA, mct, mcs,
                                      mask_index=Vt - 1, gumbel=g)
    check(bool((a == 0).all()) and bool((c == 0).all()),
          'ties must go to the lowest index')


def _tv_check(fs):
    """Internal-RNG draws against the exact posterior at small V: TV below
    twice the binomial floor 0.5 sum_v sqrt(2 q_v (1 - q_v) / (pi N))."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    Bt, Lt, Vt = 64, 1024, 16
    n = Bt * Lt
    row_c = torch.randn((Vt,), generator=gen, device=DEV)
    row_u = torch.randn((Vt,), generator=gen, device=DEV)
    xt = torch.full((Bt, Lt), Vt - 1, dtype=torch.int32, device=DEV)
    mct = torch.full((Bt,), 0.8, device=DEV)
    mcs = torch.full((Bt,), 0.3, device=DEV)
    out = {}
    for name, z_row, call in (
            ('fused_absorbing_sample', row_c,
             lambda: fs.fused_absorbing_sample(
                 1234, xt, row_c.expand(Bt, Lt, Vt).contiguous(), mct, mcs,
                 mask_index=Vt - 1)),
            ('fused_absorbing_cfg_sample', GAMMA * row_c + (1 - GAMMA) * row_u,
             lambda: fs.fused_absorbing_cfg_sample(
                 4321, xt, row_c.expand(Bt, Lt, Vt).contiguous(),
                 row_u.expand(Bt, Lt, Vt).contiguous(), GAMMA, mct, mcs,
                 mask_index=Vt - 1))):
        z = z_row.clone()
        z[Vt - 1] = -1e30
        p = torch.softmax(z, -1) * (0.8 - 0.3)
        p[Vt - 1] = 0.3
        q = (p / p.sum()).double()
        hist = torch.bincount(call().flatten().long(),
                              minlength=Vt).double() / n
        tv = 0.5 * (hist - q).abs().sum().item()
        floor = 0.5 * torch.sqrt(2 * q * (1 - q) / (math.pi * n)).sum().item()
        check(tv < 2 * floor, f'{name} internal RNG: TV {tv} >= 2 x floor '
                              f'{floor}')
        out[name] = {'tv': tv, 'floor': floor, 'draws': n}
    return out


def check_sampling(results):
    from ddg_tpu_torch.ops import fused_sampling as fs
    gen = torch.Generator(device=DEV).manual_seed(6)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        (lc, lu), xt, mct, mcs = _sample_inputs(gen, dtype, 2)
        g = -torch.log(-torch.log(
            torch.rand((B, L, V), generator=gen, device=DEV)
            .clamp_min(1e-20)))

        out = fs.fused_absorbing_sample(7, xt, lc, mct, mcs, mask_index=MASK,
                                        gumbel=g)
        ref = fs.fused_absorbing_sample_plain(7, xt, lc, mct, mcs,
                                              mask_index=MASK, gumbel=g)
        scores = fs.perturbed_scores(7, lc.float(), mct, mcs,
                                     mask_index=MASK, gumbel=g)
        n_a = _token_check('fused_absorbing_sample', out, ref, scores, xt)
        del scores

        out_c = fs.fused_absorbing_cfg_sample(7, xt, lc, lu, GAMMA, mct, mcs,
                                              mask_index=MASK, gumbel=g)
        ref_c = fs.fused_absorbing_cfg_sample_plain(
            7, xt, lc, lu, GAMMA, mct, mcs, mask_index=MASK, gumbel=g)
        scores = fs.perturbed_scores(7, fs.cfg_mix(lc, lu, GAMMA), mct, mcs,
                                     mask_index=MASK, gumbel=g)
        n_c = _token_check('fused_absorbing_cfg_sample', out_c, ref_c,
                           scores, xt)
        del scores, g
        rec_a = {'err': 0, 'compared_tokens': n_a}
        rec_c = {'err': 0, 'compared_tokens': n_c}
        if dtype == torch.bfloat16:
            # Timed as in the first step of the main path: every token
            # masked, noise from the in-kernel generator.
            xm = torch.full((B, L), MASK, dtype=torch.int32, device=DEV)
            seed = torch.tensor([11], dtype=torch.int32, device=DEV)
            rec_a['ms'] = time_ms(lambda: fs.fused_absorbing_sample(
                seed, xm, lc, mct, mcs, mask_index=MASK))
            rec_a['plain_ms'] = time_ms(
                lambda: fs.fused_absorbing_sample_plain(
                    seed, xm, lc, mct, mcs, mask_index=MASK), reps=10)
            rec_c['ms'] = time_ms(lambda: fs.fused_absorbing_cfg_sample(
                seed, xm, lc, lu, GAMMA, mct, mcs, mask_index=MASK))
            rec_c['plain_ms'] = time_ms(
                lambda: fs.fused_absorbing_cfg_sample_plain(
                    seed, xm, lc, lu, GAMMA, mct, mcs, mask_index=MASK),
                reps=10)
            small = 2 * B * L * 4 + 2 * B * 4 + 4
            # ~10 fp32 operations per logit (max/exp/sum pass, then the
            # subtractions, the two logs of the Gumbel draw and the
            # compare); the CFG mix adds 3.
            rec_a['bound_ms'], rec_a['bound_by'] = bound(
                B * L * V * es + small, 10 * B * L * V, PEAK_FP32)
            rec_c['bound_ms'], rec_c['bound_by'] = bound(
                2 * B * L * V * es + small, 13 * B * L * V, PEAK_FP32)
        results['fused_absorbing_sample'][str(dtype)] = rec_a
        results['fused_absorbing_cfg_sample'][str(dtype)] = rec_c
    _tie_check(fs)
    return _tv_check(fs)


# ---------------------------------------------------------------------------
# Phases 4 and 5: the model
# ---------------------------------------------------------------------------

def check_tiny_dit():
    """A tiny float32 DiT with the fused flags on the card against the same
    weights on the CPU (where the plain versions run): the BASELINE 1e-3
    logit bar."""
    import numpy as np
    from ddg_tpu_torch.convert import make_reference_dit_state_dict
    from ddg_tpu_torch.models import DIT, DITConfig
    cfg = DITConfig(hidden_size=128, cond_dim=32, length=32, n_blocks=2,
                    n_heads=2, vocab_size=101, num_classes=2,
                    compute_dtype=torch.float32, fused_rope_attn=True,
                    fused_adaln=True)
    sd = make_reference_dit_state_dict(
        np.random.RandomState(1), hidden=128, cond_dim=32, n_blocks=2,
        vocab=101, with_cond=True)
    # Larger weights than the 0.02 default, so that the logits vary.
    sd = {k: v * 10 if v.ndim == 2 else v for k, v in sd.items()}
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(0, 101, (4, 32), generator=gen, dtype=torch.int32)
    sigma = torch.rand((4,), generator=gen)
    cond = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    outs = []
    for dev in ('cpu', DEV):
        m = DIT(cfg)
        m.load_state_dict(sd, strict=True)
        m = m.to(dev).eval()
        with torch.no_grad():
            outs.append(m(x.to(dev), sigma.to(dev), cond.to(dev)).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    check(bool(torch.isfinite(outs[1]).all()), 'tiny DiT: non-finite logits')
    check(err < 1e-3, f'tiny DiT: card vs CPU logits differ by {err}')
    emit({'phase': 'tiny_dit_card_vs_cpu', 'max_abs_err': err,
          'logit_std': outs[0].std().item()})


def run_main_path(kernels):
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import flagship
    t0 = time.perf_counter()
    spec, cfg, _, apply_fn, params = flagship(device=DEV)
    emit({'phase': 'flagship', 'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in params.values()),
          'hidden': cfg.hidden_size, 'blocks': cfg.n_blocks,
          'heads': cfg.n_heads, 'length': cfg.length,
          'vocab': cfg.vocab_size})
    guidance = SM.GuidanceSpec(method='cfg', gamma=GAMMA)
    runs = [
        ('ancestral_feature_mix', 24,
         SM.SamplerSpec(steps=128, use_cache=False, fused=True),
         {'fused_absorbing_sample'}),
        ('ancestral_nfe_cache', 24,
         SM.SamplerSpec(steps=128, use_cache=True, fused=True),
         {'fused_absorbing_cfg_sample'}),
        ('first_hitting', 32, SM.SamplerSpec(first_hitting=True), set()),
    ]
    trunk = {'fused_rope_attention', 'ln_modulate', 'gate_res_ln_modulate'}

    def sample(batch, sampler, seed):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        cond = torch.zeros((batch,), dtype=torch.int32, device=DEV)
        return SM.diffusion_sample(spec, sampler, apply_fn, params, gen,
                                   batch_size=batch, length=cfg.length,
                                   guidance=guidance, cond=cond,
                                   dit_cfg=cfg)

    # Warm-up: the trunk's and head's GEMM shapes, outside the counts.
    sample(24, SM.SamplerSpec(steps=2, use_cache=False, fused=True), 99)
    torch.cuda.synchronize()
    totals = {name: 0 for name in kernels}
    for i, (name, batch, sampler, expect) in enumerate(runs):
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = sample(batch, sampler, i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        for k in kernels:
            totals[k] += launches[k]
        n_tok = x.numel()
        n_mask = int((x == MASK).sum().item())
        allowed = math.ceil(5 * n_tok / 8192)
        emit({'phase': 'main_path', 'run': name, 'batch': batch,
              'steps': None if sampler.first_hitting else sampler.steps,
              'seconds': secs, 'samples_per_s': batch / secs,
              'launches': launches, 'mask_tokens_left': n_mask,
              'distinct_tokens': int(torch.unique(x).numel())})
        check(tuple(x.shape) == (batch, cfg.length) and x.dtype == torch.int32,
              f'{name}: output {tuple(x.shape)} {x.dtype}')
        check(bool(((x >= 0) & (x < cfg.vocab_size)).all()),
              f'{name}: token outside [0, V)')
        check(n_mask <= allowed, f'{name}: {n_mask} mask tokens left '
                                 f'(> {allowed})')
        for k in trunk | expect:
            check(launches[k] > 0, f'{name}: kernel {k} never launched')
    return totals


SOURCES = {
    'fused_rope_attention': ('ddg_tpu_torch/csrc/rope_attention.cu',
                             'ddg_tpu/ops/attention_pallas.py:215'),
    'ln_modulate': ('ddg_tpu_torch/csrc/adaln.cu',
                    'ddg_tpu/ops/adaln_pallas.py:132'),
    'gate_res_ln_modulate': ('ddg_tpu_torch/csrc/adaln.cu',
                             'ddg_tpu/ops/adaln_pallas.py:215'),
    'fused_absorbing_sample': ('ddg_tpu_torch/csrc/absorbing_sample.cu',
                               'ddg_tpu/ops/fused_sampling.py:226'),
    'fused_absorbing_cfg_sample': ('ddg_tpu_torch/csrc/absorbing_sample.cu',
                                   'ddg_tpu/ops/fused_sampling.py:281'),
}


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddg_tpu_torch.ops import adaln, attention
    from ddg_tpu_torch.ops import fused_sampling as fs
    kernels = {
        'fused_rope_attention': attention.fused_rope_attention,
        'ln_modulate': adaln.ln_modulate,
        'gate_res_ln_modulate': adaln.gate_res_ln_modulate,
        'fused_absorbing_sample': fs.fused_absorbing_sample,
        'fused_absorbing_cfg_sample': fs.fused_absorbing_cfg_sample,
    }

    phase_environment()
    phase_build()

    results = {name: {} for name in kernels}
    check_adaln(results)
    check_attention(results)
    tv = check_sampling(results)
    emit({'phase': 'kernels_vs_plain', 'results': results,
          'internal_rng': tv})
    check_tiny_dit()
    launches = run_main_path(kernels)

    rows = []
    for name in kernels:
        r = results[name][str(torch.bfloat16)]
        src, replaces = SOURCES[name]
        rows.append({'name': name, 'route': 'cuda', 'source': src,
                     'replaces': replaces, 'launches': launches[name],
                     'max_abs_err': r['err'], 'ms': r['ms'],
                     'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                     'bound_by': r['bound_by'],
                     'library_ms': r.get('library_ms')})
    emit({'phase': 'done', 'seconds': time.perf_counter() - t_start})
    emit({'kernels': rows})
    print(nvidia_smi(), flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
