#!/usr/bin/env python3
"""Where the time of `ddg_tpu_torch`'s sampling goes on one CUDA card.

    python3 scripts/profile_torch_sampling.py [--steps 16] [--trace-dir DIR]
        [--model all|dit|unet] [--fused-head] [--int8]
        [--guidance cbg|cbg_approx|nos]

Builds the two serving flagships (seeded random weights, the Hopper
kernels on) and runs each sampler three times: to warm up, timed, and
under `torch.profiler`. The samplers are, for the LM1B DiT-small,
ancestral D-CFG (gamma 2, B=24) through the feature-mix path and through
the NFE cache, and first-hitting (B=32, all L=128 events); for the CIFAR10
UNet (UDLM), ancestral D-CFG (gamma 2) and unguided, B=32; for the
Species10 DiMamba (UDLM, L=32768), D-CFG (gamma 2) and unguided, B=8,
for `--dimamba-steps` steps. `--int8` runs the DiT samplers on the int8
flagship (`flagship(int8=True)`: the trunk's products and the vocab head
quantized) and adds the int8 UNet's D-CFG line (`unet_flagship(int8=
True)`, the JAX suite's `unet_int8`), `--fused-head` runs the
feature-mix sampler with `fused_head` (the vocab product inside the step,
K11 or, with `--int8`, K12), and `--model dit` or `unet` profiles that
model's lines alone (default all three models). An int8 UNet line also
charges its kernels to profiler ranges around the quantization's pieces
(activation codes, im2col, the int32 product, the rescale) and prints
their device ms and launches a step. `--guidance` profiles one
classifier-guided line of the JAX default suite alone instead: D-CBG
exact (`cbg`, chunk 128) or first-order (`cbg_approx`) on the QM9 flagship
(`entry.qm9_cbg_flagship`, B=16), or NOS (`nos`, one Adagrad step) on the
LM1B flagship with its head-only classifier (`entry.nos_flagship`, B=16),
for `--steps` steps. For each it
prints one JSON line: wall ms per step, device-busy ms per step, the
card's idle share, and device ms per step by kernel group, from the
trace's kernel events, and the twelve kernels with the most device
time. TF32 is off for matmuls and convolutions, as in
`chip_smoke.py`. With --trace-dir the Chrome traces are written there
(tens of MB).
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = (   # first match wins; matched against the kernel's name
    ('K1 rope_attention', ('attention_wgmma_kernel<true',
                           'attention_kernel<__nv_bfloat16, true',
                           'attention_kernel<float, true')),
    ('K1b rope_attention_bwd', ('attention_bwd_', 'rope_rows_kernel')),
    ('K3/K5 adaln', ('ln_modulate_kernel', 'gate_res_kernel')),
    ('K4/K6 adaln_bwd', ('adaln_bwd_',)),
    ('K7/K8 absorbing_sample', ('absorbing_sample',)),
    ('K11/K12 head_sample', ('head_sample', 'head_wgmma', 'head_s8',
                             'head_merge')),
    ('K9/K10 uniform_sample', ('uniform_sample', 'uniform_narrow', 'uniform_wide')),
    ('K13 groupnorm', ('gn_slab', 'gn_stats', 'gn_apply')),
    ('K18 in/out_proj', ('gemm_wgmma_kernel', 'gemm_f32_kernel')),
    ('K18 conv/x_proj/dt_proj', ('mamba_front',)),
    ('K18/K14 scan', ('scan_fwd', 'scan_chunk', 'scan_carry', 'scan_out')),
    ('gemm/conv', ('gemm', 'xmma', 'cutlass', 'nvjet', 'cublas', 'conv',
                   'cudnn', 'igemm')),
    ('elementwise/reduce/other', ('',)),
)


TOP = 12     # the kernels with the most device time, by name


def group_of(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return GROUPS[-1][0]


def all_events(trace_path):
    with open(trace_path) as f:
        return json.load(f)['traceEvents']


def kernel_events(trace_path):
    return [e for e in all_events(trace_path) if e.get('cat') == 'kernel']


# The int8 UNet's quantization pieces, as profiler ranges (`quant_ranges`).
QUANT_RANGES = (('int8 activation codes', 'quantize_per_sample'),
                ('int8 activation codes', 'quantize_rowwise'),
                ('int8 im2col', 'im2col'),
                ('int8 int32 product', 'int8_matmul'),
                ('int8 rescale', 'rescale'))


@contextlib.contextmanager
def quant_ranges():
    """Profiler ranges around `ops.quant`'s pieces (looked up by name at
    call time inside the module)."""
    from ddg_tpu_torch.ops import quant
    saved = [(attr, getattr(quant, attr)) for _, attr in QUANT_RANGES]

    def ranged(name, fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return wrapped

    for name, attr in QUANT_RANGES:
        setattr(quant, attr, ranged(name, getattr(quant, attr)))
    try:
        yield
    finally:
        for attr, fn in saved:
            setattr(quant, attr, fn)


def range_split(events, n_steps):
    """Device ms and launches a step of the kernels that ran inside each
    QUANT_RANGES range (by the midpoint of the kernel's device span)."""
    names = {name for name, _ in QUANT_RANGES}
    spans = [(e['name'], e['ts'], e['ts'] + e['dur']) for e in events
             if e.get('cat') == 'gpu_user_annotation' and e['name'] in names]
    ms, count = {}, {}
    for e in events:
        if e.get('cat') != 'kernel':
            continue
        t = e['ts'] + e['dur'] / 2
        hit = [n for n, a, b in spans if a <= t <= b]
        if hit:
            ms[hit[0]] = ms.get(hit[0], 0.0) + e['dur'] / 1e3 / n_steps
            count[hit[0]] = count.get(hit[0], 0) + 1 / n_steps
    return {'device_ms_per_step': ms, 'launches_per_step': count}


def profile(name, run, n_steps, trace_dir, ranges=None):
    """One warm-up, one timed run, one run under the profiler (inside the
    `ranges` context, if given, whose split is printed). The idle share
    compares the profiled device time with the unprofiled wall time (the
    profiler slows the host, not the kernels)."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with (ranges() if ranges else contextlib.nullcontext()), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(trace_dir, f'{name}.json')
    prof.export_chrome_trace(path)
    kernels = kernel_events(path)
    if not kernels:
        raise RuntimeError('the profiler recorded no kernel on the card')
    by_group, count, by_name = {}, {}, {}
    for e in kernels:
        g = group_of(e['name'])
        by_group[g] = by_group.get(g, 0.0) + e['dur'] / 1e3
        count[g] = count.get(g, 0) + 1
        by_name[e['name']] = by_name.get(e['name'], 0.0) + e['dur'] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # Kernels of one stream do not overlap: their sum is the busy time.
    busy = sum(by_group.values())
    print(json.dumps({
        'run': name, 'steps': n_steps,
        'wall_ms_per_step': wall / n_steps,
        'device_busy_ms_per_step': busy / n_steps,
        'idle_share': 1.0 - busy / wall,
        'device_ms_per_step': {g: v / n_steps for g, v in sorted(
            by_group.items(), key=lambda kv: -kv[1])},
        'kernels_per_step': {g: c / n_steps for g, c in count.items()},
        'launches_per_step': len(kernels) / n_steps,
        'top_kernels_ms_per_step': [[n[:120], v / n_steps] for n, v in top],
        'profiled_wall_ms_per_step': profiled_wall / n_steps,
        **({'quant_split': range_split(all_events(path), n_steps)}
           if ranges else {})}), flush=True)


def profile_guided(args):
    """The classifier-guided line `args.guidance` at B=16 (`profile`)."""
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import nos_flagship, qm9_cbg_flagship
    if args.guidance == 'nos':
        spec, cfg, apply_fn, params, clf_apply, clf_params = nos_flagship(
            device='cuda')
        guidance = SM.GuidanceSpec(method='nos', condition=1,
                                   num_nos_steps=1, nos_step_size=0.1,
                                   nos_stability_coef=0.01)
    else:
        approx = args.guidance == 'cbg_approx'
        (spec, cfg, _, apply_fn, params, clf_apply,
         clf_params) = qm9_cbg_flagship(device='cuda', approx=approx)
        guidance = SM.GuidanceSpec(method='cbg', gamma=2.0, condition=1,
                                   use_approx=approx, cbg_chunk=128)

    def run():
        gen = torch.Generator(device='cuda').manual_seed(0)
        SM.diffusion_sample(
            spec, SM.SamplerSpec(steps=args.steps, use_cache=False),
            apply_fn, params, gen, batch_size=16, length=cfg.length,
            guidance=guidance, classifier_apply=clf_apply,
            classifier_params=clf_params)

    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'torch': torch.__version__}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        profile(args.guidance, run, args.steps, trace_dir)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=16,
                    help='ancestral steps to profile (default 16)')
    ap.add_argument('--dimamba-steps', type=int, default=8,
                    help='Species10 DiMamba steps to profile (default 8)')
    ap.add_argument('--trace-dir', default=None,
                    help='write the Chrome traces here')
    ap.add_argument('--fused-head', action='store_true',
                    help='feature-mix with fused_head (K11, or K12 with '
                         '--int8)')
    ap.add_argument('--int8', action='store_true',
                    help='the DiT samplers on the int8 flagship, and the '
                         'int8 UNet line')
    ap.add_argument('--model', choices=('all', 'dit', 'unet'),
                    default='all',
                    help='profile this model\'s lines alone (default: the '
                         'DiT, UNet and DiMamba lines)')
    ap.add_argument('--guidance', choices=('cbg', 'cbg_approx', 'nos'),
                    help='profile this classifier-guided line alone')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import dimamba_flagship, flagship, unet_flagship
    if args.guidance:
        return profile_guided(args)
    tag = '_int8' if args.int8 else ''
    guidance = SM.GuidanceSpec(method='cfg', gamma=2.0)

    def runner(batch, sampler):
        def run():
            gen = torch.Generator(device='cuda').manual_seed(0)
            cond = torch.zeros((batch,), dtype=torch.int32, device='cuda')
            SM.diffusion_sample(spec, sampler, apply_fn, params, gen,
                                batch_size=batch, length=cfg.length,
                                guidance=guidance, cond=cond, dit_cfg=cfg)
        return run

    def unet_runner(guided, flag):
        uspec, ucfg, _, uapply, uparams = flag

        def run():
            gen = torch.Generator(device='cuda').manual_seed(0)
            kw = {}
            if guided:
                kw = dict(guidance=guidance, cond=torch.zeros(
                    (32,), dtype=torch.int32, device='cuda'))
            SM.diffusion_sample(
                uspec, SM.SamplerSpec(steps=args.steps, use_cache=False,
                                      fused=True), uapply, uparams, gen,
                batch_size=32, length=3 * ucfg.image_size ** 2, **kw)
        return run

    def dimamba_runner(guided):
        def run():
            gen = torch.Generator(device='cuda').manual_seed(0)
            kw = {}
            if guided:
                kw = dict(guidance=guidance, cond=torch.zeros(
                    (8,), dtype=torch.int32, device='cuda'))
            SM.diffusion_sample(
                dspec, SM.SamplerSpec(steps=args.dimamba_steps,
                                      use_cache=False, fused=True),
                dapply, dparams, gen, batch_size=8, length=dcfg.length, **kw)
        return run

    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'torch': torch.__version__}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        if args.model in ('all', 'unet'):
            flag = unet_flagship(device='cuda')
            profile('unet_dcfg', unet_runner(True, flag), args.steps,
                    trace_dir)
            profile('unet_unguided', unet_runner(False, flag), args.steps,
                    trace_dir)
            if args.int8:
                flag = unet_flagship(device='cuda', int8=True)
                profile('unet_int8_dcfg', unet_runner(True, flag),
                        args.steps, trace_dir, ranges=quant_ranges)
            del flag
        if args.model == 'unet':
            return 0
        spec, cfg, _, apply_fn, params = flagship(device='cuda',
                                                  int8=args.int8)
        profile('ancestral_feature_mix' + tag
                + ('_fused_head' if args.fused_head else ''),
                runner(24, SM.SamplerSpec(
                    steps=args.steps, use_cache=False, fused=True,
                    fused_head=args.fused_head)), args.steps, trace_dir)
        profile('ancestral_nfe_cache' + tag, runner(24, SM.SamplerSpec(
            steps=args.steps, use_cache=True, fused=True)), args.steps,
            trace_dir)
        profile('first_hitting' + tag, runner(32, SM.SamplerSpec(
            first_hitting=True)), cfg.length, trace_dir)
        if args.model == 'dit':
            return 0
        dspec, dcfg, _, dapply, dparams = dimamba_flagship(device='cuda')
        profile('species10_dcfg', dimamba_runner(True), args.dimamba_steps,
                trace_dir)
        profile('species10_unguided', dimamba_runner(False),
                args.dimamba_steps, trace_dir)
    return 0


if __name__ == '__main__':
    sys.exit(main())
