#!/usr/bin/env python3
"""Where the time of `ddg_tpu_torch`'s training step goes on one CUDA card.

    python3 scripts/profile_torch_train.py [--model dit|dimamba|text8|unet|both]
                                           [--route ROUTE] [--sweep]
                                           [--steps 2] [--trace-dir DIR]

For each model, builds its training run, warms it up, times `--steps`
steps unprofiled and one step under `torch.profiler`, and prints one JSON
line with wall ms per step, device-busy ms per step, the card's idle
share, device ms per step by group and the largest kernels by name.

- dit: `entry.train_flagship` (LM1B DiT-small MDLM, global batch 512 x 128
  tokens as micro-batches); groups by kernel name. A second line times the
  vocab head's three float32 GEMMs alone at the micro-batch's shape with
  CUDA events, times the micro-steps of a step.
- text8: `entry.text8_train_flagship` (DiT-small MDLM at L=256, global
  batch 512 x 256) on `--route` ('fused_rope', the default, 'short_seq'
  or 'flash', the library flash attention's K20-K22), grouped as dit. With
  `--sweep`, first a micro-batch sweep instead: for each micro-batch of 16
  to 512 a fresh run, one warm-up and `--steps` timed steps, one JSON line
  with ms/step, tokens/s and peak memory (or the out-of-memory error),
  then a line naming the fastest micro-batch whose peak stays under half
  the card.
- unet: `entry.unet_train_flagship` (CIFAR10 UNet UDLM, global batch 512
  images as micro-batches, bf16, the plain GroupNorms under autograd),
  grouped as dit (cuDNN's convolutions under 'conv'). With `--sweep`,
  first a sweep of the micro-batches 32 to 512 as text8's.
- dimamba: `entry.dimamba_train_flagship` (Species10 DiMamba UDLM, global
  batch 32 x 32768) on `--route` ('fused_block', the default, or
  'dt_lowrank', the unfused chain around K16/K17). The step runs with
  profiler ranges around K14-K19 calls, the loss's forward and the
  backward, and a kernel on the card is charged to the innermost range it
  ran in: K14-K18 and K19 (the latter by kernel), the trunk's forward and
  backward work outside them, the optimizer/clip/EMA (foreach kernels) and
  the rest. With `--sweep`, first a sweep of the micro-batches dividing 32
  (1 to 16) as text8's, whose choice line also names the largest
  micro-batch peaking under half the card (the DiMamba runs' rule).

With --trace-dir the Chrome traces are written there.
"""

import argparse
import contextlib
import functools
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = (   # first match wins; matched against the kernel's name
    # The library flash attention's kernels ('flash' route): the wgmma
    # (bf16, D = 64), mma.sync (bf16, D <= 48) and CUDA-core
    # instantiations of each.
    ('K20 flash attention fwd', ('fwd_wgmma(', 'fwd_mma<', 'fwd_core<')),
    ('K21 flash attention dK/dV and di', ('dkv_wgmma(', 'dkv_mma<',
                                          'dkv_core<')),
    ('K22 flash attention dQ', ('dq_wgmma(', 'dq_mma<', 'dq_core<')),
    # The attention kernels' RoPE flag is their template's `true`.
    # K1b and K2b share their two kernels, the query-tile one (dq) and the
    # key-tile one (dk, dv): the route says which runs (K1b on 'fused_rope'
    # and in LM1B training, K2b on 'short_seq'). K1b on the tensor cores
    # also rotates q and k before them and un-rotates dq and dk after.
    ('K1b RoPE passes', ('rope_rows_kernel',)),
    ('K1b/K2b attention bwd', ('attention_bwd_q_wgmma_kernel',
                               'attention_bwd_kv_wgmma_kernel',
                               'attention_bwd_q_kernel',
                               'attention_bwd_kv_kernel')),
    ('K1 attention (RoPE)', ('attention_wgmma_kernel<true',
                             'attention_kernel<__nv_bfloat16, true',
                             'attention_kernel<float, true')),
    ('K2 attention', ('attention_wgmma_kernel', 'attention_kernel')),
    ('K4/K6 adaln bwd', ('adaln_bwd',)),
    ('K3/K5 adaln fwd', ('ln_modulate_kernel', 'gate_res_kernel')),
    # cuDNN's convolutions (the UNet's), forward and both gradients.
    ('conv', ('fprop', 'dgrad', 'wgrad', 'cudnn', 'implicit_convolve',
              'winograd')),
    ('gemm', ('gemm', 'xmma', 'cutlass', 'nvjet', 'cublas', 'splitK')),
    ('optimizer/clip/EMA (foreach)', ('multi_tensor_apply',)),
    ('softmax/log-softmax', ('softmax',)),
    ('elementwise/reduce/other', ('',)),
)


def group_of(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return GROUPS[-1][0]


def head_gemm_ms(n_rows, hidden, vocab, reps=20):
    """Device ms of the head's float32 GEMMs for one micro-batch: logits =
    h W^T + b, then dh = dlogits W and dW = dlogits^T h."""
    h = torch.randn(n_rows, hidden, device='cuda')
    w = torch.randn(vocab, hidden, device='cuda')
    g = torch.randn(n_rows, vocab, device='cuda')
    out = []
    for fn in (lambda: h @ w.T, lambda: g @ w, lambda: g.T @ h):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def _text8_run(args):
    from ddg_tpu_torch.entry import text8_train_flagship
    return text8_train_flagship(device='cuda', route=args.route)


def _unet_run(args):
    from ddg_tpu_torch.entry import unet_train_flagship
    return unet_train_flagship(device='cuda')


def sweep_unet(args, micros=(32, 64, 128, 256, 512)):
    """The UNet run at each micro-batch dividing 512."""
    from ddg_tpu_torch import entry
    default = entry.UNET_TRAIN_MICRO_BATCH

    def build(micro):
        entry.UNET_TRAIN_MICRO_BATCH = micro
        return _unet_run(args)

    try:
        sweep('unet', args, build, micros, default)
    finally:
        entry.UNET_TRAIN_MICRO_BATCH = default


def _dimamba_run(args):
    from ddg_tpu_torch.entry import dimamba_train_flagship
    return dimamba_train_flagship(device='cuda', route=args.route)


def sweep_text8(args, micros=(16, 32, 64, 128, 256, 512)):
    """The text8 run at each micro-batch: ms/step, tokens/s, peak memory."""
    from ddg_tpu_torch import entry
    default = entry.TEXT8_TRAIN_MICRO_BATCH

    def build(micro):
        entry.TEXT8_TRAIN_MICRO_BATCH = micro
        return _text8_run(args)

    try:
        sweep('text8', args, build, micros, default)
    finally:
        entry.TEXT8_TRAIN_MICRO_BATCH = default


def sweep_dimamba(args, micros=(1, 2, 4, 8, 16)):
    """The Species10 run on `--route` at each micro-batch dividing 32."""
    from ddg_tpu_torch import entry
    name = ('DIMAMBA_TRAIN_MICRO_BATCH' if args.route == 'fused_block'
            else 'DIMAMBA_DTLR_TRAIN_MICRO_BATCH')
    default = getattr(entry, name)

    def build(micro):
        setattr(entry, name, micro)
        return _dimamba_run(args)

    try:
        sweep('dimamba', args, build, micros, default)
    finally:
        setattr(entry, name, default)


def sweep(model, args, build, micros, default):
    """`build(micro)`'s run at each micro-batch: one warm-up and
    `--steps` timed steps, ms/step, tokens/s and peak memory (or the
    out-of-memory error); then the fastest micro-batch and the largest
    whose step peaks under half the card."""
    half = torch.cuda.get_device_properties(0).total_memory / 2
    rows = []
    for micro in micros:
        rec = {'run': f'{model}_micro_batch_sweep', 'route': args.route,
               'micro_batch': micro}
        run = batch = None
        try:
            run = build(micro)
            batch = run.batch(torch.Generator(device='cuda').manual_seed(0))
            run.step(run.state, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                run.step(run.state, batch)
            torch.cuda.synchronize()
            secs = (time.perf_counter() - t0) / args.steps
            rec.update(ms_per_step=secs * 1e3,
                       tokens_per_s=run.global_batch * run.cfg.length / secs,
                       peak_memory_bytes=torch.cuda.max_memory_allocated())
        except torch.cuda.OutOfMemoryError as e:
            rec['error'] = f'out of memory: {str(e)[:120]}'
        run = batch = None
        torch.cuda.empty_cache()
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    fits = [r for r in rows if r.get('peak_memory_bytes', half) < half]
    best = min(fits, key=lambda r: r['ms_per_step']) if fits else None
    print(json.dumps({'run': f'{model}_micro_batch_choice',
                      'route': args.route, 'under_bytes': half,
                      'micro_batch': best and best['micro_batch'],
                      'largest_under_half': max(
                          (r['micro_batch'] for r in fits), default=None),
                      'entry_default': default}), flush=True)


def profile_dit(args, build=None):
    if build is None:
        from ddg_tpu_torch.entry import train_flagship
        run = train_flagship(device='cuda')
    else:
        run = build(args)
    batch = run.batch(torch.Generator(device='cuda').manual_seed(0))

    def step():
        run.step(run.state, batch)

    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'torch': torch.__version__,
                      'length': run.cfg.length,
                      'micro_batch': run.micro_batch,
                      'accum_steps': run.accum_steps}), flush=True)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            profiled_wall = (time.perf_counter() - t0) * 1e3
        path = os.path.join(trace_dir, 'train_step.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = [e for e in json.load(f)['traceEvents']
                       if e.get('cat') == 'kernel']
    if not kernels:
        raise RuntimeError('the profiler recorded no kernel on the card')
    by_group, count, by_name = {}, {}, {}
    for e in kernels:
        g = group_of(e['name'])
        by_group[g] = by_group.get(g, 0.0) + e['dur'] / 1e3
        count[g] = count.get(g, 0) + 1
        by_name[e['name'][:120]] = by_name.get(e['name'][:120], 0.0) + \
            e['dur'] / 1e3
    # Kernels of one stream do not overlap: their sum is the busy time.
    busy = sum(by_group.values())
    print(json.dumps({
        'run': 'train_step', 'wall_ms_per_step': wall,
        'device_busy_ms_per_step': busy,
        'idle_share': 1.0 - busy / wall,
        'device_ms_per_step': dict(sorted(by_group.items(),
                                          key=lambda kv: -kv[1])),
        'kernels_per_step': count,
        'top_kernels_ms': dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:15]),
        'profiled_wall_ms': profiled_wall}), flush=True)
    cfg = run.cfg
    if not hasattr(cfg, 'hidden_size'):         # the UNet has no vocab GEMM
        return
    fwd, bwd_dh, bwd_dw = head_gemm_ms(run.micro_batch * cfg.length,
                                       cfg.hidden_size, cfg.vocab_size)
    print(json.dumps({
        'run': 'head_gemms_fp32', 'rows': run.micro_batch * cfg.length,
        'ms_per_micro_step': {'forward': fwd, 'backward_dh': bwd_dh,
                              'backward_dw': bwd_dw},
        'ms_per_step': (fwd + bwd_dh + bwd_dw) * run.accum_steps}),
        flush=True)


# Profiler ranges of the DiMamba step, innermost first.
RANGES = ('K19', 'K18', 'K17', 'K16', 'K15', 'K14', 'forward', 'backward')


def _ranged(name, fn):
    @functools.wraps(fn)       # keeps a wrapper's `launches` counter
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


@contextlib.contextmanager
def _step_ranges():
    """Profiler ranges around the kernels' wrappers (looked up by name at
    call time), the loss's forward and the backward."""
    from ddg_tpu_torch.ops import mamba
    from ddg_tpu_torch.runtime import train_state
    patches = [(mamba, '_mamba_inner_fwd', 'K18'),
               (mamba, 'mamba_inner_bwd', 'K19'),
               (mamba, '_ssm_scan_fwd', 'K14'),
               (mamba, 'ssm_scan_bwd', 'K15'),
               (mamba, '_ssm_scan_dtlr_fwd', 'K16'),
               (mamba, 'ssm_scan_dtlr_bwd', 'K17'),
               (train_state, 'loss_fn', 'forward'),
               (torch.autograd, 'grad', 'backward')]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, name in patches:
        setattr(mod, attr, _ranged(name, getattr(mod, attr)))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            if hasattr(fn, 'launches'):
                fn.launches = getattr(mod, attr).launches
            setattr(mod, attr, fn)


def _short(name):
    name = name.replace('(anonymous namespace)::', '').replace('void ', '')
    return name.split('(')[0].split('<')[0].strip()


def profile_dimamba(args):
    run = _dimamba_run(args)
    batch = run.batch(torch.Generator(device='cuda').manual_seed(0))

    def step():
        run.step(run.state, batch)

    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'model': 'dimamba', 'route': args.route,
                      'micro_batch': run.micro_batch,
                      'accum_steps': run.accum_steps}), flush=True)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        with _step_ranges(), torch.profiler.profile(activities=acts) as prof:
            step()
            torch.cuda.synchronize()
        path = os.path.join(trace_dir, 'dimamba_train_step.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel']
    if not kernels:
        raise RuntimeError('the profiler recorded no kernel on the card')
    spans = {r: [(e['ts'], e['ts'] + e['dur']) for e in events
                 if e.get('cat') == 'gpu_user_annotation'
                 and e.get('name') == r] for r in RANGES}
    core = 'K19' if args.route == 'fused_block' else 'K17'
    if not spans[core]:
        raise RuntimeError(f'the trace holds no device span of the {core} '
                           'range')

    def range_of(e):
        t = e['ts'] + e['dur'] / 2
        for r in RANGES:
            if any(a <= t <= b for a, b in spans[r]):
                return r
        return None

    by_group, by_name = {}, {}
    for e in kernels:
        r = range_of(e)
        if r == 'K19':
            g = f'K19 {_short(e["name"])}'
        elif r in ('K18', 'K17', 'K16', 'K15', 'K14'):
            g = r
        elif 'multi_tensor_apply' in e['name']:
            g = 'optimizer/clip/EMA (foreach)'
        elif r in ('forward', 'backward'):
            g = f'trunk {r}'
        elif not spans['backward']:
            # The backward's kernels are launched by autograd's own thread,
            # whose work may carry no device span of the range.
            g = 'trunk backward and other (outside the ranges)'
        else:
            g = 'other'
        by_group[g] = by_group.get(g, 0.0) + e['dur'] / 1e3
        by_name[e['name'][:120]] = by_name.get(e['name'][:120], 0.0) + \
            e['dur'] / 1e3
    busy = sum(by_group.values())
    k19 = sum(v for k, v in by_group.items() if k.startswith('K19'))
    print(json.dumps({
        'run': 'dimamba_train_step', 'wall_ms_per_step': wall,
        'device_busy_ms_per_step': busy, 'idle_share': 1.0 - busy / wall,
        'K19_ms_per_step': k19,
        'device_ms_per_step': dict(sorted(by_group.items(),
                                          key=lambda kv: -kv[1])),
        'top_kernels_ms': dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:15])}),
        flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--model', choices=('dit', 'dimamba', 'text8', 'unet',
                                        'both'),
                    default='both',
                    help='which training run (default both: dit, dimamba)')
    ap.add_argument('--route', default=None,
                    choices=('fused_rope', 'short_seq', 'flash',
                             'fused_block', 'dt_lowrank'),
                    help="text8's attention route (default fused_rope) or "
                         "the DiMamba's mixer route (default fused_block)")
    ap.add_argument('--sweep', action='store_true',
                    help='text8, dimamba, unet: sweep the micro-batch first')
    ap.add_argument('--steps', type=int, default=2,
                    help='unprofiled steps to time (default 2)')
    ap.add_argument('--trace-dir', default=None,
                    help='write the Chrome traces here')
    args = ap.parse_args()
    if args.route is None:
        args.route = 'fused_rope' if args.model == 'text8' else 'fused_block'
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.model in ('dit', 'both'):
        profile_dit(args)
        torch.cuda.empty_cache()
    if args.model in ('dimamba', 'both'):
        if args.sweep and args.model == 'dimamba':
            sweep_dimamba(args)
        profile_dimamba(args)
    if args.model == 'text8':
        if args.sweep:
            sweep_text8(args)
        profile_dit(args, build=_text8_run)
    if args.model == 'unet':
        if args.sweep:
            sweep_unet(args)
        profile_dit(args, build=_unet_run)
    return 0


if __name__ == '__main__':
    sys.exit(main())
