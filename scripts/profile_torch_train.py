#!/usr/bin/env python3
"""Where the time of `ddg_tpu_torch`'s training step goes on one CUDA card.

    python3 scripts/profile_torch_train.py [--steps 2] [--trace-dir DIR]

Builds the training flagship (`entry.train_flagship`: LM1B DiT-small MDLM,
seeded random weights, global batch 512 x 128 tokens as micro-batches,
the Hopper kernels on), warms it up, times `--steps` steps unprofiled and
one step under `torch.profiler`. Prints one JSON line with wall ms per
step, device-busy ms per step, the card's idle share, device ms per step
by kernel group (from the trace's kernel events) and the largest kernels
by name. A second line times the vocab head's three float32 GEMMs (the
forward and the two of the backward) alone at the micro-batch's shape
with CUDA events, times the micro-steps of a step: the head's share of
the GEMM time. With --trace-dir the Chrome trace is written there.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = (   # first match wins; matched against the kernel's name
    ('K1b rope_attention_bwd', ('rope_attention_bwd',)),
    ('K1 rope_attention', ('rope_attention',)),
    ('K4/K6 adaln bwd', ('adaln_bwd',)),
    ('K3/K5 adaln fwd', ('adaln_kernel',)),
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=2,
                    help='unprofiled steps to time (default 2)')
    ap.add_argument('--trace-dir', default=None,
                    help='write the Chrome trace here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddg_tpu_torch.entry import train_flagship
    run = train_flagship(device='cuda')
    batch = run.batch(torch.Generator(device='cuda').manual_seed(0))

    def step():
        run.step(run.state, batch)

    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'torch': torch.__version__,
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
    fwd, bwd_dh, bwd_dw = head_gemm_ms(run.micro_batch * cfg.length,
                                       cfg.hidden_size, cfg.vocab_size)
    print(json.dumps({
        'run': 'head_gemms_fp32', 'rows': run.micro_batch * cfg.length,
        'ms_per_micro_step': {'forward': fwd, 'backward_dh': bwd_dh,
                              'backward_dw': bwd_dw},
        'ms_per_step': (fwd + bwd_dh + bwd_dw) * run.accum_steps}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
