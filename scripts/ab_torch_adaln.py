#!/usr/bin/env python3
"""The adaLN backward kernels of `csrc/adaln.cu` (K4 `ln_modulate_bwd`, K6
`gate_res_ln_modulate_bwd`) on one card: a first-call check, and a
same-call A/B against another copy of the source.

    python3 scripts/ab_torch_adaln.py --check
    python3 scripts/ab_torch_adaln.py --parent-source build/ab/adaln.cu [--rounds 2]

`--check` builds the kernels, prints ptxas's lines for `adaln.cu`
(registers, spills and shared memory under the line that names each
kernel) and runs `chip_smoke.check_adaln_bwd`: K4 and K6 against their
plain versions at the LM1B and text8 training micro-batches and
`chip_smoke.ADALN_BWD_SHAPES`, reruns bit-identical, the launch-plan
mirror, and the bf16 times beside the bound, the plain version and the
composite of library calls, with the split between the rows kernel and
the sums after it. One JSON line; it exits non-zero if a check failed.

With `--parent-source` (an earlier `adaln.cu`, e.g. `git show
HEAD:ddg_tpu_torch/csrc/adaln.cu > build/ab/adaln.cu`; headers are looked
up beside it first, then in `csrc/`) it builds that copy with nvcc into
`build/ab/` under another library name and times the parent's K4 and K6,
the new ones, the new ones, the parent's (A B B A, `--rounds` times) with
CUDA events (`chip_smoke.time_ms`), bf16 at 256 x 128 x 768 (LM1B) and
256 x 256 x 768 (text8): one JSON line per arm and one summary line per
(kernel, shape) with each arm's split by kernel (torch.profiler), the
largest difference between the arms' outputs and each arm's error against
the plain version, beside nvidia-smi's name and power limit. Both arms are
called through ctypes on the same inputs. The parent is the design of 16
rows a block (one block per (b, 16-row tile), a (3, B, tiles, D) fp32
workspace, no conditioning groups): its call passes 16-row tiles and no
group count.
"""

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
sys.path.insert(0, str(ROOT / 'scripts'))
from ab_torch_attention import build_parent  # noqa: E402

SHAPES = {'lm1b_256x128': (256, 128, 768), 'text8_256x256': (256, 256, 768)}
PARENT_ROWS = 16
FNS = {'K4': 'ddg_ln_modulate_bwd', 'K6': 'ddg_gate_res_ln_modulate_bwd'}


def run_check():
    from ddg_tpu_torch.ops import _build
    cs.DEV = 'cuda'
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['adaln'][1])}),
          flush=True)
    results = {'ln_modulate_bwd': {}, 'gate_res_ln_modulate_bwd': {}}
    try:
        cs.check_adaln_bwd(results)
        ok = True
    except Exception as e:  # report, then fail
        ok = False
        results['error'] = repr(e)[:800]
    print(json.dumps({'ok': ok, 'results': results,
                      'nvidia_smi': cs.nvidia_smi()}), flush=True)
    return 0 if ok else 1


def _outputs(kernel, x):
    B, L, D = x.shape
    rows = [torch.empty_like(x) for _ in range(1 if kernel == 'K4' else 2)]
    conds = [torch.empty((B, D), dtype=x.dtype, device=x.device)
             for _ in range(2 if kernel == 'K4' else 3)]
    dw = torch.empty((D,), dtype=torch.float32, device=x.device)
    return rows, conds, dw


def _call(fn, kernel, ins, outs, parent):
    """One call of a K4 or K6 entry point of either version; returns the
    wrapper's tuple of outputs."""
    from ddg_tpu_torch.ops import _build
    x, y, gate, w, scale, dx, dh = ins
    B, L, D = x.shape
    rows, conds, dw, ws = outs
    cstride = scale.stride(0)
    if parent:
        grid = (-(-L // PARENT_ROWS),)
    else:
        from ddg_tpu_torch.ops import adaln
        plan = adaln.bwd_plan(B, L, D, x.element_size(), kernel == 'K6')
        grid = (plan['tiles'], plan['groups'])
    tail = (B, L, D, cstride, *grid, 1, _build.stream(x))
    if kernel == 'K4':
        dshift, dscale = conds
        rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), dh.data_ptr(),
                rows[0].data_ptr(), dw.data_ptr(), dshift.data_ptr(),
                dscale.data_ptr(), ws.data_ptr(), *tail)
        _build.check(rc, FNS[kernel])
        return rows[0], dw, dshift, dscale
    dgate, dshift, dscale = conds
    dy, dskip = rows
    rc = fn(x.data_ptr(), y.data_ptr(), gate.data_ptr(), w.data_ptr(),
            scale.data_ptr(), dx.data_ptr(), dh.data_ptr(), dy.data_ptr(),
            dskip.data_ptr(), dgate.data_ptr(), dw.data_ptr(),
            dshift.data_ptr(), dscale.data_ptr(), ws.data_ptr(), *tail)
    _build.check(rc, FNS[kernel])
    return dy, dskip, dgate, dw, dshift, dscale


def _argtypes(kernel, parent):
    from ddg_tpu_torch.ops import _build
    n_ptr = 9 if kernel == 'K4' else 14
    return (_build.ptr,) * n_ptr + (_build.i32,) * (6 if parent else 7) + (
        _build.ptr,)


def run_ab(parent_source, rounds):
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import adaln
    parent, log = build_parent(parent_source)
    print(json.dumps({'parent_ptxas': cs.ptxas_lines(log)}), flush=True)
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['adaln'][1])}),
          flush=True)
    smi = cs.nvidia_smi()
    gen = torch.Generator(device='cuda').manual_seed(16)
    failed = 0
    for label, (B, L, D) in SHAPES.items():
        ins = cs._adaln_bwd_inputs(gen, B, L, D, torch.bfloat16)
        x = ins[0]
        for kernel in FNS:
            res = kernel == 'K6'
            fns, outs = {}, {}
            for arm in ('parent', 'new'):
                fn = (getattr(parent, FNS[kernel]) if arm == 'parent' else
                      _build.kernel('adaln', FNS[kernel],
                                    _argtypes(kernel, False)))
                fn.argtypes = list(_argtypes(kernel, arm == 'parent'))
                fn.restype = ctypes.c_int
                fns[arm] = fn
                n_ws = (3 * B * -(-L // PARENT_ROWS) * D if arm == 'parent'
                        else adaln.bwd_plan(B, L, D, 2, res)['workspace'])
                outs[arm] = (*_outputs(kernel, x), torch.empty(
                    (n_ws,), dtype=torch.float32, device='cuda'))
            got = {arm: tuple(t.clone() for t in _call(
                fns[arm], kernel, ins, outs[arm], arm == 'parent'))
                for arm in fns}
            torch.cuda.synchronize()
            ref = (adaln.ln_modulate_bwd_plain(x, ins[3], ins[4], ins[6])
                   if kernel == 'K4' else
                   adaln.gate_res_ln_modulate_bwd_plain(*ins))
            err = {}
            for arm, out in got.items():
                try:
                    rec = cs._adaln_bwd_hold(f'{kernel} {arm} {label}',
                                             torch.bfloat16, out,
                                             _call(fns[arm], kernel, ins,
                                                   outs[arm],
                                                   arm == 'parent'),
                                             ref, 2 if res else 1)
                    err[arm] = {'err': rec['err'], 'sum_err': rec['sum_err']}
                except Exception as e:  # report, then fail
                    err[arm] = {'error': repr(e)[:400]}
                    failed += 1
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got['new'], got['parent']))
            times = {'parent': [], 'new': []}
            for r in range(rounds):
                for arm in ('parent', 'new', 'new', 'parent'):
                    ms = cs.time_ms(lambda: _call(
                        fns[arm], kernel, ins, outs[arm], arm == 'parent'))
                    times[arm].append(ms)
                    print(json.dumps({'kernel': kernel, 'shape': label,
                                      'arm': arm, 'round': r, 'ms': ms,
                                      'nvidia_smi': smi}), flush=True)
            split = {arm: cs.kernel_ms(lambda: _call(
                fns[arm], kernel, ins, outs[arm], arm == 'parent'))
                for arm in fns}
            mean = {arm: sum(t) / len(t) for arm, t in times.items()}
            bound, by = cs.adaln_bwd_bound(B, L, D, 2 if res else 1, 2)
            print(json.dumps({
                'kernel': kernel, 'shape': label, 'dims': [B, L, D],
                'parent_ms': mean['parent'], 'new_ms': mean['new'],
                'times': times, 'speedup': mean['parent'] / mean['new'],
                'bound_ms': bound, 'bound_by': by, 'split_ms': split,
                'vs_plain': err, 'max_abs_diff_new_vs_parent': diff,
                'nvidia_smi': smi}), flush=True)
        del ins, x
    return 1 if failed else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--parent-source')
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    if args.check:
        return run_check()
    if not args.parent_source or not os.path.exists(args.parent_source):
        ap.error('--parent-source names no file')
    return run_ab(args.parent_source, args.rounds)


if __name__ == '__main__':
    sys.exit(main())
