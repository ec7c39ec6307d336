#!/usr/bin/env python3
"""The adaLN kernels of `csrc/adaln.cu` on one card: a first-call check,
and a same-call A/B against another copy of the source. By default the
backwards (K4 `ln_modulate_bwd`, K6 `gate_res_ln_modulate_bwd`); with
`--fwd` the forwards (K3 `ln_modulate`, K5 `gate_res_ln_modulate`).

    python3 scripts/ab_torch_adaln.py --check [--fwd]
    python3 scripts/ab_torch_adaln.py [--fwd] --parent-source build/ab/adaln.cu [--rounds 2]

`--check` builds the kernels, prints ptxas's lines for `adaln.cu`
(registers, spills and shared memory under the line that names each
kernel) and runs `chip_smoke.check_adaln_bwd`: K4 and K6 against their
plain versions at the LM1B and text8 training micro-batches and
`chip_smoke.ADALN_BWD_SHAPES`, reruns bit-identical, the launch-plan
mirror, and the bf16 times beside the bound, the plain version and the
composite of library calls, with the split between the rows kernel and
the sums after it. With `--fwd` it runs `chip_smoke.check_adaln` instead:
K3 and K5 against their plain versions at the serving shape and the
training micro-batches, K3 at `chip_smoke.ADALN_FWD_SHAPES` with reruns
bit-identical and its launch plan against csrc's, bf16 times beside the
bound. One JSON line; it exits non-zero if a check failed.

With `--parent-source` (an earlier `adaln.cu`, e.g. `git show
HEAD:ddg_tpu_torch/csrc/adaln.cu > build/ab/adaln.cu`; headers are looked
up beside it first, then in `csrc/`) it builds that copy with nvcc into
`build/ab/` under another library name and times the parent's kernels,
the new ones, the new ones, the parent's (A B B A, `--rounds` times) with
CUDA events (`chip_smoke.time_ms`), bf16 at 256 x 128 x 768 (LM1B) and
256 x 256 x 768 (text8): one JSON line per arm and one summary line per
(kernel, shape) with the largest difference between the arms' outputs
and each arm's error against the plain version, beside nvidia-smi's name
and power limit. Both arms are called through ctypes on the same inputs.
The backwards' summary adds each arm's split by kernel (torch.profiler);
the backwards' parent is the design of 16 rows a block (one block per (b,
16-row tile), a (3, B, tiles, D) fp32 workspace, no conditioning groups):
its call passes 16-row tiles and no group count. The forwards' arms share
one C interface; K5's must be bit-identical where the parent's K5 is the
same design. The forwards run at 48 x 128 x 768 (the LM1B serving trunk)
too. The last line lists the profiler traces `chip_smoke.kernel_trace`
took again (`trace_retakes`).
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
# The forwards also at the LM1B serving trunk's 48 x 128 (CFG doubles 24).
FWD_SHAPES = {'lm1b_sampling_48x128': (48, 128, 768), **SHAPES}
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


def run_check_fwd():
    from ddg_tpu_torch.ops import _build
    cs.DEV = 'cuda'
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['adaln'][1])}),
          flush=True)
    results = {'ln_modulate': {}, 'gate_res_ln_modulate': {}}
    try:
        cs.check_adaln(results)
        ok = True
    except Exception as e:  # report, then fail
        ok = False
        results['error'] = repr(e)[:800]
    print(json.dumps({'ok': ok, 'results': results,
                      'nvidia_smi': cs.nvidia_smi()}), flush=True)
    return 0 if ok else 1


FWD_FNS = {'K3': 'ddg_ln_modulate', 'K5': 'ddg_gate_res_ln_modulate'}


def _fwd_call(fn, kernel, ins, outs):
    """One call of a K3 or K5 entry point of either version; returns h, or
    (x', h)."""
    from ddg_tpu_torch.ops import _build
    x, y, gate, w, shift, scale = ins
    B, L, D = x.shape
    tail = (B * L, L, D, scale.stride(0), 1, _build.stream(x))
    if kernel == 'K3':
        rc = fn(x.data_ptr(), w.data_ptr(), shift.data_ptr(),
                scale.data_ptr(), outs[0].data_ptr(), *tail)
        _build.check(rc, FWD_FNS[kernel])
        return outs[0]
    rc = fn(y.data_ptr(), x.data_ptr(), gate.data_ptr(), w.data_ptr(),
            shift.data_ptr(), scale.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), *tail)
    _build.check(rc, FWD_FNS[kernel])
    return outs[0], outs[1]


def run_ab_fwd(arms, rounds):
    """K3 and K5 of each library in `arms` ({name: library}, the first the
    reference) in turns, A B ... then back; see the module docstring.
    Returns 1 if a check failed."""
    from ddg_tpu_torch.ops import adaln
    smi = cs.nvidia_smi()
    gen = torch.Generator(device='cuda').manual_seed(20)
    order = list(arms)
    failed = 0
    for label, (B, L, D) in FWD_SHAPES.items():
        x = cs._rand(gen, B, L, D, dtype=torch.bfloat16)
        y = cs._rand(gen, B, L, D, dtype=torch.bfloat16)
        mod = cs._rand(gen, B, 6 * D, scale=0.5, dtype=torch.bfloat16)
        ins = (x, y, mod[:, 2 * D:3 * D], 1.0 + cs._rand(gen, D, scale=0.1),
               mod[:, :D], mod[:, D:2 * D])
        for kernel, name in FWD_FNS.items():
            n_out = 1 if kernel == 'K3' else 2
            fns, outs = {}, {}
            for arm, lib in arms.items():
                fn = getattr(lib, name)
                fn.argtypes = ([ctypes.c_void_p] * (4 + n_out + (
                    0 if kernel == 'K3' else 2)) + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                fns[arm] = fn
                outs[arm] = [torch.empty_like(x) for _ in range(n_out)]

            def call(arm):
                out = _fwd_call(fns[arm], kernel, ins, outs[arm])
                return out if isinstance(out, tuple) else (out,)
            got = {arm: tuple(t.clone() for t in call(arm)) for arm in order}
            ref = (adaln.ln_modulate_plain(x, ins[3], ins[4], ins[5])
                   if kernel == 'K3' else
                   adaln.gate_res_ln_modulate_plain(y, x, *ins[2:]))
            ref = ref if isinstance(ref, tuple) else (ref,)
            rec = {'kernel': kernel, 'shape': label, 'dims': [B, L, D],
                   'nvidia_smi': smi, 'vs_plain': {}, 'vs_first_arm': {}}
            try:
                for arm, out in got.items():
                    cs.check(all(torch.equal(a, b) for a, b in
                                 zip(out, call(arm))),
                             f'{kernel} {arm}: a rerun differs')
                    rec['vs_plain'][arm] = max(cs._close(
                        f'{kernel} {arm} {label} out {i}', torch.bfloat16,
                        o, r)[0] for i, (o, r) in enumerate(zip(out, ref)))
                    rec['vs_first_arm'][arm] = {
                        'bit_equal': all(torch.equal(a, b) for a, b in
                                         zip(out, got[order[0]])),
                        'max_abs_diff': max(
                            (a.float() - b.float()).abs().max().item()
                            for a, b in zip(out, got[order[0]])),
                        'share_differing': max(
                            (a != b).float().mean().item()
                            for a, b in zip(out, got[order[0]]))}
                    if kernel == 'K5':
                        cs.check(rec['vs_first_arm'][arm]['bit_equal'],
                                 f'K5 {arm}: not bit-equal to {order[0]}')
            except Exception as e:  # report, then fail
                rec['error'] = repr(e)[:400]
                failed += 1
            times = {arm: [] for arm in order}
            for r in range(rounds):
                for arm in order + order[::-1]:
                    ms = cs.time_ms(lambda: call(arm))
                    times[arm].append(ms)
                    print(json.dumps({'kernel': kernel, 'shape': label,
                                      'arm': arm, 'round': r, 'ms': ms,
                                      'nvidia_smi': smi}), flush=True)
            es = 2
            nbytes = ((2 if kernel == 'K3' else 4) * B * L * D * es + 4 * D
                      + (2 if kernel == 'K3' else 3) * B * D * es)
            rec['bound_ms'], rec['bound_by'] = cs.bound(
                nbytes, (8 if kernel == 'K3' else 10) * B * L * D,
                cs.PEAK_FP32)
            rec['ms'] = {arm: sum(t) / len(t) for arm, t in times.items()}
            rec['times'] = times
            print(json.dumps(rec), flush=True)
        del ins, x, y, mod
    return 1 if failed else 0


def run_fwd(parent_source, rounds):
    """The forwards' A/B: the parent against this tree."""
    from ddg_tpu_torch.ops import _build
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['adaln'][1])}),
          flush=True)
    new = ctypes.CDLL(str(libs['adaln'][0]))
    parent, log = build_parent(parent_source)
    print(json.dumps({'parent_ptxas': cs.ptxas_lines(log)}), flush=True)
    return run_ab_fwd({'parent': parent, 'new': new}, rounds)


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


def _report_retakes():
    """The profiler traces `chip_smoke.kernel_trace` took again (C.9)."""
    print(json.dumps({'trace_retakes': cs.TRACE_RETAKES}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--parent-source')
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--fwd', action='store_true',
                    help='the forwards, K3 and K5, instead of K4 and K6')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    if args.check:
        return run_check_fwd() if args.fwd else run_check()
    if not args.parent_source or not os.path.exists(args.parent_source):
        ap.error('--parent-source names no file')
    if args.fwd:
        return run_fwd(args.parent_source, args.rounds)
    return run_ab(args.parent_source, args.rounds)


if __name__ == '__main__':
    rc = main()
    _report_retakes()
    sys.exit(rc)
