#!/usr/bin/env python3
"""The attention kernels of `csrc/rope_attention.cu` (K1/K2 forward) and
`csrc/rope_attention_bwd.cu` (K1b/K2b backward) on one card: a first-call
check, and a same-call A/B against another copy of the source.

    python3 scripts/ab_torch_attention.py --check [--bwd]
    python3 scripts/ab_torch_attention.py --parent-source build/ab/rope_attention.cu
    python3 scripts/ab_torch_attention.py --bwd --parent-source build/ab/rope_attention_bwd.cu
    python3 scripts/ab_torch_attention.py --flash [--check]
    python3 scripts/ab_torch_attention.py --flash --parent-source build/ab/flash_attention.cu

`--check` builds the kernels and prints ptxas's lines for
`rope_attention.cu` (registers, spills and shared memory under the line
that names each kernel), then runs K1 and K2 once at 48 x 128 x 12 x 64
(LM1B sampling), 256 x 256 (text8 training), 4 x 40 x 3 (a ragged tile)
and 4 x 1024 x 12 (the reference DiT-small), fp32 and bf16, causal and
not, against their plain versions with `chip_smoke.py`'s bars (fp32 1e-4
abs, bf16 2 ulp of the largest magnitude), plus a probe with V = I at
L = 64, where O is P itself, and `chip_smoke.py`'s launch-plan mirror. One
JSON line a case; it exits non-zero if any failed. Use it as the first call
on the card after changing a forward kernel. `--check --bwd` does the same
for the backward kernels (ptxas lines of `rope_attention_bwd.cu`; K1b and
K2b at those shapes, at L = 64 and 200 and at D = 32, each run twice with
bit-identical outputs, the share of bf16 outputs that differ from the
plain version at all, the tensor cores at bf16 D = 64) and for both plan
mirrors.

Otherwise it builds `--parent-source` (a copy of an earlier
`rope_attention.cu`, e.g. `git show HEAD:ddg_tpu_torch/csrc/rope_attention.cu
> build/ab/rope_attention.cu`, or with `--bwd` of `rope_attention_bwd.cu`;
headers are looked up beside it first, then in `csrc/`) with nvcc into
`build/ab/` under another library name, and times the parent's kernel, the
new one, the new one, the parent's (A B B A) and SDPA (with `--bwd`: its
backward, autograd through SDPA minus its forward) with CUDA events
(`chip_smoke.time_ms`), at 48 x 128, 256 x 128 and 256 x 256, K1 and K2
(K1b and K2b), bf16, not causal: one JSON line per arm and one summary line
per (kernel, shape) beside nvidia-smi's name and power limit. Both arms are
called through the same ctypes code; their outputs are compared with each
other and (backward) each with the plain version (`differs_from_plain`,
the share of elements that differ at all). The backward's parent is the
single-launch `mma.sync` kernel, whose C interface has no head dim and no
workspace; the call adapts to it.

`--flash` holds the library flash attention's kernels (K20 forward, K21
dK/dV and di, K22 dQ; `csrc/flash_attention.cu`) against their plain
versions at `chip_smoke.FLASH_SHAPES` with `chip_smoke.check_flash_attention`
and `check_flash_plan` and times them at the main shapes beside the plain
versions, SDPA (K21, K22: SDPA's backward) and the bound; `--check
--flash` skips the timing (the first call on the card after editing the
source); `--flash --parent-source <an earlier flash_attention.cu>` times
that copy's K20-K22 against the current ones (A B B A, bf16 at 48 x 128,
256 x 256 and 4 x 1024; a parent whose K21 takes di is timed with
`output_grad_dot`) and reports the share of each output that differs
between the versions and from the plain version; each kernel must match
bit for bit where both versions take the same path.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPES = {'48x128': (48, 128, 12, 64), '256x128': (256, 128, 12, 64),
          '256x256': (256, 256, 12, 64)}
CHECK_SHAPES = ((48, 128, 12, 64), (256, 256, 12, 64), (4, 40, 3, 64),
                (4, 1024, 12, 64))
NAMES = {'K1': 'ddg_rope_attention', 'K2': 'ddg_short_seq_attention',
         'K1b': 'ddg_rope_attention_bwd', 'K2b': 'ddg_short_seq_attention_bwd'}
# The backward check also covers one key tile, a ragged last tile and D=32
# (the CUDA-core kernels).
BWD_CHECK_SHAPES = CHECK_SHAPES + ((2, 64, 3, 64), (2, 200, 3, 64),
                                   (4, 40, 2, 32))


def argtypes(kernel, parent=False):
    """The C entry point's arguments: the forward's, the backward's, or
    (`parent` backward) the single-launch kernel's, which took no head dim
    and no workspace."""
    from ddg_tpu_torch.ops import _build
    tables = 2 if kernel.startswith('K1') else 0
    if kernel in ('K1', 'K2'):
        ptrs, ints = 4, 8
    elif parent:
        ptrs, ints = 7, 7
    else:   # the workspaces: statistics, and K1b's rotated q and k
        ptrs, ints = 8 + (kernel == 'K1b'), 8
    return ((_build.ptr,) * (ptrs + tables) + (_build.i32,) * ints
            + (_build.f32, _build.i32, _build.ptr, _build.i32p))


def bwd_inputs(shape, gen):
    """K1b's (q, k, v views into one qkv projection, cos, sin, dO) and
    K2b's (rotated contiguous q, k, the view of v, dO), with their plain
    backwards; SDPA's heads-major q, k, v; dO."""
    from ddg_tpu_torch.ops import attention as A
    per_kernel, sdpa = inputs(shape, gen)
    do = torch.randn(shape, generator=gen, device='cuda').to(torch.bfloat16)
    q, k, v, cos, sin = per_kernel['K1']
    qr, kr, _ = per_kernel['K2']
    return {'K1b': ((q, k, v, cos, sin, do),
                    lambda: A.fused_rope_attention_bwd_plain(q, k, v, cos, sin,
                                                             do)),
            'K2b': ((qr, kr, v, do),
                    lambda: A.short_seq_attention_bwd_plain(qr, kr, v, do))
            }, sdpa, do


def bwd_call(fn, tensors, outs, ws, parent):
    """One call of a backward entry point (either library's) into `outs`
    (dq, dk, dv); `ws` are the new interface's workspaces (the statistics,
    and K1b's rotated q and k)."""
    from ddg_tpu_torch.ops import _build
    q = tensors[0]
    Bq, Lq, Hq, Dq = q.shape
    path = ctypes.c_int(-1)
    dims = (Bq, Lq, Hq) if parent else (Bq, Lq, Hq, Dq)
    ws = () if parent else tuple(w.data_ptr() for w in ws)
    rc = fn(*(t.data_ptr() for t in tensors), *(o.data_ptr() for o in outs),
            *ws, *dims, *(t.stride(1) for t in tensors[:3]), 0,
            1.0 / Dq ** 0.5, 1, _build.stream(q), ctypes.byref(path))
    _build.check(rc, 'attention backward')
    return path.value


def inputs(shape, gen):
    """K1's q, k, v as views into one qkv projection with its rope tables;
    K2's rotated contiguous q and k beside the view of v (the DiT's two
    routes); and SDPA's heads-major q, k, v."""
    from ddg_tpu_torch.models.dit import rope_cos_sin
    from ddg_tpu_torch.ops import attention as A
    Bq, Lq, Hq, Dq = shape
    qkv = torch.randn((Bq, Lq, 3, Hq, Dq), generator=gen,
                      device='cuda').to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    cos, sin = rope_cos_sin(Lq, Dq, device='cuda')
    qr, kr = A.apply_rope(q, cos, sin), A.apply_rope(k, cos, sin)
    sdpa = tuple(t.transpose(1, 2).contiguous() for t in (qr, kr, v))
    return {'K1': (q, k, v, cos, sin), 'K2': (qr, kr, v)}, sdpa


def call(fn, kernel, tensors, out):
    """One launch of `fn` (either library's entry point) into `out`."""
    from ddg_tpu_torch.ops import _build
    q = tensors[0]
    Bq, Lq, Hq, Dq = q.shape
    path = ctypes.c_int(-1)
    rc = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), Bq, Lq, Hq, Dq,
            *(t.stride(1) for t in tensors[:3]), 0, 1.0 / Dq ** 0.5, 1,
            _build.stream(q), ctypes.byref(path))
    _build.check(rc, NAMES[kernel])
    return path.value


def build_parent(src):
    from ddg_tpu_torch.ops import _build
    out_dir = ROOT / 'build' / 'ab'
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f'libparent_{Path(src).stem}.so'
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-I', str(Path(src).parent),
         '-I', str(_build.CSRC), '-o', str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed on {src}:\n{proc.stdout}'
                           f'{proc.stderr}')
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def build_variants(source, patches):
    """Copies of `csrc/<source>` under `build/variants/`, each with its
    (old, new) text patches (each old text must occur once), built in
    parallel by `build_parent`: {name: (library, nvcc log)}. The copies
    include this tree's csrc/ headers."""
    from concurrent.futures import ThreadPoolExecutor
    from ddg_tpu_torch.ops import _build
    text0 = (_build.CSRC / source).read_text()
    out_dir = ROOT / 'build' / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, pairs in patches.items():
        text = text0
        for old, new in pairs:
            cs.check(text.count(old) == 1,
                     f'{name}: the patched text occurs {text.count(old)} '
                     'times, not once')
            text = text.replace(old, new)
        paths[name] = out_dir / f'{Path(source).stem}_{name}.cu'
        paths[name].write_text(text)
    with ThreadPoolExecutor(len(paths)) as pool:
        return dict(zip(paths, pool.map(build_parent, paths.values())))


def run_check():
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import attention as A
    cs.DEV = 'cuda'
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['rope_attention'][1])}),
          flush=True)
    gen = torch.Generator(device='cuda').manual_seed(4)
    failed = 0
    for shape in CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases, _, _ = cs._attention_cases(shape, dtype, gen)
            for name in ('fused_rope_attention', 'short_seq_attention'):
                kern, plain = cases[name]
                wrapper = getattr(A, name)
                for causal in (False, True):
                    rec = {'case': name, 'shape': list(shape),
                           'dtype': str(dtype), 'causal': causal}
                    tc = wrapper.tensor_core_launches
                    try:
                        out = kern(causal)
                        torch.cuda.synchronize()
                        ref = plain(causal)
                        rec['err'] = (out.float() - ref.float()).abs().max(
                        ).item()
                        rec['tensor_cores'] = wrapper.tensor_core_launches > tc
                        rec['differs_from_plain'] = (out != ref).float(
                        ).mean().item()
                        cs._close(name, dtype, out, ref)
                        rec['ok'] = True
                    except Exception as e:  # report every case, then fail
                        rec['ok'], rec['error'] = False, repr(e)[:400]
                        failed += 1
                    print(json.dumps(rec), flush=True)
    # V = I at L = 64: O = P V is P itself, rounded to bf16.
    Lp = 64
    q, k = (torch.randn((1, Lp, 1, 64), generator=gen, device='cuda')
            .to(torch.bfloat16) for _ in range(2))
    v = torch.eye(Lp, device='cuda', dtype=torch.bfloat16)[None, :, None]
    p = torch.softmax(A._masked_scores(q.float(), k.float(), False),
                      -1).to(torch.bfloat16)[0, 0]
    o = A.short_seq_attention(q, k, v)[0, :, 0]
    rec = {'case': 'probe V=I', 'err_vs_P': (o.float() - p.float()).abs()
           .max().item(), 'err_vs_P_transposed': (o.float() - p.float().t())
           .abs().max().item(), 'max_P': p.float().max().item()}
    rec['ok'] = rec['err_vs_P'] <= cs.bf16_tol(p)
    failed += not rec['ok']
    print(json.dumps(rec), flush=True)
    try:
        cs.check_attention_plan(CHECK_SHAPES)
    except Exception as e:
        failed += 1
        print(json.dumps({'case': 'plan mirror', 'ok': False,
                          'error': repr(e)[:400]}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 1 if failed else 0


def run_check_bwd():
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import attention as A
    cs.DEV = 'cuda'
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(
        libs['rope_attention_bwd'][1])}), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(5)
    failed = 0
    for shape in BWD_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            cases, _, _ = cs._attention_cases(shape, dtype, gen)
            for name in ('fused_rope_attention_bwd',
                         'short_seq_attention_bwd'):
                kern, plain = cases[name]
                wrapper = getattr(A, name)
                for causal in (False, True):
                    rec = {'case': name, 'shape': list(shape),
                           'dtype': str(dtype), 'causal': causal}
                    tc = wrapper.tensor_core_launches
                    try:
                        got, again = kern(causal), kern(causal)
                        torch.cuda.synchronize()
                        rec['tensor_cores'] = wrapper.tensor_core_launches > tc
                        rec['bit_identical_rerun'] = all(
                            torch.equal(a, b) for a, b in zip(got, again))
                        ref = plain(causal)
                        rec['err'], rec['differs_from_plain'] = {}, {}
                        for out, a, r in zip(('dq', 'dk', 'dv'), got, ref):
                            rec['err'][out] = (a.float() - r.float()).abs(
                            ).max().item()
                            rec['differs_from_plain'][out] = (
                                a != r).float().mean().item()
                            cs._close(f'{name} {out}', dtype, a, r)
                        rec['ok'] = rec['bit_identical_rerun']
                    except Exception as e:  # report every case, then fail
                        rec['ok'], rec['error'] = False, repr(e)[:400]
                    failed += not rec['ok']
                    print(json.dumps(rec), flush=True)
    try:
        cs.check_attention_plan(BWD_CHECK_SHAPES)
    except Exception as e:
        failed += 1
        print(json.dumps({'case': 'plan mirror', 'ok': False,
                          'error': repr(e)[:400]}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 1 if failed else 0


def run_ab_bwd(parent_source, rounds):
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import attention as A
    parent, log = build_parent(parent_source)
    print(json.dumps({'parent_ptxas': cs.ptxas_lines(log)}), flush=True)
    smi = cs.nvidia_smi()
    gen = torch.Generator(device='cuda').manual_seed(9)
    for label, shape in SHAPES.items():
        per_kernel, sdpa, do = bwd_inputs(shape, gen)
        sdpa_ms = cs._sdpa_ms(sdpa, do, True)
        plan = A.backward_plan(*shape, torch.bfloat16)
        stats = torch.empty((shape[0], shape[2], 3, plan['stats_len']),
                            device='cuda')
        rot = torch.empty((2, *shape), dtype=torch.bfloat16, device='cuda')
        for kernel, (tensors, plain) in per_kernel.items():
            ws = (stats, rot) if kernel == 'K1b' else (stats,)
            fns = {'parent': getattr(parent, NAMES[kernel]),
                   'new': _build.kernel('rope_attention_bwd', NAMES[kernel],
                                        argtypes(kernel))}
            fns['parent'].argtypes = list(argtypes(kernel, parent=True))
            fns['parent'].restype = ctypes.c_int
            outs = {arm: [torch.empty(shape, dtype=torch.bfloat16,
                                      device='cuda') for _ in range(3)]
                    for arm in fns}
            paths = {arm: bwd_call(fn, tensors, outs[arm], ws,
                                   arm == 'parent')
                     for arm, fn in fns.items()}
            ref = plain[kernel]()
            differs = {arm: {n: (o != r).float().mean().item()
                             for n, o, r in zip(('dq', 'dk', 'dv'), outs[arm],
                                                ref)}
                       for arm in fns}
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs['new'], outs['parent']))
            times = {'parent': [], 'new': []}
            for r in range(rounds):
                for arm in ('parent', 'new', 'new', 'parent'):
                    fn, out = fns[arm], outs[arm]
                    ms = cs.time_ms(lambda: bwd_call(fn, tensors, out, ws,
                                                     arm == 'parent'))
                    times[arm].append(ms)
                    print(json.dumps({'kernel': kernel, 'shape': label,
                                      'arm': arm, 'round': r, 'ms': ms,
                                      'nvidia_smi': smi}), flush=True)
            mean = {arm: sum(t) / len(t) for arm, t in times.items()}
            bound, by = cs._attention_bound(
                'fused_rope_attention_bwd' if kernel == 'K1b'
                else 'short_seq_attention_bwd', shape, 2)
            print(json.dumps({
                'kernel': kernel, 'shape': label, 'dims': list(shape),
                'parent_ms': mean['parent'], 'new_ms': mean['new'],
                'speedup': mean['parent'] / mean['new'],
                'sdpa_bwd_ms': sdpa_ms, 'bound_ms': bound, 'bound_by': by,
                'paths': paths, 'differs_from_plain': differs,
                'max_abs_diff_new_vs_parent': diff,
                'nvidia_smi': smi}), flush=True)
    return 0


def run_ab(parent_source, rounds):
    from ddg_tpu_torch.ops import _build
    parent, log = build_parent(parent_source)
    print(json.dumps({'parent_ptxas': cs.ptxas_lines(log)}), flush=True)
    smi = cs.nvidia_smi()
    gen = torch.Generator(device='cuda').manual_seed(9)
    for label, shape in SHAPES.items():
        per_kernel, sdpa = inputs(shape, gen)
        with torch.no_grad():
            sdpa_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(*sdpa))
        for kernel, tensors in per_kernel.items():
            fns = {'parent': getattr(parent, NAMES[kernel]),
                   'new': _build.kernel('rope_attention', NAMES[kernel],
                                        argtypes(kernel))}
            fns['parent'].argtypes = list(argtypes(kernel))
            fns['parent'].restype = ctypes.c_int
            outs = {arm: torch.empty(tensors[0].shape, dtype=torch.bfloat16,
                                     device='cuda') for arm in fns}
            paths = {arm: call(fn, kernel, tensors, outs[arm])
                     for arm, fn in fns.items()}
            diff = (outs['new'].float() - outs['parent'].float()).abs().max()
            times = {'parent': [], 'new': []}
            for r in range(rounds):
                for arm in ('parent', 'new', 'new', 'parent'):
                    fn, out = fns[arm], outs[arm]
                    ms = cs.time_ms(lambda: call(fn, kernel, tensors, out))
                    times[arm].append(ms)
                    print(json.dumps({'kernel': kernel, 'shape': label,
                                      'arm': arm, 'round': r, 'ms': ms,
                                      'nvidia_smi': smi}), flush=True)
            mean = {arm: sum(t) / len(t) for arm, t in times.items()}
            bound, by = cs._attention_bound(
                'fused_rope_attention' if kernel == 'K1'
                else 'short_seq_attention', shape, 2)
            print(json.dumps({
                'kernel': kernel, 'shape': label, 'dims': list(shape),
                'parent_ms': mean['parent'], 'new_ms': mean['new'],
                'speedup': mean['parent'] / mean['new'], 'sdpa_ms': sdpa_ms,
                'bound_ms': bound, 'bound_by': by, 'paths': paths,
                'max_abs_diff_new_vs_parent': diff.item(),
                'nvidia_smi': smi}), flush=True)
    return 0


def run_flash(timed):
    """K20-K22 (`csrc/flash_attention.cu`): ptxas's lines, then
    `chip_smoke.check_flash_attention` shape by shape (its bars, bit-identical
    reruns, the tensor cores at bf16 D <= 64, wgmma for K20 and K21 at bf16
    D = 64), with `timed` the CUDA-event medians of kernel, plain version
    and SDPA (backward: SDPA's) and the bound at the main shapes, and the
    launch-plan mirror. One JSON line a shape; non-zero if any failed."""
    from ddg_tpu_torch.ops import _build
    cs.DEV = 'cuda'
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['flash_attention'][1])}),
          flush=True)
    failed = 0
    for label, shape in cs.FLASH_SHAPES.items():
        results = {name: {} for name in cs.FLASH}
        rec = {'case': label, 'shape': list(shape)}
        try:
            cs.check_flash_attention(results, {label: shape}, timed=timed)
            rec['ok'], rec['results'] = True, results
        except Exception as e:  # report every shape, then fail
            rec['ok'], rec['error'] = False, repr(e)[:600]
            failed += 1
        print(json.dumps(rec), flush=True)
    try:
        cs.check_flash_plan(cs.FLASH_SHAPES.values())
    except Exception as e:
        failed += 1
        print(json.dumps({'case': 'plan mirror', 'ok': False,
                          'error': repr(e)[:400]}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 1 if failed else 0


FLASH_NAMES = {'K20': 'ddg_flash_attention_fwd',
               'K21': 'ddg_flash_attention_bwd_dkv',
               'K22': 'ddg_flash_attention_bwd_dq'}
FLASH_WRAPPERS = {'K20': 'flash_attention_fwd',
                  'K21': 'flash_attention_bwd_dkv',
                  'K22': 'flash_attention_bwd_dq'}


def flash_call(fn, ins, outs, sm_scale):
    """One launch of a K20, K21 or K22 entry point (either library's), not
    causal, on the pointers of `ins` then `outs`."""
    from ddg_tpu_torch.ops import _build
    q = ins[0]
    path = ctypes.c_int(-1)
    rc = fn(*(t.data_ptr() for t in (*ins, *outs)), *q.shape,
            *(t.stride(1) for t in ins[:3]), 0, sm_scale, 1,
            _build.stream(q), ctypes.byref(path))
    _build.check(rc, 'flash attention')
    return path.value


def run_ab_flash(parent_source, rounds):
    """K20-K22 of `parent_source` (an earlier `flash_attention.cu`) against
    the current ones, A B B A, bf16, not causal, at 48 x 128, 256 x 256 and
    4 x 1024 (x 12 x 64), beside SDPA (K21, K22: SDPA's backward) and the
    bound. A parent from before K21 formed di (its library has no
    `ddg_flash_attention_plan`) takes di as an input: its K21 arm times
    `output_grad_dot` and the launch together, so both arms compute dk, dv
    and di. Each output's share of elements that differ between the arms
    and from the plain version is reported; where both arms take the
    same path, K22 and a parent of the current design must match the new
    outputs bit for bit, or the run fails (K22's wgmma kernel takes p by
    ex2 and sums in another order than the `mma.sync` one it replaced)."""
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import flash_attention as FA
    cs.DEV = 'cuda'
    parent, log = build_parent(parent_source)
    libs = _build.build_all()
    new_log = libs['flash_attention'][1]
    print(json.dumps({'parent_ptxas': cs.ptxas_lines(log),
                      'new_ptxas': cs.ptxas_lines(new_log)}), flush=True)
    parent_takes_o = hasattr(parent, 'ddg_flash_attention_plan')
    smi = cs.nvidia_smi()
    gen = torch.Generator(device='cuda').manual_seed(9)
    shapes = {'48x128': (48, 128, 12, 64), '256x256': (256, 256, 12, 64),
              '4x1024': (4, 1024, 12, 64)}
    names = {'K20': ('o', 'l', 'm'), 'K21': ('dk', 'dv', 'di'),
             'K22': ('dq',)}
    failed = 0
    for label, shape in shapes.items():
        qkv, do, (l, m, o, di), sc = cs._flash_inputs(
            shape, torch.bfloat16, gen, False)
        sdpa = tuple(t.transpose(1, 2).contiguous() for t in qkv)
        lib_ms = {'K20': cs._sdpa_ms(sdpa, do, False)}
        lib_ms['K21'] = lib_ms['K22'] = cs._sdpa_ms(sdpa, do, True)
        plain = {'K20': lambda: FA.flash_attention_fwd_plain(
                     *qkv, sm_scale=sc),
                 'K21': lambda: FA.flash_attention_bwd_dkv_plain(
                     *qkv, l, m, do, o, sm_scale=sc),
                 'K22': lambda: (FA.flash_attention_bwd_dq_plain(
                     *qkv, l, m, do, di, sm_scale=sc),)}
        for kernel, cname in FLASH_NAMES.items():
            old_k21 = kernel == 'K21' and not parent_takes_o
            n_in = {'K20': 3, 'K21': 7, 'K22': 7}[kernel]
            n_out = {'K20': 3, 'K21': 3, 'K22': 1}[kernel]
            argt = ((_build.ptr,) * (n_in + n_out) + (_build.i32,) * 8
                    + (_build.f32, _build.i32, _build.ptr, _build.i32p))
            fns = {'parent': getattr(parent, cname),
                   'new': _build.kernel('flash_attention', cname, argt)}
            fns['parent'].argtypes = list(
                argt[1:] if old_k21 else argt)   # no di output
            fns['parent'].restype = ctypes.c_int
            ins = {'K20': qkv, 'K21': (*qkv, l, m, do, o),
                   'K22': (*qkv, l, m, do, di)}[kernel]

            def fresh():
                outs = tuple(torch.empty(shape, dtype=torch.bfloat16,
                                         device='cuda')
                             for _ in range(1 if kernel == 'K22' else
                                            2 if kernel == 'K21' else 1))
                rows = {'K20': 2, 'K21': 1, 'K22': 0}[kernel]
                return outs + tuple(torch.empty_like(l) for _ in range(rows))
            outs = {arm: fresh() for arm in fns}

            def arm_call(arm):
                if arm == 'parent' and old_k21:
                    # The parent's K21 takes di: form it as its caller did.
                    outs[arm][2].copy_(FA.output_grad_dot(o, do))
                    return flash_call(fns[arm], (*qkv, l, m, do, outs[arm][2]),
                                      outs[arm][:2], sc)
                return flash_call(fns[arm], ins, outs[arm], sc)
            paths = {arm: arm_call(arm) for arm in fns}
            torch.cuda.synchronize()
            ref = plain[kernel]()
            differs = {
                arm: {n: (a != r).float().mean().item()
                      for n, a, r in zip(names[kernel], outs[arm], ref)}
                for arm in fns}
            between = {n: (a != b).float().mean().item()
                       for n, a, b in zip(names[kernel], outs['new'],
                                          outs['parent'])}
            same = not any(between.values())
            if paths['parent'] == paths['new'] and (kernel == 'K22'
                                                    or parent_takes_o):
                failed += not same
            times = {'parent': [], 'new': []}
            for r in range(rounds):
                for arm in ('parent', 'new', 'new', 'parent'):
                    times[arm].append(cs.time_ms(lambda: arm_call(arm)))
            mean = {arm: sum(t) / len(t) for arm, t in times.items()}
            bound, by = cs._flash_bound(FLASH_WRAPPERS[kernel], shape, 2)
            print(json.dumps({
                'kernel': kernel, 'shape': label, 'dims': list(shape),
                'parent_ms': mean['parent'], 'new_ms': mean['new'],
                'speedup': mean['parent'] / mean['new'], 'times': times,
                'parent_arm': ('output_grad_dot + K21' if old_k21
                               else kernel),
                'sdpa_ms': lib_ms[kernel], 'bound_ms': bound, 'bound_by': by,
                'paths': paths, 'bit_identical_to_parent': same,
                'differs_new_vs_parent': between,
                'differs_from_plain': differs, 'nvidia_smi': smi}),
                flush=True)
    return 1 if failed else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--parent-source')
    ap.add_argument('--rounds', type=int, default=1)
    ap.add_argument('--bwd', action='store_true',
                    help='the backward kernels (K1b/K2b) instead of K1/K2')
    ap.add_argument('--flash', action='store_true',
                    help='K20-K22 against their plain versions (with '
                         '--check: untimed)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.flash and args.parent_source:
        return run_ab_flash(args.parent_source, args.rounds)
    if args.flash:
        return run_flash(timed=not args.check)
    if args.check:
        return run_check_bwd() if args.bwd else run_check()
    if not args.parent_source or not os.path.exists(args.parent_source):
        ap.error('--parent-source names no file')
    if args.bwd:
        return run_ab_bwd(args.parent_source, args.rounds)
    return run_ab(args.parent_source, args.rounds)


if __name__ == '__main__':
    sys.exit(main())
