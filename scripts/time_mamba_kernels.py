#!/usr/bin/env python3
"""CUDA-event times of the DiMamba kernels of one `ddg_tpu_torch` tree.

    python3 scripts/time_mamba_kernels.py [--tree DIR] [--tag NAME] [--f64]
                                          [--digest] [--profile]

Imports `ddg_tpu_torch` from `--tree` (default: this checkout), builds its
kernels into that tree's `build/`, and times in bf16 with
`chip_smoke.time_ms` on `chip_smoke`'s inputs: K18 and K19 at the
Species10 training shape (16 x 32768, hidden 256, d_inner 512, d_state 16,
dt_rank 16), and K14, K15, K16 and K17 at 16 x 32768 and at the dt-lowrank
training micro-batch, 4 x 32768 (`K16_4` and so on); with K17's workspace
bytes at 4 x 32768. Prints one JSON line with the card's name and power
limit. `--f64` adds, for K14's y and h0s and for K15's scan adjoint (which
K17 and K19 share), the largest distance of each fp32 output of the kernel
and of the plain version from float64 (`chip_smoke._f64_gap`) at B=2,
L=1024, d_state 16 and 64. `--digest` adds a hash of each kernel's outputs on inputs made
from fixed seeds: the scans at B=2, L=4096, d_state 16 and at L=1024,
d_state 64; K16 and K17 at B=2, L=1024 with dt_rank 64, 200 and 248 at
d_state 16 and 184 at d_state 32; K18 and K19 at B=2, L=2048, d_state 16
and 32; K14, K16 and K18 at 16 rows of L=1024 (the forward scan's walk);
K18 with the k-step front (hidden 1536, d_inner 3072, dt_rank 96, B=2,
L=512, ROADMAP B.10); and for each K18 case, apart, K18's in_proj product
and front (xz, u, x_dbl, delta: `K18..._front`), which no change to the
scan moves. Two trees run on
the same data, so equal hashes mean bit-identical outputs. `--profile`
adds ptxas's registers and spills of the scan, front and dt kernels and the
device ms a call of each kernel that K14, K16 and K18 launch at 16, 8 and
4 x 32768 and that K15 and K17 launch at 4 x 32768 (torch.profiler:
for K18 its products, its front and its scan).
To compare two versions on one card, in one call, unpack the other into a
directory `.gitignore` lists and run them in turns:

    git archive <commit> ddg_tpu_torch | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 scripts/time_mamba_kernels.py --tree $t --tag $t --digest
    done
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--tree', default=ROOT)
    ap.add_argument('--tag', default='this')
    ap.add_argument('--f64', action='store_true')
    ap.add_argument('--digest', action='store_true')
    ap.add_argument('--profile', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    from ddg_tpu_torch.ops import _build, mamba as M
    libs = _build.build_all()
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    out = {'tag': args.tag, 'nvidia_smi': cs.nvidia_smi()}
    if args.profile:
        out['ptxas'] = scan_ptxas(libs)
        out['by_kernel'] = by_kernel(cs, M)
    if args.digest:
        out['digest'] = digests(cs, M)
    gen = torch.Generator(device='cuda').manual_seed(14)
    bf = torch.bfloat16
    SL, SH, SD, SN, SR = 32768, 256, 512, 16, 16
    w = cs._mamba_weights(gen, bf)
    h = cs._rand(gen, 16, SL, SH, dtype=bf)
    kw = dict(d_state=SN, dt_rank=SR)
    out['K18'] = cs.time_ms(lambda: M.mamba_inner(h, **w, **kw), reps=20)
    _, h0s = M.mamba_inner(h, **w, **kw, return_h0s=True)
    a19 = (h, *w.values(), h0s, cs._rand(gen, 16, SL, SH, dtype=bf))
    out['K19'] = cs.time_ms(lambda: M.mamba_inner_bwd(*a19, **kw), reps=10)
    del a19, h0s, h
    for Bt, tag in ((16, ''), (4, '_4')):
        a16, a14 = cs._scan_inputs(gen, bf, Bt, SL)
        gy = cs._rand(gen, Bt, SL, SD, dtype=bf)
        out['K14' + tag] = cs.time_ms(lambda: M.ssm_scan(*a14), reps=20)
        _, h0s = M.ssm_scan(*a14, return_h0s=True)
        out['K15' + tag] = cs.time_ms(lambda: M.ssm_scan_bwd(*a14, h0s, gy),
                                      reps=10)
        out['K16' + tag] = cs.time_ms(lambda: M.ssm_scan_dtlr(*a16), reps=20)
        _, h0s = M.ssm_scan_dtlr(*a16, return_h0s=True)
        out['K17' + tag] = cs.time_ms(
            lambda: M.ssm_scan_dtlr_bwd(*a16, h0s, gy), reps=10)
        out['K17_own' + tag] = out['K17' + tag] - out['K15' + tag]
        del a16, a14, gy, h0s
        torch.cuda.empty_cache()
    ws = _build.kernel('mamba_bwd', 'ddg_ssm_scan_dtlr_bwd_workspace',
                       (_build.i32,) * 6, ctypes.c_longlong)
    out['K17_workspace_bytes_4'] = ws(4, SL, SD, SN, SR, 128)
    if args.f64:
        out['K14_f64_gap'], out['K15_f64_gap'] = f64_gaps(cs, M)
    print(json.dumps(out), flush=True)
    return 0


def scan_ptxas(libs):
    """{kernel: 'N registers, S spill stores'} of the scan kernels, from
    the build's ptxas lines (empty where the library was built before)."""
    out, cur = {}, None
    for name in ('mamba', 'mamba_bwd'):
        for ln in libs[name][1].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = m.group(1)
            elif cur and re.search('scan|delta|dt_bwd|front', cur):
                key = re.sub(r'^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}\d+', '', cur)[:60]
                if 'spill stores' in ln:
                    out[key] = ln.split(',')[1].strip()
                elif 'registers' in ln:
                    out[key] = ln.split(':')[-1].split(',')[0].strip() \
                        + ', ' + out.get(key, '')
    return out


def _profile(fn, reps=3):
    """{kernel: device ms a call} of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace('(anonymous namespace)::', '')[:48]:
            round(e.device_time_total / reps / 1e3, 4)
            for e in prof.key_averages() if e.device_time_total > 0}


def by_kernel(cs, M):
    """{K14|K16|K18 at 16, 8 and 4 rows of 32768, K15|K17 at 4: {kernel:
    device ms a call}}, bf16."""
    gen = torch.Generator(device='cuda').manual_seed(15)
    bf = torch.bfloat16
    out = {}
    for Bt in (16, 8, 4):
        a16, a14 = cs._scan_inputs(gen, bf, Bt, 32768)
        out[f'K14_{Bt}'] = _profile(lambda: M.ssm_scan(*a14))
        out[f'K16_{Bt}'] = _profile(lambda: M.ssm_scan_dtlr(*a16))
        if Bt == 4:
            g = cs._rand(gen, 4, 32768, cs.SD, dtype=bf)
            _, h14 = M.ssm_scan(*a14, return_h0s=True)
            _, h16 = M.ssm_scan_dtlr(*a16, return_h0s=True)
            out['K15_4'] = _profile(lambda: M.ssm_scan_bwd(*a14, h14, g))
            out['K17_4'] = _profile(lambda: M.ssm_scan_dtlr_bwd(*a16, h16, g))
            del g, h14, h16
        del a16, a14
        w = cs._mamba_weights(gen, bf)
        h = cs._rand(gen, Bt, 32768, cs.SH, dtype=bf)
        out[f'K18_{Bt}'] = _profile(lambda: M.mamba_inner(
            h, **w, d_state=cs.SN, dt_rank=cs.SR))
        del w, h
        torch.cuda.empty_cache()
    return out


def _hash(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def digests(cs, M):
    """{kernel case: hash of its outputs}, each case on inputs of its own
    seed (bf16 operands, as the main paths run them)."""
    bf = torch.bfloat16
    out = {}
    for L, N in ((4096, 16), (1024, 64)):
        gen = torch.Generator(device='cuda').manual_seed(1000 + N)
        a16, a14 = cs._scan_inputs(gen, bf, 2, L, N=N)
        g = cs._rand(gen, 2, L, cs.SD, dtype=bf)
        y14 = M.ssm_scan(*a14, return_h0s=True)
        out[f'K14_N{N}'] = _hash(y14)
        out[f'K15_N{N}'] = _hash(M.ssm_scan_bwd(*a14, y14[1], g))
        y16 = M.ssm_scan_dtlr(*a16, return_h0s=True)
        out[f'K16_N{N}'] = _hash(y16)
        out[f'K17_N{N}'] = _hash(M.ssm_scan_dtlr_bwd(*a16, y16[1], g))
    # K16 and K17 at ranks past one K17 rank tile (128) that the first
    # K17 design held whole (248 at d_state 16, 184 past it).
    for N, R in ((16, 64), (16, 200), (16, 248), (32, 184)):
        gen = torch.Generator(device='cuda').manual_seed(3000 + R)
        a16, _ = cs._scan_inputs(gen, bf, 2, 1024, N=N, R=R)
        g = cs._rand(gen, 2, 1024, cs.SD, dtype=bf)
        y16 = M.ssm_scan_dtlr(*a16, return_h0s=True)
        out[f'K16_N{N}_R{R}'] = _hash(y16)
        out[f'K17_N{N}_R{R}'] = _hash(M.ssm_scan_dtlr_bwd(*a16, y16[1], g))
    for N in (16, 32):
        gen = torch.Generator(device='cuda').manual_seed(2000 + N)
        w = cs._mamba_weights(gen, bf, N=N)
        h = cs._rand(gen, 2, 2048, cs.SH, dtype=bf)
        kw = dict(d_state=N, dt_rank=cs.SR)
        y18 = M.mamba_inner(h, **w, **kw, return_h0s=True)
        out[f'K18_N{N}'] = _hash(y18)
        out[f'K18_N{N}_front'] = _hash(k18_parts(M, h, w, N, cs.SR)[:4])
        g = cs._rand(gen, 2, 2048, cs.SH, dtype=bf)
        out[f'K19_N{N}'] = _hash(M.mamba_inner_bwd(h, *w.values(), y18[1],
                                                   g, **kw))
    # 16 rows: the forward scan's walk (the cases above run its passes).
    gen = torch.Generator(device='cuda').manual_seed(4016)
    a16, a14 = cs._scan_inputs(gen, bf, 16, 1024)
    out['K14_B16'] = _hash(M.ssm_scan(*a14, return_h0s=True))
    out['K16_B16'] = _hash(M.ssm_scan_dtlr(*a16, return_h0s=True))
    w = cs._mamba_weights(gen, bf)
    h = cs._rand(gen, 16, 1024, cs.SH, dtype=bf)
    out['K18_B16'] = _hash(M.mamba_inner(h, **w, d_state=cs.SN,
                                         dt_rank=cs.SR, return_h0s=True))
    out['K18_B16_front'] = _hash(k18_parts(M, h, w, cs.SN, cs.SR)[:4])
    # The k-step front (`mamba_front_wide_kernel`): d_inner 3072, dt_rank 96.
    gen = torch.Generator(device='cuda').manual_seed(4096)
    w = cs._mamba_weights(gen, bf, H=1536, d=3072, R=96)
    h = cs._rand(gen, 2, 512, 1536, dtype=bf)
    out['K18_wide'] = _hash(M.mamba_inner(h, **w, d_state=cs.SN, dt_rank=96,
                                          return_h0s=True))
    out['K18_wide_front'] = _hash(k18_parts(M, h, w, cs.SN, 96)[:4])
    return out


def k18_parts(M, h, w, N, R, chunk=128):
    """One bf16 K18 call (`ddg_mamba_inner`) on buffers of its own: (xz,
    u, x_dbl, delta, y, out, h0s), so that in_proj's product and the
    front (the first four) can be told apart from the scan's outputs."""
    from ddg_tpu_torch.ops import _build
    bf = torch.bfloat16
    Bt, L, H = h.shape
    d = w['W_in'].shape[1] // 2
    K = w['conv_w'].shape[0]
    prep = (w['W_in'].t(), w['conv_w'].reshape(K, d), w['conv_b'],
            w['W_x'].t(), w['W_dt'].float(), w['b_dt'].float(),
            w['A'].float(), w['D'].float(), w['W_out'].t())
    prep = [t.to(bf).contiguous() if i in (0, 1, 2, 3, 8) else
            t.contiguous() for i, t in enumerate(prep)]
    dev = h.device
    xz = torch.empty((Bt, L, 2 * d), dtype=bf, device=dev)
    u = torch.empty((Bt, L, d), dtype=bf, device=dev)
    x_dbl = torch.empty((Bt, L, R + 2 * N), dtype=bf, device=dev)
    y = torch.empty((Bt, L, d), dtype=bf, device=dev)
    out = torch.empty((Bt, L, H), dtype=bf, device=dev)
    delta = torch.empty((Bt, L, d), dtype=torch.float32, device=dev)
    h0s, ysum, P, E = M._scan_buffers(u, d, N, chunk)
    fn = _build.kernel('mamba', 'ddg_mamba_inner',
                       (_build.ptr,) * 20 + (_build.i32,) * 9 + (_build.ptr,))
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = fn(h.contiguous().data_ptr(), *(t.data_ptr() for t in prep),
            xz.data_ptr(), u.data_ptr(), x_dbl.data_ptr(), delta.data_ptr(),
            h0s.data_ptr(), ptr(ysum), ptr(P), ptr(E), y.data_ptr(),
            out.data_ptr(), Bt, L, H, d, K, R, N, chunk, 1, _build.stream(h))
    _build.check(rc, 'ddg_mamba_inner')
    return xz, u, x_dbl, delta, y, out, h0s


def f64_gaps(cs, M):
    """({d_state: {output: [plain - f64, kernel - f64, max |f64|]}} of K14,
    the same of K15), in fp32 at B=2, L=1024."""
    gaps, gaps14 = {}, {}
    for N in (16, 64):
        gen = torch.Generator(device='cuda').manual_seed(64 + N)
        _, a14 = cs._scan_inputs(gen, torch.float32, 2, 1024, N=N)
        y14 = M.ssm_scan(*a14, return_h0s=True)
        gaps14[N] = cs._f64_gap(('y', 'h0s'), y14,
                                M.ssm_scan_plain(*a14, return_h0s=True),
                                cs._f64_scan(a14))
        h0s = y14[1]
        a15 = (*a14, h0s, cs._rand(gen, 2, 1024, a14[0].shape[-1]))
        got = M.ssm_scan_bwd(*a15)
        plain = M.ssm_scan_bwd_plain(*a15)
        h0s64 = cs._f64_scan(a14)[1]
        ddt, du, dB, dC, _, dz, _, _ = M.scan_bwd_chunks(
            *(t.double() for t in a14[:2]), M._round_trip(a14[2]).double(),
            *(t.double() for t in a14[3:]), a15[-1].double(), h0s64, 128)
        gaps[N] = cs._f64_gap(('du', 'ddelta', 'dB', 'dC', 'dz'),
                              [got[i] for i in (0, 1, 2, 3, 5)],
                              [plain[i] for i in (0, 1, 2, 3, 5)],
                              (du, ddt, dB, dC, dz))
    return gaps14, gaps


if __name__ == '__main__':
    sys.exit(main())
