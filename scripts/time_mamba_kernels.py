#!/usr/bin/env python3
"""CUDA-event times of the DiMamba kernels of one `ddg_tpu_torch` tree.

    python3 scripts/time_mamba_kernels.py [--tree DIR] [--tag NAME] [--f64]

Imports `ddg_tpu_torch` from `--tree` (default: this checkout), builds its
kernels into that tree's `build/`, and times K18, K19, K14 and K15 (and
K16, K17 where the tree has them) in bf16 at the Species10 training shape
(16 x 32768, hidden 256, d_inner 512, d_state 16, dt_rank 16) with
`chip_smoke.time_ms` on `chip_smoke`'s inputs; prints one JSON line with
the card's name and power limit. `--f64` adds, for K15's scan adjoint
(which K17 and K19 share), the largest distance of each fp32 output of
the kernel and of the plain version from the float64 adjoint
(`chip_smoke._f64_gap`) at B=2, L=1024, d_state 16 and 64, on inputs made
from one seed, so two trees are compared on the same data. To compare two
versions on one card, in one call, unpack the other into a directory
`.gitignore` lists and run them in turns:

    git archive <commit> ddg_tpu_torch | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 scripts/time_mamba_kernels.py --tree $t --tag $t; done
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--tree', default=ROOT)
    ap.add_argument('--tag', default='this')
    ap.add_argument('--f64', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    from ddg_tpu_torch.ops import _build, mamba as M
    _build.build_all()
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    gen = torch.Generator(device='cuda').manual_seed(14)
    bf = torch.bfloat16
    TB, SL, SH, SD, SN, SR = 16, 32768, 256, 512, 16, 16
    w = cs._mamba_weights(gen, bf)
    h = cs._rand(gen, TB, SL, SH, dtype=bf)
    kw = dict(d_state=SN, dt_rank=SR)
    out = {'tag': args.tag, 'nvidia_smi': cs.nvidia_smi()}
    out['K18'] = cs.time_ms(lambda: M.mamba_inner(h, **w, **kw), reps=20)
    _, h0s = M.mamba_inner(h, **w, **kw, return_h0s=True)
    a19 = (h, *w.values(), h0s, cs._rand(gen, TB, SL, SH, dtype=bf))
    out['K19'] = cs.time_ms(lambda: M.mamba_inner_bwd(*a19, **kw), reps=10)
    del a19, h0s
    xz = cs._rand(gen, TB, SL, 2 * SD, dtype=bf)
    xd = cs._rand(gen, TB, SL, SR + 2 * SN, dtype=bf)
    args14 = (xz[..., :SD], M.softplus(cs._rand(gen, TB, SL, SD) - 3.0),
              w['A'], xd[..., SR:SR + SN], xd[..., SR + SN:], w['D'],
              xz[..., SD:])
    out['K14'] = cs.time_ms(lambda: M.ssm_scan(*args14), reps=20)
    _, h0s = M.ssm_scan(*args14, return_h0s=True)
    gy = cs._rand(gen, TB, SL, SD, dtype=bf)
    out['K15'] = cs.time_ms(lambda: M.ssm_scan_bwd(*args14, h0s, gy),
                            reps=10)
    if hasattr(M, 'ssm_scan_dtlr'):
        args16 = (xz[..., :SD], xd[..., :SR].float(), w['W_dt'], w['b_dt'],
                  *args14[2:])
        out['K16'] = cs.time_ms(lambda: M.ssm_scan_dtlr(*args16), reps=20)
        _, h0s = M.ssm_scan_dtlr(*args16, return_h0s=True)
        out['K17'] = cs.time_ms(
            lambda: M.ssm_scan_dtlr_bwd(*args16, h0s, gy), reps=10)
    if args.f64:
        out['K15_f64_gap'] = f64_gaps(cs, M)
    print(json.dumps(out), flush=True)
    return 0


def f64_gaps(cs, M):
    """{d_state: {output: [plain - f64, kernel - f64, max |f64|]}} of K15 in
    fp32 at B=2, L=1024."""
    gaps = {}
    for N in (16, 64):
        gen = torch.Generator(device='cuda').manual_seed(64 + N)
        _, a14 = cs._scan_inputs(gen, torch.float32, 2, 1024, N=N)
        _, h0s = M.ssm_scan(*a14, return_h0s=True)
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
    return gaps


if __name__ == '__main__':
    sys.exit(main())
