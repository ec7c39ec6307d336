#!/usr/bin/env python3
"""CUDA-event times of the DiMamba kernels of one `ddg_tpu_torch` tree.

    python3 scripts/time_mamba_kernels.py [--tree DIR] [--tag NAME]

Imports `ddg_tpu_torch` from `--tree` (default: this checkout), builds its
kernels into that tree's `build/`, and times K18, K19, K14 and K15 (and
K16, K17 where the tree has them) in bf16 at the Species10 training shape
(16 x 32768, hidden 256, d_inner 512, d_state 16, dt_rank 16) with
`chip_smoke.time_ms` on `chip_smoke`'s inputs; prints one JSON line with
the card's name and power limit. To compare two versions on one card, in
one call, unpack the other into a directory `.gitignore` lists and run
them in turns:

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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
