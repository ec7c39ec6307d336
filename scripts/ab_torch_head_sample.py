#!/usr/bin/env python3
"""The LM1B D-CFG feature-mix sampler (gamma 2, B=24) with and without the
head-fused step, in turns on one card.

    python3 scripts/ab_torch_head_sample.py [--steps 1000] [--rounds 2]

For the bf16 flagship and then the int8 one (`flagship(int8=True)`), each
round runs the sampler without `fused_head` (the head product, then K7),
then with it (K11, or K12 under int8), then with it again, then without:
A B B A. Prints one JSON line per run (wall ms a step from a host clock
around the whole call, ending in a synchronize) and one line per flagship
with the mean of each arm, beside nvidia-smi's name and power limit.
Host-bound loops vary between runs more than device times do, which is
why the arms alternate.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=1000)
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import flagship
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    guidance = SM.GuidanceSpec(method='cfg', gamma=2.0)
    for int8 in (False, True):
        spec, cfg, _, apply_fn, params = flagship(device='cuda', int8=int8)

        def run(fused_head, steps, seed):
            gen = torch.Generator(device='cuda').manual_seed(seed)
            cond = torch.zeros((24,), dtype=torch.int32, device='cuda')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            SM.diffusion_sample(
                spec, SM.SamplerSpec(steps=steps, use_cache=False,
                                     fused=True, fused_head=fused_head),
                apply_fn, params, gen, batch_size=24, length=cfg.length,
                guidance=guidance, cond=cond, dit_cfg=cfg)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps

        run(False, 4, 0)
        run(True, 4, 0)
        arms = {False: [], True: []}
        for r in range(args.rounds):
            for fh in (False, True, True, False):
                ms = run(fh, args.steps, r)
                arms[fh].append(ms)
                print(json.dumps({'int8': int8, 'fused_head': fh,
                                  'round': r, 'steps': args.steps,
                                  'ms_per_step': ms}), flush=True)
        mean = {fh: sum(v) / len(v) for fh, v in arms.items()}
        print(json.dumps({'int8': int8, 'nvidia_smi': smi,
                          'mean_ms_per_step_unfused_head': mean[False],
                          'mean_ms_per_step_fused_head': mean[True],
                          'samples_per_s_unfused_head': 24e3 / (
                              mean[False] * args.steps),
                          'samples_per_s_fused_head': 24e3 / (
                              mean[True] * args.steps)}), flush=True)
        del apply_fn, params
    return 0


if __name__ == '__main__':
    sys.exit(main())
