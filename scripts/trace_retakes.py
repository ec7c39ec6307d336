#!/usr/bin/env python3
"""How often `chip_smoke.kernel_trace` loses device records, on one CUDA
card (ROADMAP C.9).

    python3 scripts/trace_retakes.py [--traces 200]

Traces K8 (`fused_absorbing_cfg_sample`, float32 logits at chip_smoke's
24 x 128 x V=30523) through `kernel_trace` `--traces` times, as
`chip_smoke.py` takes its traces. A trace that lost a sleep kernel before
or after the traced calls is retaken, at most 4 times in all. Prints one
JSON line: the retakes (`chip_smoke.TRACE_RETAKES`), the traces no retake
made whole, and the K8 launches each whole trace saw (it must be one a
call).
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--traces', type=int, default=200,
                    help='traces to take (default 200)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import fused_sampling as fs
    _build.build_all()
    gen = torch.Generator(device='cuda').manual_seed(6)
    (lc, lu), xt, mct, mcs = cs._sample_inputs(gen, torch.float32, 2)
    seed = torch.tensor([11], dtype=torch.int32, device='cuda')

    def k8():
        fs.fused_absorbing_cfg_sample(seed, xt, lc, lu, cs.GAMMA, mct, mcs,
                                      mask_index=cs.MASK)

    lost, launches = 0, set()
    for _ in range(args.traces):
        try:
            by = cs.kernel_trace(k8)
            launches.add(sum(n for n, _ in by.values()))
        except RuntimeError:
            lost += 1
    print(json.dumps({'device': torch.cuda.get_device_name(0),
                      'nvidia_smi': cs.nvidia_smi(), 'kernel': 'K8 fp32',
                      'shape': [cs.B, cs.L, cs.V], 'traces': args.traces,
                      'retakes': len(cs.TRACE_RETAKES), 'lost': lost,
                      'launches': sorted(launches),
                      'retake_records': cs.TRACE_RETAKES[:20]}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
