"""Same-call A/B of the AR decode step at the `ar` line's shape (2B = 512
rows, D-CFG classes, 127 teacher-forced positions, 4 buckets' windows):
the class's adaLN terms formed once (`cond_terms`) against formed every
step (`cond=`), in turns A B B A, twice. Wall ms a step (host clock around
the loop, synchronised).

    python3 scripts/ab_torch_ar_decode.py     # from the repo root, on a card
"""
import sys
import time
sys.path.insert(0, '.')
import torch
from ddg_tpu_torch.entry import ar_flagship
from ddg_tpu_torch.models import dit_decode as D

run = ar_flagship(device='cuda')
cfg = run.cfg
params = D.precast(cfg, run.params)
B2 = 2 * run.batch_size
cond = torch.cat([torch.zeros(run.batch_size, dtype=torch.int32),
                  torch.full((run.batch_size,), 2, dtype=torch.int32)]).cuda()
gen = torch.Generator(device='cuda').manual_seed(0)
tokens = torch.randint(0, cfg.vocab_size, (B2, cfg.length), generator=gen,
                       device='cuda', dtype=torch.int32)
bounds = [round(127 * j / 4) for j in range(5)]


def loop(hoist):
    cache = D.init_cache(cfg, B2, device='cuda')
    terms = D.cond_terms(cfg, params, cond) if hoist else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for j in range(4):
            w = min(cfg.length, -(-bounds[j + 1] // 128) * 128)
            for i in range(bounds[j], bounds[j + 1]):
                if hoist:
                    out = D.decode_step(cfg, params, cache, tokens[:, i], i,
                                        window=w, terms=terms)[0]
                else:
                    out = D.decode_step(cfg, params, cache, tokens[:, i], i,
                                        cond=cond, window=w)[0]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 127 * 1e3, out


loop(True)
loop(False)
res = {'hoisted': [], 'per_step': []}
for order in ((True, False, False, True), (False, True, True, False)):
    for h in order:
        ms, out = loop(h)
        res['hoisted' if h else 'per_step'].append(ms)
a, b = loop(True)[1], loop(False)[1]
print({'ms_per_step': res, 'logits_equal': bool(torch.equal(a, b))})
print(open('/proc/cpuinfo').read().count('processor'), 'cpus')
