#!/usr/bin/env python3
"""The head-fused step (K11, K12; `csrc/head_sample.cu`) and GroupNorm
(K13; `csrc/groupnorm.cu`) on one card, in turns.

    python3 scripts/ab_torch_head_sample.py [--steps 1000] [--rounds 2]
    python3 scripts/ab_torch_head_sample.py --parent-source build/ab/head_sample.cu
    python3 scripts/ab_torch_head_sample.py --k13 --parent-source build/ab/groupnorm.cu
    python3 scripts/ab_torch_head_sample.py --phases [--int8]
    python3 scripts/ab_torch_head_sample.py --int8 --parent-source build/ab/head_sample.cu

With no source, the LM1B D-CFG feature-mix sampler (gamma 2, B=24) with
and without the head-fused step: for the bf16 flagship and then the int8
one (`flagship(int8=True)`), each round runs the sampler without
`fused_head` (the head product, then K7), then with it (K11, or K12 under
int8), then with it again, then without: A B B A. One JSON line per run
(wall ms a step from a host clock around the whole call, ending in a
synchronize) and one line per flagship with the mean of each arm, beside
nvidia-smi's name and power limit. Host-bound loops vary between runs
more than device times do, which is why the arms alternate.

With `--parent-source` (an earlier `head_sample.cu`, e.g. `git show
HEAD:ddg_tpu_torch/csrc/head_sample.cu > build/ab/head_sample.cu`; headers
are looked up beside it first, then in `csrc/`) it builds that copy into
`build/ab/` under another library name and, at the LM1B slice (24 x 128
tokens, D 768, V 30523, Vp 30720, every token masked, in-kernel noise),
times the parent's call, the new one, the new one, the parent's (A B B A,
`--rounds` times, CUDA events, `chip_smoke.time_ms`) for the bf16 head
(K11), the fp32 head (K11) and the int8 head (K12), and compares the two
arms' tokens: equal bits for bf16 and fp32, each arm's tokens against the
plain version under an external Gumbel where the top-two margin exceeds
`chip_smoke.MARGIN`, and for int8, whose noise differs between the
versions (the parent's `ddg::gumbel_from_bits`, this tree's K7 noise), the
new arm's in-kernel tokens against its composite (the int8 logits, then
K7 with the same seed) by `chip_smoke._rng_gap_check`, and the count of
tokens in which the two arms differ. Both arms are
called through ctypes on the same inputs; each arm takes the split its
own plan gives (`ddg_head_plan` where the parent exports it, else the
first kernel's `head_splits`, by the card's SM count). One JSON line per arm and one summary line per
head, with the split by kernel (torch.profiler).

With `--phases`, the bf16 head's kernel (`hw::head_wgmma_kernel`) at the
same slice beside two copies of this tree's `head_sample.cu`, each
patched to skip one side (`PHASE_PATCHES`): 'no_products' drops the
wgmma instructions (the loads stay; the epilogue runs on zero logits),
'no_epilogue' hands each logits tile back as soon as it is read (the
loads and products stay). Timed full, no_products, no_epilogue, then
back (A B C C B A, `--rounds` times, CUDA events), with the split by
kernel; the copies' tokens are not checked. `--phases --int8` does the
same for the int8 head's kernel (`s8::head_s8_kernel`, `PHASE_PATCHES_S8`:
'no_products' drops its wgmma, 'no_epilogue' the epilogue's work on each
tile, which is then read by no one, 'no_noise' the noise and best z + g,
'no_pruning' forms every logit's noise) and times beside them splits its
plan did not take, 'split1024' and 'split2048' (1024 and 2048 vocab
rows); each copy runs its own plan's split.

`--int8` with `--parent-source` times the int8 head (K12) alone.

With `--k13 --parent-source <an earlier groupnorm.cu>`, the same for K13
over the 51 norms of one UNet D-CFG forward (`chip_smoke.
unet_forward_census` of `entry.unet_flagship`, N = 64, bf16 in and fp32
out): each arm's sum over the 51 calls (each shape weighted by its
count), per shape, A B B A, with both arms' errors against the plain
version and the largest difference between them; then the 51 calls back
to back (one pair of events around them all, as a forward runs them),
A B B A.
"""

import argparse
import ctypes
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
sys.path.insert(0, str(ROOT / 'scripts'))
from ab_torch_attention import build_parent, build_variants  # noqa: E402,E501

HEAD_ARGS = (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
GN_ARGS = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_float,)
           + (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


def run_sampler(steps, rounds):
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import flagship
    smi = cs.nvidia_smi()
    guidance = SM.GuidanceSpec(method='cfg', gamma=2.0)
    for int8 in (False, True):
        spec, cfg, _, apply_fn, params = flagship(device='cuda', int8=int8)

        def run(fused_head, n_steps, seed):
            gen = torch.Generator(device='cuda').manual_seed(seed)
            cond = torch.zeros((24,), dtype=torch.int32, device='cuda')
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            SM.diffusion_sample(
                spec, SM.SamplerSpec(steps=n_steps, use_cache=False,
                                     fused=True, fused_head=fused_head),
                apply_fn, params, gen, batch_size=24, length=cfg.length,
                guidance=guidance, cond=cond, dit_cfg=cfg)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n_steps

        run(False, 4, 0)
        run(True, 4, 0)
        arms = {False: [], True: []}
        for r in range(rounds):
            for fh in (False, True, True, False):
                ms = run(fh, steps, r)
                arms[fh].append(ms)
                print(json.dumps({'int8': int8, 'fused_head': fh,
                                  'round': r, 'steps': steps,
                                  'ms_per_step': ms}), flush=True)
        mean = {fh: sum(v) / len(v) for fh, v in arms.items()}
        print(json.dumps({'int8': int8, 'nvidia_smi': smi,
                          'mean_ms_per_step_unfused_head': mean[False],
                          'mean_ms_per_step_fused_head': mean[True],
                          'samples_per_s_unfused_head': 24e3 / (
                              mean[False] * steps),
                          'samples_per_s_fused_head': 24e3 / (
                              mean[True] * steps)}), flush=True)
        del apply_fn, params
    return 0


def _head_call(fn, splits, seed, xt, fin, head, mct, mcs, Vt, gumbel=None):
    """One call of a `ddg_head_sample` of either version; returns xs."""
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import fused_sampling as fs
    feats = fin[0]
    Bt, Lt, Dm = feats.shape
    w = head[0]
    Vp = w.shape[0]
    int8 = feats.dtype == torch.int8
    part = torch.empty((5, splits, Bt * Lt), dtype=torch.float32,
                       device='cuda')
    out = torch.empty((Bt, Lt), dtype=torch.int32, device='cuda')
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = fn(seed.data_ptr(), xt.data_ptr(), feats.data_ptr(), w.data_ptr(),
            (head[2] if int8 else head[1]).data_ptr(),
            ptr(fin[1] if int8 else None), ptr(head[1] if int8 else None),
            mct.data_ptr(), mcs.data_ptr(), ptr(gumbel), out.data_ptr(),
            part.data_ptr(), None, Bt, Lt, Dm, Vp, Vt, cs.MASK,
            fs._HEAD_MODES[feats.dtype], splits, _build.stream(feats))
    _build.check(rc, 'ddg_head_sample')
    return out


# (old, new) text of `head_sample.cu` for `--phases`; each old text must
# occur once.
PHASE_PATCHES = {
    'no_products': [('          wgmma_n128(acc, desc128(fa + 32 * kk), '
                     'desc128(fw + 32 * kk), k > 0 || kk > 0);\n', '')],
    'no_epilogue': [('    ddg::mbar_arrive(ddg::smem_u32(zempty));\n',
                     '    ddg::mbar_arrive(ddg::smem_u32(zempty));\n'
                     '    continue;\n')],
}


# The same for the int8 kernel, and the two layouts its plan did not take.
_NO_WGMMA = ('          wgmma_s8(acc, hw::desc128(fa + 32 * kk), '
             'hw::desc128(fw + 32 * kk),\n'
             '                   k > 0 || kk > 0);\n', '')
PHASE_PATCHES_S8 = {
    'no_products': [_NO_WGMMA],
    'no_epilogue': [('      rows(acc, a, v0, tok0 + row, xs[h], tb[h], tl[h], seed, '
                     'floor, st[h]);\n', '')],
    'no_noise': [('  if (mc >= 0 && mc < N) {\n#pragma unroll\n'
                  '    for (int c = 0; c < N; ++c)\n'
                  '      if (c == mc) st.mg += ddg::gumbel(w[c]);',
                  '  return;\n  if (mc >= 0 && mc < N) {\n#pragma unroll\n'
                  '    for (int c = 0; c < N; ++c)\n'
                  '      if (c == mc) st.mg += ddg::gumbel(w[c]);')],
    'no_pruning': [('      if (z[4 * k + i] > -INFINITY && '
                    'static_cast<int>(w[4 * k + i] >> 8) > kmax)',
                    '      if (z[4 * k + i] > -INFINITY)')],
    'split1024': [('constexpr int kSplitRows = 3840;',
                   'constexpr int kSplitRows = 1024;')],
    'split2048': [('constexpr int kSplitRows = 3840;',
                   'constexpr int kSplitRows = 2048;')],
}


def _plan_splits(lib, T, Dm, Vp, dtype):
    """The vocab splits of a built library's own plan (`ddg_head_plan`)."""
    from ddg_tpu_torch.ops import fused_sampling as fs
    out = (ctypes.c_int * 7)()
    lib.ddg_head_plan(T, Dm, Vp, fs._HEAD_MODES[dtype], out)
    return list(out)


def run_phases(rounds, int8=False):
    from ddg_tpu_torch.ops import _build
    dtype = torch.int8 if int8 else torch.bfloat16
    built = build_variants('head_sample.cu',
                           PHASE_PATCHES_S8 if int8 else PHASE_PATCHES)
    libs = {'full': ctypes.CDLL(str(_build.build_all()['head_sample'][0]))}
    libs.update({arm: lib for arm, (lib, _) in built.items()})
    fns = {arm: lib.ddg_head_sample for arm, lib in libs.items()}
    for f in fns.values():
        f.argtypes = list(HEAD_ARGS)
        f.restype = ctypes.c_int
    smi = cs.nvidia_smi()
    gen = torch.Generator(device='cuda').manual_seed(17)
    Bt, Lt, Vt = cs.B, cs.L, cs.V
    cs.MASK = Vt - 1
    fin, head, _, mct, mcs, _ = cs._head_inputs(
        gen, Bt, Lt, Vt, cs.MASK, cs.TILE_V, dtype)
    plans = {arm: _plan_splits(lib, Bt * Lt, cs.D, head[0].shape[0], dtype)
             for arm, lib in libs.items()}
    for arm, plan in plans.items():
        cs.check(plan[0] == 1, f'{arm}: the slice does not take the wgmma '
                               f'kernel ({plan})')
    seed = torch.tensor([11], dtype=torch.int32, device='cuda')
    xm = torch.full((Bt, Lt), cs.MASK, dtype=torch.int32, device='cuda')

    def call(arm):
        return _head_call(fns[arm], plans[arm][4], seed, xm, fin, head,
                          mct, mcs, Vt)
    order = list(fns)
    times = {arm: [] for arm in order}
    for r in range(rounds):
        for arm in order + order[::-1]:
            ms = cs.time_ms(lambda: call(arm))
            times[arm].append(ms)
            print(json.dumps({'phases': arm, 'round': r, 'ms': ms,
                              'nvidia_smi': smi}), flush=True)
    print(json.dumps({
        'head': str(dtype), 'plans': plans,
        'phases_ms': {arm: sum(t) / len(t) for arm, t in times.items()},
        'times': times,
        'split_ms': {arm: cs.kernel_ms(lambda: call(arm)) for arm in order},
        'ptxas': {arm: cs.ptxas_lines(log) for arm, (_, log)
                  in built.items()},
        'nvidia_smi': smi}), flush=True)
    return 0


def _parent_splits(parent, T, Dm, Vp, dtype, sms):
    """The vocab splits the parent's wrapper would give: its exported
    plan's, else (a parent before `ddg_head_plan`) `head_splits`."""
    from ddg_tpu_torch.ops import fused_sampling as fs
    try:
        plan = parent.ddg_head_plan
    except AttributeError:
        return fs.head_splits(T, Vp, sms)
    out = (ctypes.c_int * 7)()
    plan(T, Dm, Vp, fs._HEAD_MODES[dtype], out)
    return out[4] or fs.head_splits(T, Vp, sms)


def run_head_ab(parent_source, rounds, dtypes):
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import fused_sampling as fs
    parent, log = build_parent(parent_source)
    print(json.dumps({'parent_ptxas': cs.ptxas_lines(log)}), flush=True)
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['head_sample'][1])}),
          flush=True)
    smi = cs.nvidia_smi()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device='cuda').manual_seed(17)
    Bt, Lt, Vt = cs.B, cs.L, cs.V
    cs.MASK = Vt - 1
    failed = 0
    for dtype in dtypes:
        fin, head, xt, mct, mcs, g = cs._head_inputs(
            gen, Bt, Lt, Vt, cs.MASK, cs.TILE_V, dtype)
        Vp = head[0].shape[0]
        plan = fs.head_plan(Bt * Lt, cs.D, Vp, dtype)
        splits = {'parent': _parent_splits(parent, Bt * Lt, cs.D, Vp, dtype,
                                           sms),
                  'new': plan['splits'] or fs.head_splits(Bt * Lt, Vp, sms)}
        fns = {'parent': getattr(parent, 'ddg_head_sample'),
               'new': _build.kernel('head_sample', 'ddg_head_sample',
                                    HEAD_ARGS)}
        for f in fns.values():
            f.argtypes = list(HEAD_ARGS)
            f.restype = ctypes.c_int
        seed = torch.tensor([11], dtype=torch.int32, device='cuda')
        xm = torch.full((Bt, Lt), cs.MASK, dtype=torch.int32, device='cuda')

        def call(arm, x=xm, gumbel=None):
            return _head_call(fns[arm], splits[arm], seed, x, fin, head,
                              mct, mcs, Vt, gumbel)
        rec = {'head': str(dtype), 'plan': plan, 'splits': splits}
        try:
            got = {arm: call(arm) for arm in fns}
            again = {arm: call(arm) for arm in fns}
            rec['reruns_equal'] = {arm: bool(torch.equal(got[arm],
                                                         again[arm]))
                                   for arm in fns}
            rec['arms_equal'] = bool(torch.equal(got['parent'], got['new']))
            rec['arms_differ_tokens'] = int((got['parent'] != got['new'])
                                            .sum().item())
            if dtype != torch.int8:
                cs.check(rec['arms_equal'], f'{dtype}: the arms differ')
            # External Gumbel: each arm against the plain version.
            ext = {arm: call(arm, xt, g) for arm in fns}
            plain = (fs.fused_absorbing_head_sample_int8_plain
                     if dtype == torch.int8 else
                     fs.fused_absorbing_head_sample_plain)
            ref = plain(7, xt, *fin, *head, mct, mcs, gumbel_t=g,
                        vocab_size=Vt, mask_index=cs.MASK,
                        tile_v=cs.TILE_V)
            z = (fs.head_logits_int8(*fin, *head) if dtype == torch.int8
                 else fs.head_logits(*fin, *head))
            scores = fs.perturbed_scores(
                7, z[..., :Vt], mct, mcs, mask_index=cs.MASK,
                gumbel=g.transpose(1, 2)[..., :Vt])
            rec['compared_tokens'] = {arm: cs._token_check(
                f'{dtype} {arm}', out, ref, scores, xt, Vt)
                for arm, out in ext.items()}
            if dtype == torch.int8:
                comp = fs.fused_absorbing_sample(
                    seed, xm, z[..., :Vt].contiguous(), mct, mcs,
                    mask_index=cs.MASK)
                rec['new_vs_composite_near_ties'] = cs._rng_gap_check(
                    'int8 new arm vs its composite', got['new'], comp,
                    z[..., :Vt], xm, mct, mcs, 11)
            del scores, z, ref
        except Exception as e:  # report, then fail
            rec['error'] = repr(e)[:800]
            failed += 1
        times = {'parent': [], 'new': []}
        for r in range(rounds):
            for arm in ('parent', 'new', 'new', 'parent'):
                ms = cs.time_ms(lambda: call(arm))
                times[arm].append(ms)
                print(json.dumps({'head': str(dtype), 'arm': arm,
                                  'round': r, 'ms': ms,
                                  'nvidia_smi': smi}), flush=True)
        mean = {arm: sum(t) / len(t) for arm, t in times.items()}
        rec.update({'parent_ms': mean['parent'], 'new_ms': mean['new'],
                    'times': times,
                    'speedup': mean['parent'] / mean['new'],
                    'split_ms': {arm: cs.kernel_ms(lambda: call(arm))
                                 for arm in fns},
                    'nvidia_smi': smi})
        print(json.dumps(rec), flush=True)
        del fin, head, g
    return 1 if failed else 0


def unet_norms():
    """{(H, W, C, act): count} of one UNet forward, from the card."""
    from ddg_tpu_torch.entry import unet_flagship
    _, cfg, model, _, _ = unet_flagship(device='cuda')
    norms, _ = cs.unet_forward_census(model, cfg)
    del model
    return norms


def _gn_call(fn, x, scale, bias, G, act, partial):
    from ddg_tpu_torch.ops import _build
    N, H, W, C = x.shape
    HW = H * W
    chunk = min(HW, max(1, 8192 // C))
    y = torch.empty((N, H, W, C), dtype=torch.float32, device='cuda')
    rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if partial is None else partial.data_ptr(), y.data_ptr(),
            N, HW, C, G, chunk, -(-HW // chunk), 1e-6, int(act), 1, 0,
            _build.stream(x))
    _build.check(rc, 'ddg_group_norm')
    return y


def run_k13_ab(parent_source, rounds):
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import groupnorm as gn
    parent, log = build_parent(parent_source)
    print(json.dumps({'parent_ptxas': cs.ptxas_lines(log)}), flush=True)
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['groupnorm'][1])}),
          flush=True)
    smi = cs.nvidia_smi()
    norms = unet_norms()
    fns = {'parent': parent.ddg_group_norm,
           'new': _build.kernel('groupnorm', 'ddg_group_norm', GN_ARGS)}
    for f in fns.values():
        f.argtypes = list(GN_ARGS)
        f.restype = ctypes.c_int
    gen = torch.Generator(device='cuda').manual_seed(13)
    N = 2 * cs.UB
    total = {'parent': [0.0] * rounds, 'new': [0.0] * rounds}
    shapes, failed, forward = [], 0, []
    for (H, W, C, act), count in sorted(norms.items()):
        G = min(C // 4, 32)
        scale = 1.0 + cs._rand(gen, C, scale=0.2)
        bias = cs._rand(gen, C, scale=0.2)
        x = (0.3 + 2.0 * torch.randn((N, H, W, C), generator=gen,
                                     device='cuda')).to(torch.bfloat16)
        chunk = min(H * W, max(1, 8192 // C))
        partial = torch.empty((N, -(-H * W // chunk), G, 2), device='cuda')
        parts = {'parent': partial,
                 'new': partial if gn.plan(H * W, C, G, 2)[0] == 2 else None}

        def call(arm):
            return _gn_call(fns[arm], x, scale, bias, G, act, parts[arm])
        ref = gn.fused_group_norm_act_plain(x, scale, bias, num_groups=G,
                                            act=act, out_dtype=torch.float32)
        out = {arm: call(arm) for arm in fns}
        err = {arm: (o - ref).abs().max().item() for arm, o in out.items()}
        if max(err.values()) > cs.FP32_TOL:
            failed += 1
        times = {'parent': [], 'new': []}
        for r in range(rounds):
            for arm in ('parent', 'new', 'new', 'parent'):
                times[arm].append(cs.time_ms(lambda: call(arm)))
        for arm in times:
            for r in range(rounds):
                total[arm][r] += count * (times[arm][2 * r]
                                          + times[arm][2 * r + 1]) / 2
        rec = {'shape': [N, H, W, C, act], 'count': count,
               'plan': list(gn.plan(H * W, C, G, 2)),
               'parent_ms': sum(times['parent']) / len(times['parent']),
               'new_ms': sum(times['new']) / len(times['new']),
               'times': times, 'err_vs_plain': err,
               'max_abs_diff_new_vs_parent':
                   (out['new'] - out['parent']).abs().max().item()}
        shapes.append(rec)
        print(json.dumps(rec), flush=True)
        forward.append((count, x, scale, bias, G, act, parts))
    # The 51 calls back to back, as a forward runs them (no event between
    # two calls), each arm in turns.
    seq = {'parent': [], 'new': []}
    for r in range(rounds):
        for arm in ('parent', 'new', 'new', 'parent'):
            seq[arm].append(cs.time_ms(lambda: [
                _gn_call(fns[arm], xf, sf, bf, Gf, af, pf[arm])
                for count, xf, sf, bf, Gf, af, pf in forward
                for _ in range(count)], reps=10))
    print(json.dumps({'k13_sequence_of_51': seq,
                      'parent_ms': sum(seq['parent']) / len(seq['parent']),
                      'new_ms': sum(seq['new']) / len(seq['new']),
                      'nvidia_smi': smi}), flush=True)
    print(json.dumps({'k13_sum_over_51': total,
                      'parent_ms': sum(total['parent']) / rounds,
                      'new_ms': sum(total['new']) / rounds,
                      'norms': sum(norms.values()), 'N': N,
                      'nvidia_smi': smi}), flush=True)
    return 1 if failed else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=1000)
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--parent-source')
    ap.add_argument('--k13', action='store_true')
    ap.add_argument('--phases', action='store_true')
    ap.add_argument('--int8', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.DEV = 'cuda'
    if args.phases:
        return run_phases(args.rounds, args.int8)
    if args.parent_source is None:
        if args.k13:
            ap.error('--k13 needs --parent-source')
        return run_sampler(args.steps, args.rounds)
    if not os.path.exists(args.parent_source):
        ap.error('--parent-source names no file')
    if args.k13:
        return run_k13_ab(args.parent_source, args.rounds)
    return run_head_ab(args.parent_source, args.rounds,
                       (torch.int8,) if args.int8 else
                       (torch.bfloat16, torch.float32, torch.int8))


if __name__ == '__main__':
    sys.exit(main())
