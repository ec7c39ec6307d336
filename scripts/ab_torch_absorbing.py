#!/usr/bin/env python3
"""The absorbing denoise step (K7 `fused_absorbing_sample`, K8
`fused_absorbing_cfg_sample`; `csrc/absorbing_sample.cu`) on one card: a
first-call check and a same-call A/B against another copy of the source.

    python3 scripts/ab_torch_absorbing.py --check
    python3 scripts/ab_torch_absorbing.py --parent-source build/ab/absorbing_sample.cu [--rounds 2]
    python3 scripts/ab_torch_absorbing.py --uniform --parent-source build/ab/uniform_sample.cu
    python3 scripts/ab_torch_absorbing.py --uniform --phases

`--check` builds the kernels, prints ptxas's lines for
`absorbing_sample.cu` and runs `chip_smoke.check_sampling`: K7 and K8
against their plain versions at the main shape and `chip_smoke.
SAMPLE_EDGES`, the in-kernel noise against the plain version fed the same
draws, the Gumbel noise against float64, ties, TV, reruns, and the bf16
times (every token masked and half of them) beside the bound and the plain
version. One JSON line; it exits non-zero if a check failed.

With `--parent-source` (an earlier `absorbing_sample.cu`, e.g. `git show
HEAD:ddg_tpu_torch/csrc/absorbing_sample.cu > build/ab/absorbing_sample.cu`;
headers are looked up beside it first, then in `csrc/`) it builds that copy
into `build/ab/` under another library name and, at the LM1B slice (24 x
128 tokens, V = 30523, the mask last), for K7 and K8 in bf16 and fp32,
times the parent's call, the new one, the new one, the parent's (A B B A,
`--rounds` times, CUDA events, `chip_smoke.time_ms`) with every token
masked and with half of them, in-kernel noise. Each arm's tokens are held
against the plain version under one external Gumbel wherever the top-two
gap exceeds `chip_smoke.MARGIN` (half the tokens masked, so decoded ones
must be copied over); with the in-kernel noise the two arms' tokens are
compared and, where they differ, their scores with the Philox draws
rebuilt (`chip_smoke._philox_gumbel`) must lie within MARGIN. Both arms
are called through ctypes on the same inputs. One JSON line per arm and
round, one summary line per (kernel, dtype), beside nvidia-smi's name and
power limit.

With `--uniform` and an earlier `uniform_sample.cu` as `--parent-source`
the same for the uniform step, K9 `fused_uniform_sample` and K10
`fused_uniform_cfg_sample`, in bf16 with in-kernel noise at the shapes of
their main paths: Species10's 8 x 32768 x V=12 and the UNet's 32 x 3072 x
V=256 (A B B A, `--rounds` times). Each arm's tokens are held against the
plain version under one external Gumbel wherever the top-two gap exceeds
`chip_smoke.MARGIN`, and the two arms' tokens must be equal there too.
With the in-kernel noise K10's two arms must be bit-equal (both form K7's
noise, `ddg::gumbel`); where K9's differ (this tree forms K7's noise, a
parent before the one-tensor kernels `ddg::gumbel_from_bits`), the two
tokens' scores with the Philox draws rebuilt (`chip_smoke._philox_gumbel`)
must lie within MARGIN.

`--uniform --phases` times this tree's K9 and K10 at the same shapes
beside copies of `uniform_sample.cu` patched by `UNIFORM_PHASES`, each
without one part of the step (the noise, the noise past each lane's
first pick, Philox, the numerator's log), A B .. B A, with each arm's
kernel ms from the profiler; the copies' tokens are not checked. The last line lists the profiler traces `chip_smoke.
kernel_trace` took again (`trace_retakes`).
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
from ab_torch_attention import build_parent, build_variants  # noqa: E402,E501

ARGS = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4 + (ctypes.c_float,) * 2
        + (ctypes.c_int,) * 2 + (ctypes.c_void_p,))

def _call(fn, seed, xt, lc, lu, mct, mcs, gumbel=None):
    """One call of a `ddg_absorbing_sample` of either version."""
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import fused_sampling as fs
    Bt, Lt, Vt = lc.shape
    out = torch.empty((Bt, Lt), dtype=torch.int32, device='cuda')
    g = 0.0 if lu is None else cs.GAMMA
    rc = fn(seed.data_ptr(), xt.data_ptr(), lc.data_ptr(),
            None if lu is None else lu.data_ptr(), mct.data_ptr(),
            mcs.data_ptr(), None if gumbel is None else gumbel.data_ptr(),
            out.data_ptr(), Bt * Lt, Lt, Vt, cs.MASK, g, 1.0 - g,
            int(lu is not None), fs._DTYPES[lc.dtype], _build.stream(lc))
    _build.check(rc, 'ddg_absorbing_sample')
    return out


def _fns(libs):
    out = {}
    for arm, lib in libs.items():
        f = lib.ddg_absorbing_sample
        f.argtypes = list(ARGS)
        f.restype = ctypes.c_int
        out[arm] = f
    return out


def run_turns(fns, rounds):
    """The arms in turns (A B ... then back) for K7 and K8, bf16 and fp32,
    every token masked and half of them; tokens checked as the module
    docstring says. Returns the number of failed checks."""
    from ddg_tpu_torch.ops import fused_sampling as fs
    smi = cs.nvidia_smi()
    gen = torch.Generator(device='cuda').manual_seed(18)
    B, L, V = cs.B, cs.L, cs.V
    cs.MASK = V - 1
    order = list(fns)
    failed = 0
    for dtype in (torch.bfloat16, torch.float32):
        (lc, lu), _, mct, mcs = cs._sample_inputs(gen, dtype, 2)
        xm = torch.full((B, L), cs.MASK, dtype=torch.int32, device='cuda')
        x0 = torch.randint(0, V - 1, (B, L), generator=gen, device='cuda',
                           dtype=torch.int32)
        xh = torch.where(torch.rand((B, L), generator=gen, device='cuda')
                         < 0.5, torch.full_like(x0, cs.MASK), x0)
        seed = torch.tensor([11], dtype=torch.int32, device='cuda')
        for kernel, lu_k in (('K7', None), ('K8', lu)):
            rec = {'kernel': kernel, 'dtype': str(dtype),
                   'half_masked_share': (xh == cs.MASK).float().mean().item()}
            try:
                z = lc.float() if lu_k is None else fs.cfg_mix(lc, lu, cs.GAMMA)
                g = -torch.log(-torch.log(torch.rand(
                    (B, L, V), generator=gen, device='cuda').clamp_min(1e-20)))
                ref = fs._sample_plain(7, xh, z, mct, mcs, cs.MASK, g)
                scores = fs.perturbed_scores(7, z, mct, mcs,
                                             mask_index=cs.MASK, gumbel=g)
                rec['compared_tokens'] = {arm: cs._token_check(
                    f'{kernel} {dtype} {arm}',
                    _call(fns[arm], seed, xh, lc, lu_k, mct, mcs, g), ref,
                    scores, xh) for arm in order}
                del scores, g, ref
                got = {arm: _call(fns[arm], seed, xm, lc, lu_k, mct, mcs)
                       for arm in order}
                rec['reruns_equal'] = {arm: bool(torch.equal(
                    got[arm], _call(fns[arm], seed, xm, lc, lu_k, mct, mcs)))
                    for arm in order}
                cs.check(all(rec['reruns_equal'].values()), 'a rerun differs')
                rec['tokens_equal_first_arm'] = {
                    arm: bool(torch.equal(got[arm], got[order[0]]))
                    for arm in order[1:]}
                rec['rng_tokens_differ_from_first_arm'] = {
                    arm: cs._rng_gap_check(f'{kernel} {dtype} {arm}',
                                           got[arm], got[order[0]], z, xm,
                                           mct, mcs, 11)
                    for arm in order[1:]}
                del z
            except Exception as e:  # report, then fail
                rec['error'] = repr(e)[:800]
                failed += 1
            for masked, x in (('all', xm), ('half', xh)):
                times = {arm: [] for arm in order}
                for r in range(rounds):
                    for arm in order + order[::-1]:
                        ms = cs.time_ms(lambda: _call(fns[arm], seed, x, lc,
                                                      lu_k, mct, mcs))
                        times[arm].append(ms)
                        print(json.dumps({'kernel': kernel,
                                          'dtype': str(dtype),
                                          'masked': masked, 'arm': arm,
                                          'round': r, 'ms': ms}), flush=True)
                rec[f'ms_{masked}_masked'] = {
                    arm: sum(t) / len(t) for arm, t in times.items()}
                rec[f'times_{masked}_masked'] = times
            rec['split_ms'] = {arm: cs.kernel_ms(lambda: _call(
                fns[arm], seed, xm, lc, lu_k, mct, mcs)) for arm in order}
            rec['nvidia_smi'] = smi
            print(json.dumps(rec), flush=True)
        del lc, lu
    return failed


UNIFORM_ARGS = ((ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4
                + (ctypes.c_float,) * 2 + (ctypes.c_int,) * 3
                + (ctypes.c_void_p,))


def _uniform_call(fn, seed, xt, lc, lu, a_t, a_s, gumbel=None):
    """One call of a `ddg_uniform_sample` of either version (K10 when lu is
    given), vector loads where the wrapper would take them."""
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import fused_sampling as fs
    Bt, Lt, Vt = lc.shape
    rows = [t for t in (lc, lu, gumbel) if t is not None]
    vec = Vt % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in rows)
    out = torch.empty((Bt, Lt), dtype=torch.int32, device='cuda')
    g = 0.0 if lu is None else cs.GAMMA
    rc = fn(seed.data_ptr(), xt.data_ptr(), lc.data_ptr(),
            None if lu is None else lu.data_ptr(), a_t.data_ptr(),
            a_s.data_ptr(), None if gumbel is None else gumbel.data_ptr(),
            out.data_ptr(), Bt * Lt, Lt, Vt, Vt, g, 1.0 - g,
            int(lu is not None), fs._DTYPES[lc.dtype], int(vec),
            _build.stream(lc))
    _build.check(rc, 'ddg_uniform_sample')
    return out


def _uniform_gap(name, a, b, log_q, seed):
    """Where tokens a and b differ, their scores log q + g with the Philox
    draws of `seed` rebuilt must lie within MARGIN; returns how many
    differ."""
    diff = a != b
    n = int(diff.sum().item())
    if n == 0:
        return 0
    bi, li = diff.nonzero(as_tuple=True)
    gaps = []
    for tok in (a[bi, li].long(), b[bi, li].long()):
        g = cs._philox_gumbel(seed, bi, li, tok).double()
        gaps.append(log_q[bi, li].double().gather(-1, tok[:, None])[:, 0] + g)
    worst = (gaps[0] - gaps[1]).abs().max().item()
    cs.check(worst <= cs.MARGIN, f'{name}: {n} tokens differ where the '
                                 f'scores differ by {worst}')
    return n


# (old, new) text of `uniform_sample.cu` for `--uniform --phases`: the
# phases of the one-tensor and two-tensor kernels, each copy without one
# part (its tokens are not checked).
_NARROW_NOISE = ('    unsigned w[N];\n'
                 '    words(w, 0, n, l, b, make_uint2(static_cast<unsigned>'
                 '(seed[0]), 0u));\n'
                 '    const int first = pick_first(lq, w, 0, n, best, '
                 'best_i);\n'
                 '    pick_rest(lq, w, 0, n, first, -INFINITY, best, '
                 'best_i);\n')
_WIDE_NOISE = ('      unsigned w[kWideCols];\n'
               '      words(w, v0, n, l, b, key);\n'
               '      // Each lane\'s column of the largest lq first, then the '
               'rest against\n'
               '      // the warp\'s best.\n'
               '      const int first = t == 0 ? pick_first(zc, w, v0, n, '
               'best, best_i) : -1;\n'
               '      pick_rest(zc, w, v0, n, first, ddg::warp_max(best), '
               'best, best_i);\n')
UNIFORM_PHASES = {
    'no_noise': [(_NARROW_NOISE, '#pragma unroll\n'
                  '    for (int c = 0; c < N; ++c)\n'
                  '      if (c < n) take(best, best_i, lq[c], c);\n'),
                 (_WIDE_NOISE, '#pragma unroll\n'
                  '      for (int c = 0; c < kWideCols; ++c)\n'
                  '        if (v0 + c < n) take(best, best_i, zc[c], v0 + c);'
                  '\n')],
    'first_noise_only': [
        ('    pick_rest(lq, w, 0, n, first, -INFINITY, best, best_i);\n', ''),
        ('      pick_rest(zc, w, v0, n, first, ddg::warp_max(best), best, '
         'best_i);\n', '')],
    'no_philox': [
        ('    const uint4 r = ddg::philox4x32_10(\n',
         '    const uint4 r = cheap4(\n'),
        ('// The Philox words of columns v0',
         '__device__ __forceinline__ uint4 cheap4(uint4 c, uint2 k) {\n'
         '  const unsigned h = (c.x * 0x9E3779B9u) ^ (c.y * 0x85EBCA6Bu) ^ '
         '(c.z * 0xC2B2AE35u) ^ k.x;\n'
         '  return make_uint4(h, h * 747796405u, h ^ 0x5bd1e995u, '
         'h * 0x27d4eb2du);\n}\n\n// The Philox words of columns v0')],
    'no_log': [('    e[c] = __logf(__fadd_rn(num, 1e-35f));\n',
                '    e[c] = num;\n')],
}


def _uniform_arm_checks(rec, fns, kernel, label, ins, gen):
    """The parent's and this tree's tokens (see the module docstring) into
    `rec`; raises if a check fails."""
    from ddg_tpu_torch.ops import fused_sampling as fs
    seed, xt, lc, lu, lu_k, a_t, a_s = ins
    Bt, Lt, Vt = lc.shape
    order = list(fns)
    if lu_k is None:
        log_q = fs.uniform_log_num(lc, xt, a_t, a_s, vocab_size=Vt)
    else:
        log_q = fs.uniform_cfg_log_num(lc, lu, cs.GAMMA, xt, a_t, a_s,
                                       vocab_size=Vt)
    g = -torch.log(-torch.log(torch.rand(
        (Bt, Lt, Vt), generator=gen, device='cuda').clamp_min(1e-20)))
    scores = fs.uniform_perturbed_scores(0, log_q, vocab_size=Vt, gumbel=g)
    ref = torch.argmax(scores, -1).to(torch.int32)
    ext = {arm: _uniform_call(fns[arm], seed, xt, lc, lu_k, a_t, a_s, g)
           for arm in order}
    rec['external_bad_compared'] = {
        arm: cs._uniform_token_check(f'{kernel} {label} {arm}', ext[arm],
                                     ref, scores, Vt)
        for arm in order}
    rec['external_arms_bad_compared'] = cs._uniform_token_check(
        f'{kernel} {label} new against parent', ext['new'], ext['parent'],
        scores, Vt)
    rec['external_arms_equal'] = bool(torch.equal(ext['new'],
                                                  ext['parent']))
    del scores, g, ref, ext
    got = {arm: _uniform_call(fns[arm], seed, xt, lc, lu_k, a_t, a_s)
           for arm in order}
    rec['reruns_equal'] = {arm: bool(torch.equal(
        got[arm], _uniform_call(fns[arm], seed, xt, lc, lu_k, a_t, a_s)))
        for arm in order}
    cs.check(all(rec['reruns_equal'].values()), 'a rerun differs')
    rec['arms_equal'] = bool(torch.equal(got['parent'], got['new']))
    if lu_k is not None:
        cs.check(rec['arms_equal'], f'{kernel}: the arms differ')
    else:
        rec['arms_differ_tokens'] = _uniform_gap(
            f'{kernel} {label}', got['parent'], got['new'], log_q, 11)


def run_uniform(parent_source, rounds, phases=False):
    """K9 and K10 of the parent and of this tree in turns, or with
    `phases` of this tree and UNIFORM_PHASES' copies of it (timed only);
    see the module docstring. Returns the number of failed
    checks."""
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import fused_sampling as fs
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['uniform_sample'][1])}),
          flush=True)
    arms = {'new': ctypes.CDLL(str(libs['uniform_sample'][0]))}
    if phases:
        built = build_variants('uniform_sample.cu', UNIFORM_PHASES)
        for arm, (lib, log) in built.items():
            arms[arm] = lib
            print(json.dumps({'phase': arm, 'ptxas': [
                ln for ln in cs.ptxas_lines(log) if 'registers' in ln
                or 'spill' in ln or 'Compiling' in ln]}), flush=True)
    else:
        parent, log = build_parent(parent_source)
        print(json.dumps({'parent_ptxas': cs.ptxas_lines(log)}), flush=True)
        arms = {'parent': parent, **arms}
    fns = {}
    for arm, lib in arms.items():
        fns[arm] = lib.ddg_uniform_sample
        fns[arm].argtypes = list(UNIFORM_ARGS)
        fns[arm].restype = ctypes.c_int
    smi = cs.nvidia_smi()
    gen = torch.Generator(device='cuda').manual_seed(19)
    order = list(fns)
    failed = 0
    for label, Bt, Lt, Vt in (('species10', cs.SB, cs.SL, cs.SV),
                              ('unet', cs.UB, cs.UL, cs.UV)):
        (lc, lu), xt, a_t, a_s = cs._uniform_inputs(
            gen, torch.bfloat16, Vt, Bu=Bt, Lu=Lt)
        seed = torch.tensor([11], dtype=torch.int32, device='cuda')
        for kernel, lu_k in (('K9', None), ('K10', lu)):
            rec = {'kernel': kernel, 'shape': [Bt, Lt, Vt], 'case': label,
                   'nvidia_smi': smi}
            if not phases:
                try:
                    _uniform_arm_checks(rec, fns, kernel, label,
                                        (seed, xt, lc, lu, lu_k, a_t, a_s),
                                        gen)
                except Exception as e:  # report, then fail
                    rec['error'] = repr(e)[:800]
                    failed += 1
            times = {arm: [] for arm in order}
            for r in range(rounds):
                for arm in order + order[::-1]:
                    ms = cs.time_ms(lambda: _uniform_call(
                        fns[arm], seed, xt, lc, lu_k, a_t, a_s))
                    times[arm].append(ms)
                    print(json.dumps({'kernel': kernel, 'case': label,
                                      'arm': arm, 'round': r, 'ms': ms}),
                          flush=True)
            rec['ms'] = {arm: sum(t) / len(t) for arm, t in times.items()}
            rec['times'] = times
            rec['split_ms'] = {arm: cs.kernel_ms(lambda: _uniform_call(
                fns[arm], seed, xt, lc, lu_k, a_t, a_s)) for arm in order}
            print(json.dumps(rec), flush=True)
        del lc, lu
    return failed


def run_check():
    from ddg_tpu_torch.ops import _build
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['absorbing_sample'][1])}),
          flush=True)
    results = {'fused_absorbing_sample': {}, 'fused_absorbing_cfg_sample': {}}
    try:
        tv = cs.check_sampling(results)
    except Exception as e:  # report, then fail
        print(json.dumps({'check': 'failed', 'error': repr(e)[:2000],
                          'results': results}, default=str), flush=True)
        return 1
    print(json.dumps({'check': 'passed', 'results': results,
                      'internal_rng': tv, 'nvidia_smi': cs.nvidia_smi()},
                     default=str), flush=True)
    return 0


def run_parent(parent_source, rounds):
    from ddg_tpu_torch.ops import _build
    parent, log = build_parent(parent_source)
    print(json.dumps({'parent_ptxas': cs.ptxas_lines(log)}), flush=True)
    libs = _build.build_all()
    print(json.dumps({'ptxas': cs.ptxas_lines(libs['absorbing_sample'][1])}),
          flush=True)
    new = ctypes.CDLL(str(libs['absorbing_sample'][0]))
    return run_turns(_fns({'parent': parent, 'new': new}), rounds)


def _report_retakes():
    """The profiler traces `chip_smoke.kernel_trace` took again (C.9)."""
    print(json.dumps({'trace_retakes': cs.TRACE_RETAKES}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--check', action='store_true')
    ap.add_argument('--parent-source')
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--uniform', action='store_true')
    ap.add_argument('--phases', action='store_true',
                    help='with --uniform: this tree against UNIFORM_PHASES')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device is visible', file=sys.stderr)
        return 1
    cs.DEV = 'cuda'
    if args.check:
        return run_check()
    if args.uniform and args.phases:
        return 1 if run_uniform(None, args.rounds, True) else 0
    if args.parent_source is None or not os.path.exists(args.parent_source):
        ap.error('--parent-source names no file')
    if args.uniform:
        return 1 if run_uniform(args.parent_source, args.rounds) else 0
    return run_parent(args.parent_source, args.rounds)


if __name__ == '__main__':
    rc = main()
    _report_retakes()
    sys.exit(rc)
