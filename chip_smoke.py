#!/usr/bin/env python3
"""Smoke test of `ddg_tpu_torch` on one NVIDIA Hopper card.

    python3 chip_smoke.py        # from the root of a checkout

Each phase prints one JSON line:
  1. environment: nvidia-smi's name and power limit, torch/CUDA versions,
     compute capability (sm_90 required);
  2. build: the CUDA sources under ddg_tpu_torch/csrc, compiled with nvcc
     into build/ddg_tpu_torch/ (seconds, ptxas register/spill lines under
     the lines that name their kernel);
  3. the UNet flagship (seeded random weights), the (H, W, C, act) of
     each GroupNorm of its forward and its multiply-accumulates per image,
     read by hooks; the GroupNorms' count must equal the architecture's
     (51);
  4. kernels against their plain PyTorch versions on the card, at the
     shapes of the main paths, in float32 and bfloat16, with the median
     CUDA-event time of kernel, plain version and (attention forward and
     backward, GroupNorm) the one PyTorch call that computes the same
     function; the adaLN backwards and the GroupNorm also run twice and
     must give bit-identical outputs; the sampling kernels' in-kernel
     Philox noise is held against the exact distribution by TV;
  5. a tiny DiT on the card against the same weights on the CPU (also
     under `quant_int8`: each int8 layer bit for bit on the same input,
     the logits to 1e-3 where no head code flips, and the head-fused
     unguided step, K11 and K12, against the unfused chain under one
     Gumbel), the int8 distribution check of
     `scripts/validate_quant_tpu.py` (TV of the bf16 and int8 posteriors
     under the N=4000 binomial floor), a tiny
     float32 train step (loss, every gradient, and the parameters after
     one clip + AdamW + EMA update) card against CPU, a tiny float32
     UNet (logits and one fused D-CFG step given the same Gumbel noise)
     card against CPU, the same under `quant_int8` (each int8 conv's and
     NiN's codes, int32 sums and output bit for bit on the same input, the
     logits where no activation code flips, the posteriors within twice
     the int8 scheme's own TV), the full-width int8 UNet's D-CFG posterior
     against the bf16 one's (mean and 95th-percentile TV within 1.25x of
     the scheme's own float32 shift; the N=4000 binomial floor printed)
     and a tiny float32 UNet train step card against CPU;
  6. the serving main path at full width: the flagship DiT-small (seeded
     random weights) serving ancestral D-CFG (gamma=2, B=24) through the
     feature-mix path at T=1000, the same with the NFE cache (the CFG
     kernel) at T=128, and first-hitting D-CFG (B=32); then the JAX
     bench's head-fused and int8 lines: feature-mix with `fused_head` (1
     K11 a step) on the bf16 and the int8 flagship (1 K12 a step), the int8
     flagship without it (`ancestral_int8`: 1 K7 a step) and first-hitting
     on it (`first_hitting_int8`), with exact launches (K1, K3, K5 12 a
     forward); samples/s, ms/step, peak memory, host syncs and kernel
     launches per run;
  7. the training main path at full width: `entry.train_flagship()` (LM1B
     DiT-small MDLM, global batch 512 x 128 as micro-batches), warm-up
     steps, then timed steps: tokens/s, ms/step, peak memory, loss, grad
     norm and the kernel launches per micro-step, which must be exact;
  8. the image serving main path at full width and depth:
     `entry.unet_flagship()` (CIFAR10 UNet UDLM) sampling D-CFG (gamma 2)
     and unguided, and `unet_flagship(int8=True)` (the JAX suite's
     `unet_int8` line: 51 int8 convs, 37 int8 NiNs) sampling D-CFG, T=128,
     B=32: samples/s, ms/step, peak memory, busy and idle share and all
     kernel launches a step from one trace, exact launches per step (K10 or
     K9 once, K13 once per GroupNorm) and 0 host syncs per step under
     PyTorch's sync debug mode; then the image training path at full
     width and depth, `entry.unet_train_flagship()` (global batch 512 as
     micro-batches): ms/step, images/s, peak memory, no kernel launched
     (0 K13: the norms' plain versions under autograd), 0 host syncs, the
     idle share of one profiled step, and at the end a 30-step learning
     check on one class-pattern micro-batch (loss at least 10% down);
  9. a learning check at full width: one Zipf-distributed micro-batch,
     lr 3e-4 without warmup, 30 steps; the mean loss of the last 5 must
     be at least 10% below that of the first 5;
 10. the genomics serving main path at full width and depth:
     `entry.dimamba_flagship()` (Species10 DiMamba UDLM, L=32768) sampling
     D-CFG (gamma 2) and unguided, B=8, as many of T=128 steps as fit in
     8 s each: samples/s, ms/step, the
     card's idle share (a few steps under torch.profiler), peak memory,
     exact launches per step (16 K18 calls a forward, K10 or K9 once) and
     0 host syncs per step; then a few D-CFG steps of the same model with
     `fused_block=False`, the unfused chain around K14 (16 calls a
     forward), and as many of the same weights on the 'dt_lowrank' route
     (`dimamba_flagship(route='dt_lowrank')`, the unfused chain around K16:
     16 calls a forward, none of K14 or K18, K10 once a step, 0 host syncs),
     ms/step beside the dense route's;
 11. the genomics training main path at full width and depth:
     `entry.dimamba_train_flagship()` (Species10 DiMamba UDLM, global
     batch 32 x 32768 as micro-batches): warm-up, then timed steps
     (tokens/s, ms/step, peak memory, loss, grad norm), exact launches per
     micro-step (16 K18, 16 K19), 0 host syncs per step and the idle share
     of one profiled step; then a step of the same weights with
     `fused_block=False`, two micro-batches of 4 rows (16 K14, 16 K15 per
     micro-step); then the run on the 'dt_lowrank' route
     (`dimamba_train_flagship(route='dt_lowrank')`, micro-batches of
     DIMAMBA_DTLR_TRAIN_MICRO_BATCH): timed steps, tokens/s, peak memory,
     exactly 16 K16 and 16 K17 per micro-step and none of K14, K15, K18,
     K19, 0 host syncs;
 12. a learning check of the three DiMamba kernel routes (fused block,
     K14/K15, K16/K17) from the same weights and generator: 30 steps on one
     class-structured micro-batch at lr 2e-3, each route's loss at least
     10% down, each unfused route's last-5 mean closer to the fused
     route's than the pooled std of the two routes' last-10 losses;
 13. the text8 training main path at full width and depth:
     `entry.text8_train_flagship()` (DiT-small MDLM at L=256, V=35, global
     batch 512 x 256 as micro-batches) on its three attention routes, K1
     and K1b ('fused_rope': 2 warm-up and 3 timed steps), K2 and its
     backward ('short_seq': 1 and 2) and the library flash attention's K20
     with K21 and K22 ('flash', the JAX bench's `--train --flash-attn`: 1
     and 2): tokens/s, ms/step, peak memory, the idle share of one profiled
     step, exact launches per micro-step (12 attention forwards and 12 of
     each backward kernel of the route and none of the others', 13
     ln_modulate and 12 gate_res_ln_modulate each way), 0 host syncs per
     step and, on every route, no call of the plain di glue
     (`output_grad_dot`: K21 forms di on the card), with K20 and K21 on
     their wgmma kernels;
 14. a learning check of the three text8 routes from the same weights and
     generator: 30 steps on one Zipf micro-batch at lr 3e-4, the bars of
     12 against the 'fused_rope' route;
 15. the reference DiT-small at its own L=1024 (`configs/model/small.yaml`,
     the LM1B vocabulary) through `entry._dit_train_setup`, global batch 32
     as micro-batches of 16, two steps on each attention route: finite
     losses, exact launches (12 attention forwards and 12 of each backward
     kernel of the route a micro-step) and every attention call on the
     tensor cores;
 16. classifier-based guidance, the JAX default suite's `cbg`,
     `cbg_approx` and `nos` lines at full width: first the classifier's
     training (`run_classifier_train_path`: `classifier.
     make_classifier_train_step` on the QM9 flagship's tiny classifier,
     hidden 512, 8 blocks, L=32, V=36, a seeded class-structured batch of
     256, AdamW lr 3e-3, 40 steps: ms/step, exactly 8 each of K1, K3, K5,
     K1b, K4, K6 a step, 0 host syncs, the loss at least 10% down and the
     last step's accuracy above 0.9); then D-CBG exact and first-order on
     `entry.qm9_cbg_flagship()` with that classifier (gamma 2, B=16, T=32,
     chunk 128; `run_cbg_path`: samples/s, ms/step, peak memory, exact
     launches a step (exact: K1 84, K3 85, K5 84; first-order: K1 20, K3
     21, K5 20, K1b, K4, K6 8 each), 0 host syncs, the share of the
     trained class's tokens raised by the guidance, and 4 steps with the
     NFE cache, one host sync a step); then NOS on `entry.nos_flagship()`
     (B=16, T=128, one Adagrad step; `run_nos_path`: K1 12, K5 12, K3 15,
     K4 1 a step, 0 host syncs);
 17. AR sampling: the JAX suite's `ar` and `ar_int8` lines at full width
     and length (`run_ar_path`: `entry.ar_flagship()`, the LM1B DiT-small
     as a causal AR model, D-CFG gamma 2 at B=256 through the KV-cache
     decode, 2B = 512 decode rows, 127 token steps in 4 length buckets, the
     bf16 and the int8 cache: samples/s, ms a token step, peak memory, no
     K kernel launched, 0 host syncs, busy ms and idle share a step from a
     16-step trace; the bf16 decode's logit gap against the float32 decode
     of the same weights; the same line through the full causal forward,
     exactly 12 K1, 13 K3, 12 K5 a step); FUDGE (`run_ar_fudge_path`:
     `entry.ar_fudge_flagship()`, QM9 AR DiT-small and the causal
     small-classifier in `no_pooling`, topk 20, B=16: the classifier first
     trained 20 steps in FUDGE mode, 12 K1 and 12 K1b a step; then exactly
     24 K1 a token step, 0 host syncs, the classifier's log-probability of
     the condition and the share of its tokens raised over unguided
     samples of the same seed); PPLM (`run_ar_pplm_path`: 12 K1 a token
     step, guided tokens differ from unguided ones); the Species10 AR
     baseline (`run_dimamba_ar_path`: the unidirectional DiMamba's state
     decode at B=8, DIMAMBA_AR_STEPS of its 32767 token steps, no K
     kernel, 0 host syncs, busy and idle share a step).
The serving path (6) runs feature-mix at T=1000 (the JAX bench's line) and
records each run under PyTorch's sync debug mode: no host sync in
feature-mix and first-hitting, exactly one a step in the NFE cache (its
validity flag).
Phase 4 holds K7 and K8 (the absorbing step) against their plain versions
at the main shape under an external Gumbel and at SAMPLE_EDGES (V = 37 and
1031, the mask first, mid-row and last, fp32 and bf16, rows at every
16-byte phase, a CFG pair at two phases), their in-kernel noise against
the plain version fed the same Philox draws (`_philox_gumbel`), the
kernels' Gumbel noise against float64 (`ddg_absorbing_gumbel`), ties to
the lowest index and the mask channel where log_stay dominates, reruns
bit-identical; timed in bf16 with every token masked and with half of
them, beside a bound of bytes, SFU results and the noise's issue.
Phase 4 also holds K11 (bf16, fp32) and K12 against their plain versions
at 24 x 128 x 768 x V=30523 and a ragged case (V=1000, the mask in a
non-final tile, L=32): tokens under an external Gumbel, the logits the
kernel forms (K12's bit for bit with `int8_dense`), the in-kernel noise
against fp32 logits + K7 with the same seed (their Philox draws rebuilt in
PyTorch where the two disagree; K12 forms K7's noise, so only near-ties
of the final pick may differ), identical reruns; timed beside the
composite of the unfused path. The bf16 and int8 heads take their wgmma
kernels where `head_plan` says so (held equal to `ddg_head_plan`).
Phase 4 holds K9 and K10 against their plain versions at the UNet's 32 x
3072 x V=256, at V=250 / vocab 243 and at Species10's 8 x 32768 x V=12,
fp32 and bf16, under an external Gumbel; their plan mirror (`uniform_plan`
against `ddg_uniform_plan`, one plan for both), their in-kernel
noise against the plain version fed the same Philox draws and their ties
at every width of UNIFORM_WIDTHS (a thread a row, a warp a row in one turn
and in four), reruns bit-identical, TV of the in-kernel draws at V=20 /
vocab 16 and V=12; K3 and K5 also at the training micro-batches (LM1B 256
x 128, text8 256 x 256), timed, and K3 at ADALN_FWD_SHAPES (D = 64 to
32768, L = 1 and 40), fp32 and bf16, reruns bit-identical, its launch plan
(`ops.adaln.fwd_plan`) equal to `ddg_adaln_fwd_plan`.
Phase 4 holds K20, K21 and K22 (the library flash attention behind the
DiT's `tpu_flash_attn`) against their plain versions on the same inputs,
fp32 and bf16, causal and not, at 48 x 128 x 12 x 64, 256 x 256, 4 x 1024,
L=384 (three key blocks) and D = 32, 40, 128, 160 and 300 (L=128), 256,
384 and 512, with the attention bars (fp32 1e-4 abs; bf16 2 ulp and at
most 1% of each output differing at all; l, m and K21's di to SUM_RTOL),
bit-identical reruns, the tensor cores at bf16 D = 32 and 64 and wgmma for
K20 and K21 at bf16 D = 64, timed beside SDPA (forward) and SDPA's
backward; `ops.flash_attention.flash_plan` must equal the C launch plan
(`ddg_flash_attention_plan`) at each of those shapes.
Phase 4 holds K1, K2 and their backwards at L=128 and L=256 (the text8
micro-batch), at the key-tile edges L=64, 192 and 200, at L=40 with D=64
and D=32 and at L=1024 (the reference DiT-small), requires the tensor-core
path of every bf16 call at D=64, reruns the bf16 forwards and the backwards
for bit-identical outputs, bounds the share of bf16 outputs that differ
from the plain version at all, and holds `ops.attention.forward_plan` and
`backward_plan` equal to the built libraries' launch plans. It also holds
K18 and K14 against their plain versions at the DiMamba's full widths
(fp32 and bf16, both directions' weights, a ragged row tile, a padded last
chunk), timed at the Species10 shape, and K9/K10
at its V=12; and K19 and K15 (the backwards) the same way, twice each with
bit-identical outputs, in bf16 also at the training shape (16 x 32768),
timed there; K16 and K17 (the dt-lowrank scan and its backward) against
their plain versions, fp32 and bf16, at B=2, L=2048, at a ragged channel
tile, at 16 x 32768 and at the dt-lowrank training micro-batch
(DIMAMBA_DTLR_TRAIN_MICRO_BATCH x 32768), K16 also bit for bit against K14
fed its composite delta, K17 rerun bit-identical, K16 timed in bf16 at the
serving shape (16 x 32768) and at the training one, K17 at the training
one beside K15 on the same operands (K17's own part) and with its
workspace past the adjoint's held below M x d x 4 bytes, beside their
composites; K14-K19 at the shapes they were widened to take (d_state 24
and 64, d_conv 6 and 8, hidden 768 with dt_rank 48; the scans also at
d_state 192 with dt_rank 96) against their plain
versions, fp32 and bf16 (fp32 rows to 1e-4 of their largest magnitude,
K14 and K15 also against float64, recorded), the backwards twice each
with bit-identical outputs; and the wrappers' mirror of the kernels'
shared-memory sums (what `ops.mamba`'s `*_takes` accept) against the
sums the built kernels use. Phase 4 also holds K1, K1b and K3-K6 at the
classifier-guided paths' shapes (QM9_ATTENTION, QM9_ADALN_FWD,
QM9_ADALN_BWD: L=32 with 8 heads of 64 and D = 512, and K4 at NOS's
denoiser head), timed under the `qm9*` and `nos_head` labels of the
`kernels` line, and K1 and K1b causal at the AR paths' shapes (AR_ATTENTION:
16 and 320 rows of L=32 with 12 heads of 64, the FUDGE classifier's
training batch of 256 forward and backward), timed causal beside causal
SDPA under the `ar_*` labels. Phase 5 runs a tiny DiT classifier card
against CPU (logits over indices, one-hots and `x_emb`, and CBG's
first-order term through K1b, K4 and K6), tiny float32 AR models card against CPU
(`check_tiny_ar`: the DiT's KV-cache decode on the float and the int8
cache, the decode against the card's full causal forward, KV tokens equal
to full-forward tokens; the DiMamba's state decode, against its full
unidirectional forward through K18), a tiny DiMamba card against CPU and a
tiny DiMamba train step card against CPU on the three kernel routes, a
tiny DiT on the flash route (L=256) card against CPU, and a tiny text8 DiT
train step (L=256) card against CPU on the three attention routes.
Then the `kernels` line, the nvidia-smi line, and the result line
{"ok": true, "device": {...}} last. Any failed check raises, so the run
exits non-zero without a result line; so does a machine without a CUDA
card, or a directory without the package.
"""

import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import torch

MEM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_BF16_TENSOR = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12                # fp32 FLOP/s outside the tensor cores

# Main-path shapes: DiT-small, CFG doubles the batch of 24 in the trunk.
B, L, V = 24, 128, 30523
B2, D, H = 2 * B, 768, 12
DH = D // H
MASK = V - 1
DEV = 'cuda'
GAMMA = 2.0
FP32_TOL = 1e-4
SUM_RTOL = 1e-5
# Gumbel-argmax tokens are compared where the top-two perturbed scores of
# the plain version differ by more than this; closer calls may go either
# way under another summation order.
MARGIN = 1e-4


T_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started ('at_s'), so that its cost can be read."""
    if 'phase' in obj:
        obj = {**obj, 'at_s': time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


STEP_SECONDS = {}


def _step(name, fn, *args, **kwargs):
    """fn(*args, **kwargs), its seconds kept under `name` for the
    'step_seconds' line (printed before the result lines)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    STEP_SECONDS[name] = time.perf_counter() - t0
    return out


def check(ok, msg):
    if not ok:
        raise RuntimeError(f'chip_smoke check failed: {msg}')


def bf16_tol(ref):
    """2 ulp of bf16 at the magnitude of the largest reference value."""
    m = ref.float().abs().max().item()
    return 2.0 * 2.0 ** (math.floor(math.log2(max(m, 1e-30))) - 7)


def time_ms(fn, reps=30, warmup=3):
    """Median device time of one call, ms, from CUDA events between
    back-to-back calls. A sleep kernel holds the stream while the host
    queues all of them, so the host's launch cost stays out of the
    measurement."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0       # upper bound of one enqueue
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 2e-3)))  # ~2 GHz
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def bound(nbytes, ops, peak):
    return bound_mixed(nbytes, ((ops, peak),))


def bound_mixed(nbytes, ops_at_peak):
    """The least time for `nbytes` of traffic and each (operations, peak
    rate) kind of work: the larger of the bytes' time and the slowest
    kind's time."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = max(ops / peak * 1e3 for ops, peak in ops_at_peak)
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_environment():
    cap = torch.cuda.get_device_capability(0)
    emit({'phase': 'environment', 'nvidia_smi': nvidia_smi(),
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'python': sys.version.split()[0], 'capability': list(cap),
          'device_count': torch.cuda.device_count()})
    check(cap == (9, 0), f'need an sm_90 card, found sm_{cap[0]}{cap[1]}')


def ptxas_lines(log):
    """ptxas's register, spill, shared-memory and performance lines of an
    nvcc log, each kernel's under the lines that name it."""
    keep = ('Compiling entry function', 'Function properties for',
            'registers', 'spill', 'Performance')
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln for k in keep)]


def phase_build():
    from ddg_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = [ln for _, log in libs.values() for ln in ptxas_lines(log)]
    emit({'phase': 'build', 'seconds': secs,
          'libraries': sorted(str(p) for p, _ in libs.values()),
          'ptxas': ptxas})


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=DEV)
            * scale).to(dtype)


def _close(name, dtype, out, ref, rel=False):
    """out against ref: fp32 to FP32_TOL, bf16 to 2 ulp of ref's largest
    magnitude. `rel` (the widened DiMamba shapes): fp32 to FP32_TOL of
    ref's largest magnitude where it exceeds 1, as tests/test_torch_mamba*.py
    hold the plain versions (past 1024 one fp32 ulp is over 1e-4)."""
    err = (out.float() - ref.float()).abs().max().item()
    if dtype != torch.float32:
        tol = bf16_tol(ref)
    else:
        tol = FP32_TOL * (max(1.0, ref.float().abs().max().item()) if rel
                          else 1.0)
    check(err <= tol, f'{name} {dtype}: max abs err {err} > {tol}')
    return err, tol


def _adaln_fwd_records(gen, nb, Lr, dtype, D=D, timed=True):
    """K3 and K5 at (nb, Lr, D): each against its plain version and, if
    `timed`, timed beside the bound of `check_adaln`'s count. Returns their
    records."""
    from ddg_tpu_torch.ops import adaln
    es = torch.tensor([], dtype=dtype).element_size()
    x = _rand(gen, nb, Lr, D, dtype=dtype)
    y = _rand(gen, nb, Lr, D, dtype=dtype)
    mod = _rand(gen, nb, 6 * D, scale=0.5, dtype=dtype)
    shift, scale, gate = mod[:, :D], mod[:, D:2 * D], mod[:, 2 * D:3 * D]
    w = 1.0 + _rand(gen, D, scale=0.1)
    recs = {}
    h = adaln.ln_modulate(x, w, shift, scale)
    err, tol = _close(f'ln_modulate {(nb, Lr, D)}', dtype, h,
                      adaln.ln_modulate_plain(x, w, shift, scale))
    check(torch.equal(h, adaln.ln_modulate(x, w, shift, scale)),
          f'ln_modulate {(nb, Lr, D)}: a rerun is not bit-identical')
    recs['ln_modulate'] = {'shape': [nb, Lr, D], 'err': err, 'tol': tol,
                           'bit_identical_rerun': True}
    if timed:
        recs['ln_modulate'].update({
            'ms': time_ms(lambda: adaln.ln_modulate(x, w, shift, scale)),
            'plain_ms': time_ms(lambda: adaln.ln_modulate_plain(
                x, w, shift, scale)),
            **dict(zip(('bound_ms', 'bound_by'), bound(
                2 * nb * Lr * D * es + 4 * D + 2 * nb * D * es,
                8 * nb * Lr * D, PEAK_FP32)))})
    del h
    xn, hn = adaln.gate_res_ln_modulate(y, x, gate, w, shift, scale)
    xr, hr = adaln.gate_res_ln_modulate_plain(y, x, gate, w, shift, scale)
    e1, _ = _close(f'gate_res_ln_modulate x {(nb, Lr, D)}', dtype, xn, xr)
    e2, tol = _close(f'gate_res_ln_modulate h {(nb, Lr, D)}', dtype, hn, hr)
    del xn, hn, xr, hr
    recs['gate_res_ln_modulate'] = {'shape': [nb, Lr, D],
                                    'err': max(e1, e2), 'tol': tol}
    if timed:
        recs['gate_res_ln_modulate'].update({
            'ms': time_ms(lambda: adaln.gate_res_ln_modulate(
                y, x, gate, w, shift, scale)),
            'plain_ms': time_ms(lambda: adaln.gate_res_ln_modulate_plain(
                y, x, gate, w, shift, scale)),
            **dict(zip(('bound_ms', 'bound_by'), bound(
                4 * nb * Lr * D * es + 4 * D + 3 * nb * D * es,
                10 * nb * Lr * D, PEAK_FP32)))})
    return recs


# K3 off the main shapes: (label, B, L, D). D = 64 takes a warp a row of
# one vector a lane, 1280 a team of two warps (bf16) or three (fp32), 8192
# a team of eight (bf16) or sixteen warps re-reading the modulation (fp32),
# 32768 in bf16 the widest row (4096 vectors: 32 warps); L = 40 leaves a
# tile part-filled, L = 1 a block of one row.
ADALN_FWD_SHAPES = (('d64_l40', 3, 40, 64), ('d1280_l40', 3, 40, 1280),
                    ('d768_l1', 8, 1, D), ('d8192_l40', 2, 40, 8192),
                    ('d8192_l1', 3, 1, 8192), ('d32768_l3', 2, 3, 32768))


def check_adaln_fwd_plan(shapes):
    """`ops.adaln.fwd_plan` equals the built kernel's `ddg_adaln_fwd_plan`
    at each (B, L, D) in both dtypes."""
    import ctypes
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import adaln
    fn = _build.kernel('adaln', 'ddg_adaln_fwd_plan',
                       (_build.i32,) * 4 + (_build.i32p,))
    keys = ('rows', 'tiles', 'blocks', 'warps_per_row', 'vectors_per_lane',
            'teams', 'threads', 'hold')
    n = 0
    for nb, Lr, Dr in shapes:
        for dtype, es in ((0, 4), (1, 2)):
            if Dr // (16 // es) > 4096:
                continue
            out = (ctypes.c_int * 8)()
            check(fn(nb, Lr, Dr, dtype, out) == 0,
                  f'ddg_adaln_fwd_plan refused {nb} x {Lr} x {Dr}')
            c = dict(zip(keys, out))
            py = adaln.fwd_plan(nb, Lr, Dr, es)
            check(py == c, f'K3 plan {nb} x {Lr} x {Dr} ({es}-byte rows): '
                  f'{py} in ops.adaln, {c} in csrc')
            n += 1
    return n


def check_adaln_fwd_shapes(results):
    """K3 at ADALN_FWD_SHAPES, fp32 and bf16 (bf16 alone past 4096 fp32
    vectors), the conditioning as chunks of one (B, 6 D) projection:
    against its plain version, and a rerun bit-identical."""
    from ddg_tpu_torch.ops import adaln
    gen = torch.Generator(device=DEV).manual_seed(20)
    for label, nb, Lr, Dr in ADALN_FWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            if Dr // (16 // torch.tensor([], dtype=dtype).element_size()) \
                    > 4096:
                continue
            x = _rand(gen, nb, Lr, Dr, dtype=dtype)
            mod = _rand(gen, nb, 6 * Dr, scale=0.5, dtype=dtype)
            shift, scale = mod[:, :Dr], mod[:, Dr:2 * Dr]
            w = 1.0 + _rand(gen, Dr, scale=0.1)
            h = adaln.ln_modulate(x, w, shift, scale)
            err, tol = _close(f'ln_modulate {label}', dtype, h,
                              adaln.ln_modulate_plain(x, w, shift, scale))
            check(torch.equal(h, adaln.ln_modulate(x, w, shift, scale)),
                  f'ln_modulate {label} {dtype}: a rerun is not '
                  'bit-identical')
            results['ln_modulate'].setdefault(label, {})[str(dtype)] = {
                'shape': [nb, Lr, Dr], 'err': err, 'tol': tol,
                'bit_identical_rerun': True}


# K3 and K5 at the classifier-guided paths' shapes: the tiny classifier
# (D = 512) over a CBG-exact chunk (2048 rows of L=32), over B=16 and over
# the training batch of 256. (label, B, L, D)
QM9_ADALN_FWD = (('qm9', 2048, 32, 512), ('qm9_grad', 16, 32, 512),
                 ('qm9_training', 256, 32, 512))


def check_adaln(results):
    """K3 and K5 against their plain versions at the serving shape (fp32
    and bf16, timed in bf16), and in bf16 at the training paths' micro-
    batches (LM1B 256 x 128, text8 256 x 256, D = 768), timed, and at the
    classifier-guided paths' QM9_ADALN_FWD (fp32 and bf16, timed in bf16);
    K3 also at
    ADALN_FWD_SHAPES, its reruns bit-identical, and its launch plan held
    against csrc's."""
    from ddg_tpu_torch.entry import TEXT8_TRAIN_MICRO_BATCH as tb
    from ddg_tpu_torch.entry import TRAIN_MICRO_BATCH as nb
    from ddg_tpu_torch.ops import adaln
    gen = torch.Generator(device=DEV).manual_seed(3)
    for label, nbr, Lr, Dr in (('lm1b_training', nb, L, D),
                               ('text8_training', tb, 256, D),
                               *QM9_ADALN_FWD):
        for name, rec in _adaln_fwd_records(gen, nbr, Lr, torch.bfloat16,
                                            Dr).items():
            results[name][label] = {str(torch.bfloat16): rec}
    for label, nbr, Lr, Dr in QM9_ADALN_FWD:
        for name, rec in _adaln_fwd_records(gen, nbr, Lr, torch.float32,
                                            Dr, timed=False).items():
            results[name][label][str(torch.float32)] = rec
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        x = _rand(gen, B2, L, D, dtype=dtype)
        y = _rand(gen, B2, L, D, dtype=dtype)
        # gate/shift/scale as chunks of one adaLN projection, as in the
        # model (row stride 6 D).
        mod = _rand(gen, B2, 6 * D, scale=0.5, dtype=dtype)
        shift, scale, gate = mod[:, :D], mod[:, D:2 * D], mod[:, 2 * D:3 * D]
        w = 1.0 + _rand(gen, D, scale=0.1)

        h = adaln.ln_modulate(x, w, shift, scale)
        h_ref = adaln.ln_modulate_plain(x, w, shift, scale)
        err, tol = _close('ln_modulate', dtype, h, h_ref)
        check(torch.equal(h, adaln.ln_modulate(x, w, shift, scale)),
              f'ln_modulate {dtype}: a rerun is not bit-identical')
        rec = {'err': err, 'tol': tol, 'bit_identical_rerun': True}
        if dtype == torch.bfloat16:
            rec['ms'] = time_ms(lambda: adaln.ln_modulate(x, w, shift, scale))
            rec['plain_ms'] = time_ms(
                lambda: adaln.ln_modulate_plain(x, w, shift, scale))
            rec['bound_ms'], rec['bound_by'] = bound(
                2 * B2 * L * D * es + 4 * D + 2 * B2 * D * es,
                8 * B2 * L * D, PEAK_FP32)
        results['ln_modulate'][str(dtype)] = rec

        xn, hn = adaln.gate_res_ln_modulate(y, x, gate, w, shift, scale)
        xr, hr = adaln.gate_res_ln_modulate_plain(y, x, gate, w, shift,
                                                  scale)
        e1, _ = _close('gate_res_ln_modulate x', dtype, xn, xr)
        e2, tol = _close('gate_res_ln_modulate h', dtype, hn, hr)
        rec = {'err': max(e1, e2), 'tol': tol}
        if dtype == torch.bfloat16:
            rec['ms'] = time_ms(lambda: adaln.gate_res_ln_modulate(
                y, x, gate, w, shift, scale))
            rec['plain_ms'] = time_ms(lambda: adaln.gate_res_ln_modulate_plain(
                y, x, gate, w, shift, scale))
            rec['bound_ms'], rec['bound_by'] = bound(
                4 * B2 * L * D * es + 4 * D + 3 * B2 * D * es,
                10 * B2 * L * D, PEAK_FP32)
        results['gate_res_ln_modulate'][str(dtype)] = rec
    check_adaln_fwd_shapes(results)
    n = check_adaln_fwd_plan([(B2, L, D), (nb, L, D), (tb, 256, D)]
                             + [(b, l, d) for _, b, l, d in ADALN_FWD_SHAPES]
                             + [(b, l, d) for _, b, l, d in QM9_ADALN_FWD])
    emit({'phase': 'adaln_fwd_plan_mirror', 'cases': n})


def _qkv_views(gen, shape, dtype):
    """q, k, v as views into one fused qkv projection, as in the model."""
    qkv = _rand(gen, shape[0], shape[1], 3, *shape[2:], dtype=dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _attention_cases(shape, dtype, gen):
    """K1's and K2's forward and backward at one (B, L, H, D) shape, each
    as (name, kernel, plain, yardstick inputs): K1 on views into one qkv
    projection; K2 on a rotated contiguous q and k beside a view of v, as
    the DiT's `pallas_attention` route hands them over. The yardstick
    inputs are SDPA's: rotated, heads-major q, k, v."""
    from ddg_tpu_torch.models.dit import rope_cos_sin
    from ddg_tpu_torch.ops import attention as A
    cos, sin = rope_cos_sin(shape[1], shape[3], device=DEV)
    q, k, v = _qkv_views(gen, shape, dtype)
    do = _rand(gen, *shape, dtype=dtype)
    qr, kr = A.apply_rope(q, cos, sin), A.apply_rope(k, cos, sin)
    sdpa = tuple(t.transpose(1, 2).contiguous() for t in (qr, kr, v))
    return {
        'fused_rope_attention': (
            lambda c: A.fused_rope_attention(q, k, v, cos, sin, causal=c),
            lambda c: A.fused_rope_attention_plain(q, k, v, cos, sin,
                                                   causal=c)),
        'short_seq_attention': (
            lambda c: A.short_seq_attention(qr, kr, v, causal=c),
            lambda c: A.attention_plain(qr, kr, v, causal=c)),
        'fused_rope_attention_bwd': (
            lambda c: A.fused_rope_attention_bwd(q, k, v, cos, sin, do,
                                                 causal=c),
            lambda c: A.fused_rope_attention_bwd_plain(q, k, v, cos, sin, do,
                                                       causal=c)),
        'short_seq_attention_bwd': (
            lambda c: A.short_seq_attention_bwd(qr, kr, v, do, causal=c),
            lambda c: A.short_seq_attention_bwd_plain(qr, kr, v, do,
                                                      causal=c)),
    }, sdpa, do


def _attention_bound(name, shape, es):
    """(bound_ms, bound_by) of K1, K2 or their backwards at `shape`: the
    inputs read once and outputs written once (and the rope tables), against
    the L x L x D products (two forward, five backward) at the bf16
    tensor-core rate."""
    nb, Lq, Hq, Dq = shape
    tensors, products = (7, 5) if name.endswith('_bwd') else (4, 2)
    tables = 2 * Lq * (Dq // 2) * 4 if name.startswith('fused') else 0
    return bound(tensors * nb * Lq * Hq * Dq * es + tables,
                 2 * products * nb * Hq * Lq * Lq * Dq, PEAK_BF16_TENSOR)


def _sdpa_ms(sdpa, do, backward, causal=False):
    """SDPA's time on heads-major q, k, v: the forward, or autograd through
    SDPA minus its forward."""
    import torch.nn.functional as F
    with torch.no_grad():
        fwd = time_ms(lambda: F.scaled_dot_product_attention(
            *sdpa, is_causal=causal))
    if not backward:
        return fwd
    qh, kh, vh = (t.detach().requires_grad_() for t in sdpa)
    doh = do.transpose(1, 2).contiguous()
    return time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal),
        (qh, kh, vh), doh)) - fwd


# K1 and K1b at the classifier-guided paths' shapes (`qm9_cbg_flagship`,
# L=32, one half-filled 64-key tile): the tiny classifier's 8 heads of 64
# over one CBG-exact chunk of 128 edits of B=16 (2048 rows), over B=16 (the
# first-order gradient) and over the training batch of 256; the DiT-small
# denoiser's 12 heads at B=16. (label: (shape, kernels)); the records go
# under each label.
QM9_ATTENTION = {
    'qm9': ((2048, 32, 8, 64), ('fused_rope_attention',)),
    'qm9_grad': ((16, 32, 8, 64), ('fused_rope_attention',
                                   'fused_rope_attention_bwd')),
    'qm9_training': ((256, 32, 8, 64), ('fused_rope_attention',
                                        'fused_rope_attention_bwd')),
    'qm9_denoiser': ((16, 32, 12, 64), ('fused_rope_attention',))}
QM9_LABELS = ('qm9', 'qm9_grad', 'qm9_training', 'qm9_denoiser', 'nos_head')


# The share of a bf16 attention backward's dq, dk or dv elements that may
# differ at all from the plain version's (check_attention): the forward's
# bar, three times the largest share measured on the card (0.34%).
BWD_DIFFERS_BAR = 0.01


def check_attention(results):
    """K1 and K2, forward and backward, against their plain versions,
    causal and not, in fp32 and bf16, at the shapes the main paths give
    them: the LM1B sampling batch 2 x 24 x 128 (K1, K2, K2b), the LM1B
    training micro-batch 256 x 128 (K1, K1b) and the text8 training
    micro-batch x 256 (all four); at the key-tile edges L = 64, 192 and 200
    (one tile, three whole tiles, a ragged last tile; all four); a ragged
    L=40 on both kernel routes (D = 64 on tensor cores, D = 32 on CUDA
    cores; all four); and the reference DiT-small's L=1024 (`long`, 4 x
    1024 x 12 x 64: all four, which take any L); K1 and K1b at the
    classifier-guided paths' L=32 (QM9_ATTENTION, timed); and head widths the
    CUDA-core backward takes on its halved tiles (ROADMAP C.7): 176 and 192
    at L=200, 290 (the widest the forward takes) at L=72, all four. Each
    backward runs twice with bit-identical outputs, each bf16 forward twice
    with bit-identical outputs. In bf16 with D = 64 every call must take the tensor-core path
    (the wrapper's `tensor_core_launches` rise with its `launches`). A bf16
    forward's record also gives the share of its outputs that differ from
    the plain version's at all (`differs_from_plain`), which must stay at
    or under 1%: the 2-ulp bar cannot tell P's rounding point apart, bit
    equality can (the CPU mirror of the two-pass key-tile order gives 0 to
    0.12%, a flash-style order ~45%: tests/test_torch_attention_tiles.py);
    a bf16 backward's gives it for each of dq, dk and dv, each at or under
    BWD_DIFFERS_BAR (the CPU mirror of the two-launch tile order gives 0.1
    to 0.3%: tests/test_torch_attention_bwd_tiles.py).
    The bf16 records of the main
    paths' shapes and of `long` hold the kernel's, plain version's and
    SDPA's CUDA-event medians and the bound; a kernel's main record is at
    the shape of the path that launches it most (K1: LM1B sampling; K1b:
    LM1B training; K2, K2b: text8 training), the others go under their
    shape's label. Returns the (B, L, H, D) shapes checked."""
    from ddg_tpu_torch.entry import TEXT8_TRAIN_MICRO_BATCH, TRAIN_MICRO_BATCH
    from ddg_tpu_torch.ops import attention as A
    gen = torch.Generator(device=DEV).manual_seed(4)
    every = ('fused_rope_attention', 'short_seq_attention',
             'fused_rope_attention_bwd', 'short_seq_attention_bwd')
    shapes = {'lm1b_sampling': ((B2, L, H, DH), ('fused_rope_attention',
                                                  'short_seq_attention',
                                                  'short_seq_attention_bwd')),
              'lm1b_training': ((TRAIN_MICRO_BATCH, L, H, DH),
                                ('fused_rope_attention',
                                 'fused_rope_attention_bwd')),
              'text8_training': ((TEXT8_TRAIN_MICRO_BATCH, 256, H, DH),
                                 every),
              **{f'tile_edges_L{n}': ((2, n, 3, DH), every)
                 for n in (64, 192, 200)},
              'ragged': ((4, 40, 3, DH), every),
              'ragged_d32': ((4, 40, 2, 32), every),
              'long': ((4, 1024, H, DH), every),
              **QM9_ATTENTION,
              **{f'wide_d{D}': ((2, 200, 2, D), every) for D in (176, 192)},
              'wide_d290': ((2, 72, 1, 290), every)}
    untimed = {'ragged', 'ragged_d32', 'tile_edges_L64', 'tile_edges_L192',
               'tile_edges_L200', 'wide_d176', 'wide_d192', 'wide_d290'}
    main = {'fused_rope_attention': 'lm1b_sampling',
            'short_seq_attention': 'text8_training',
            'fused_rope_attention_bwd': 'lm1b_training',
            'short_seq_attention_bwd': 'text8_training'}
    for label, (shape, names) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.tensor([], dtype=dtype).element_size()
            cases, sdpa, do = _attention_cases(shape, dtype, gen)
            for name in names:
                call, plain = cases[name]
                rec = {'shape': list(shape), 'err': 0.0}
                wrapper = getattr(A, name)
                for causal in (False, True):
                    before = (wrapper.launches, wrapper.tensor_core_launches)
                    if name.endswith('_bwd'):
                        _bwd_case(rec, f'{name} {label} causal={causal}',
                                  dtype, (('dq', 'row'), ('dk', 'row'),
                                          ('dv', 'row')),
                                  lambda: call(causal), lambda: plain(causal),
                                  differs_bar=(BWD_DIFFERS_BAR
                                               if dtype == torch.bfloat16
                                               else None))
                        rec['bit_identical_rerun'] = True
                    else:
                        out, ref = call(causal), plain(causal)
                        err, rec['tol'] = _close(
                            f'{name} {label} causal={causal}', dtype, out,
                            ref)
                        rec['err'] = max(rec['err'], err)
                        if dtype == torch.bfloat16:
                            check(torch.equal(out, call(causal)),
                                  f'{name} {label} causal={causal}: a rerun '
                                  f'differs')
                            rec['bit_identical_rerun'] = True
                            rec['differs_from_plain'] = max(
                                rec.get('differs_from_plain', 0.0),
                                (out != ref).float().mean().item())
                            check(rec['differs_from_plain'] <= 0.01,
                                  f'{name} {label} causal={causal}: '
                                  f'{rec["differs_from_plain"]:.4f} of the '
                                  f'outputs differ from the plain version')
                    calls = wrapper.launches - before[0]
                    on_tc = wrapper.tensor_core_launches - before[1] == calls
                    if dtype == torch.bfloat16 and shape[3] == 64:
                        check(on_tc, f'{name} {label}: bf16 at D=64, '
                                     f'L={shape[1]} missed the tensor cores')
                    rec['tensor_cores'] = on_tc
                if dtype == torch.bfloat16 and label not in untimed:
                    rec['ms'] = time_ms(lambda: call(False))
                    rec['plain_ms'] = time_ms(lambda: plain(False), reps=10)
                    rec['library_ms'] = _sdpa_ms(sdpa, do,
                                                 name.endswith('_bwd'))
                    rec['library'] = ('SDPA backward (autograd through SDPA '
                                      'minus its forward)'
                                      if name.endswith('_bwd') else 'SDPA')
                    rec['bound_ms'], rec['bound_by'] = _attention_bound(
                        name, shape, es)
                if main[name] == label:
                    results[name].setdefault(str(dtype), {}).update(rec)
                else:
                    results[name].setdefault(label, {})[str(dtype)] = rec
    return [shape for shape, _ in shapes.values()]


# K20-K22, the library flash attention behind the DiT's `tpu_flash_attn`
# route: (B, L, H, D) shapes of `check_flash_attention` and the kernels'
# names (`ops.flash_attention`'s wrappers).
FLASH = ('flash_attention_fwd', 'flash_attention_bwd_dkv',
         'flash_attention_bwd_dq')
FLASH_SHAPES = {'lm1b_sampling': (48, 128, 12, 64),
                'text8_training': (256, 256, 12, 64),
                'long': (4, 1024, 12, 64),
                'odd_blocks_L384': (2, 384, 3, 64),
                'd32': (2, 256, 2, 32),
                'd40': (2, 256, 2, 40),
                'd128': (2, 256, 2, 128),
                'd160_one_block': (2, 128, 2, 160),
                'd256': (2, 256, 2, 256),
                'd300_one_block': (2, 128, 2, 300),
                'd384': (2, 256, 2, 384),
                'd512': (2, 256, 2, 512)}
# The products each kernel forms, in units of B H L^2 D multiply-adds: S
# and P V (K20); S^T, dP^T, dV and dK (K21); S, dP and dQ (K22).
FLASH_PRODUCTS = {'flash_attention_fwd': 2, 'flash_attention_bwd_dkv': 4,
                  'flash_attention_bwd_dq': 3}


def _flash_inputs(shape, dtype, gen, causal):
    """q, k as the flash route hands them over (rotated, contiguous) beside
    a view of v into the fused projection, do, and the plain forward's l,
    m and o with di = sum(o * do): (l, m, o, di), the backward kernels'
    inputs (K21 forms di from o, K22 takes the plain one)."""
    from ddg_tpu_torch.models.dit import rope_cos_sin
    from ddg_tpu_torch.ops import attention as A
    from ddg_tpu_torch.ops import flash_attention as FA
    cos, sin = rope_cos_sin(shape[1], shape[3], device=DEV)
    q, k, v = _qkv_views(gen, shape, dtype)
    q, k = A.apply_rope(q, cos, sin), A.apply_rope(k, cos, sin)
    do = _rand(gen, *shape, dtype=dtype)
    sc = 1.0 / math.sqrt(shape[3])
    o, l, m = FA.flash_attention_fwd_plain(q, k, v, causal=causal,
                                           sm_scale=sc)
    return (q, k, v), do, (l, m, o, FA.output_grad_dot(o, do)), sc


def _flash_bound(name, shape, es):
    """(bound_ms, bound_by) of K20, K21 or K22 at `shape`, not causal: q,
    k, v (and do; K21 also o) read once, the outputs written once, l, m
    and di as fp32 rows (K21 writes di, K22 reads it), against its products
    at the bf16 tensor-core rate."""
    nb, Lq, Hq, Dq = shape
    rows = nb * Hq * Lq * 4
    tensors = {'flash_attention_fwd': (4, 2),
               'flash_attention_bwd_dkv': (7, 3),
               'flash_attention_bwd_dq': (5, 3)}[name]
    return bound(tensors[0] * nb * Lq * Hq * Dq * es + tensors[1] * rows,
                 2 * FLASH_PRODUCTS[name] * nb * Hq * Lq * Lq * Dq,
                 PEAK_BF16_TENSOR)


def _flash_cases(qkv, do, stats, kw):
    """{name: (kernel call, plain call, outputs compared as rows)} of
    K20-K22 on the same inputs; every call returns a tuple (K20: o, l, m;
    K21: dk, dv, di; K22: dq)."""
    from ddg_tpu_torch.ops import flash_attention as FA
    l, m, o, di = stats
    dkv = (*qkv, l, m, do, o)
    dq = (*qkv, l, m, do, di)
    return {
        'flash_attention_fwd': (
            lambda: FA.flash_attention_fwd(*qkv, **kw),
            lambda: FA.flash_attention_fwd_plain(*qkv, **kw),
            (('o', 'row'),)),
        'flash_attention_bwd_dkv': (
            lambda: FA.flash_attention_bwd_dkv(*dkv, **kw),
            lambda: FA.flash_attention_bwd_dkv_plain(*dkv, **kw),
            (('dk', 'row'), ('dv', 'row'))),
        'flash_attention_bwd_dq': (
            lambda: (FA.flash_attention_bwd_dq(*dq, **kw),),
            lambda: (FA.flash_attention_bwd_dq_plain(*dq, **kw),),
            (('dq', 'row'),))}


# The fp32 rows each kernel writes beside its outputs, held to SUM_RTOL of
# their largest magnitude: K20's l and m, K21's di.
FLASH_ROWS = {'flash_attention_fwd': ((1, 'l'), (2, 'm')),
              'flash_attention_bwd_dkv': ((2, 'di'),),
              'flash_attention_bwd_dq': ()}


def check_flash_attention(results, shapes=None, timed=True):
    """K20, K21 and K22 against their plain versions on the same inputs,
    causal and not, fp32 and bf16, at FLASH_SHAPES: the LM1B serving batch
    48 x 128 (one key block: the library's single-step forward), the text8
    training micro-batch x 256, the reference DiT-small's L=1024 (4 x 1024
    x 12), an odd count of key blocks (L=384) and head widths 32, 40, 128,
    160 and 300 (one key block: the library takes them there only), 256,
    384 and 512, the widest the kernels take (in bf16 only 32 and 64 run on
    the tensor cores, 64 on wgmma). Bars: fp32 1e-4 abs; bf16 2 ulp of the
    largest magnitude, with at most 1% of each output (o, dk, dv, dq)
    differing from the plain version at all (the 2-ulp bar cannot see
    where p is rounded; bit equality can); K20's l and m and K21's di
    (fp32, K21's against `output_grad_dot`) to SUM_RTOL of their largest
    magnitude. Every call runs twice with bit-identical outputs, every bf16
    call with D a multiple of 16 up to 64 takes the tensor cores, and at D
    = 64 K20, K21 and K22 take wgmma (each record names its path). The bf16
    records at the main paths' shapes (text8 training is a kernel's main
    record) hold the kernel's, the plain version's and SDPA's CUDA-event
    medians (K21 and K22: SDPA's backward, autograd through SDPA minus its
    forward, which gives dq, dk and dv together) and the bound. Returns
    the shapes it ran."""
    from ddg_tpu_torch.ops import flash_attention as FA
    gen = torch.Generator(device=DEV).manual_seed(5)
    timed_labels = ('lm1b_sampling', 'text8_training', 'long')
    shapes = shapes or FLASH_SHAPES
    for label, shape in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            D = shape[3]
            tc_path = dtype == torch.bfloat16 and D % 16 == 0 and D <= 64
            recs = {name: {'shape': list(shape), 'err': 0.0}
                    for name in FLASH}
            for causal in (False, True):
                qkv, do, stats, sc = _flash_inputs(shape, dtype, gen, causal)
                cases = _flash_cases(qkv, do, stats,
                                     dict(causal=causal, sm_scale=sc))
                for name, (call, plain, outs) in cases.items():
                    rec, wrapper = recs[name], getattr(FA, name)
                    before = (wrapper.launches, wrapper.tensor_core_launches,
                              wrapper.wgmma_launches)
                    tag = f'{name} {label} causal={causal}'
                    got = _bwd_case(rec, tag, dtype, outs, call, plain,
                                    differs_bar=(0.01 if dtype ==
                                                 torch.bfloat16 else None))
                    if FLASH_ROWS[name]:
                        ref, again = plain(), call()
                        for i, what in FLASH_ROWS[name]:
                            err = ((got[i] - ref[i]).abs().max()
                                   / ref[i].abs().max()).item()
                            check(torch.equal(got[i], again[i]),
                                  f'{tag}: {what} reruns differ')
                            check(err <= SUM_RTOL, f'{tag}: {what} off by '
                                  f'{err} of its largest magnitude')
                            rec[f'{what}_err_of_max'] = max(
                                rec.get(f'{what}_err_of_max', 0.0), err)
                    n = wrapper.launches - before[0]
                    on_tc = wrapper.tensor_core_launches - before[1] == n
                    on_wg = wrapper.wgmma_launches - before[2] == n
                    check(on_tc == tc_path, f'{tag} {dtype}: tensor cores '
                          f'{on_tc}, expected {tc_path}')
                    want_wg = tc_path and D == 64
                    check(on_wg == want_wg, f'{tag} {dtype}: wgmma {on_wg}, '
                          f'expected {want_wg}')
                    rec['tensor_cores'] = on_tc
                    rec['path'] = FA.PATHS[2 if on_wg else int(on_tc)]
                    rec['bit_identical_rerun'] = True
            if timed and dtype == torch.bfloat16 and label in timed_labels:
                qkv, do, stats, sc = _flash_inputs(shape, dtype, gen, False)
                sdpa = tuple(t.transpose(1, 2).contiguous() for t in qkv)
                lib = {bwd: _sdpa_ms(sdpa, do, bwd) for bwd in (False, True)}
                cases = _flash_cases(qkv, do, stats,
                                     dict(causal=False, sm_scale=sc))
                for name, (call, plain, _) in cases.items():
                    rec, bwd = recs[name], name != 'flash_attention_fwd'
                    rec['ms'] = time_ms(call)
                    rec['plain_ms'] = time_ms(plain, reps=10)
                    rec['library_ms'] = lib[bwd]
                    rec['library'] = ('SDPA backward (autograd through SDPA '
                                      'minus its forward: dq, dk and dv '
                                      'together)' if bwd else 'SDPA')
                    rec['bound_ms'], rec['bound_by'] = _flash_bound(
                        name, shape, torch.tensor([], dtype=dtype)
                        .element_size())
            for name in FLASH:
                if label == 'text8_training':
                    results[name].setdefault(str(dtype), {}).update(recs[name])
                else:
                    results[name].setdefault(label, {})[str(dtype)] = \
                        recs[name]
    return list(shapes.values())


def check_flash_plan(shapes):
    """`ops.flash_attention.flash_plan` (the launch plan the CPU tests
    check) equals the built library's `ddg_flash_attention_plan` at every
    shape `check_flash_attention` ran, in fp32 and bf16, rows aligned or
    not, and both refuse a head width past 512 (D=640 at L=128) and the
    library's refusals (D=160 past one key block)."""
    import ctypes
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import flash_attention as FA
    fn = _build.kernel('flash_attention', 'ddg_flash_attention_plan',
                       (_build.i32,) * 6 + (_build.i32p,))
    fields = ('path', 'tile', 'step', 'stages', 'smem', 'threads')
    for shape in list(shapes) + [(2, 128, 2, 640), (2, 256, 2, 160)]:
        for dtype in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                out = (ctypes.c_int * 27)()
                rc = fn(*shape, FA._DTYPES[dtype], int(aligned), out)
                try:
                    want = FA.flash_plan(*shape, dtype, aligned=aligned)
                except (ValueError, NotImplementedError):
                    want = None
                tag = f'flash plan {shape} {dtype} aligned={aligned}'
                check((rc == 0) == (want is not None),
                      f'{tag}: C returns {rc}, Python {want}')
                if want is None:
                    continue
                for i, kern in enumerate(('fwd', 'dkv', 'dq')):
                    v = list(out[9 * i:9 * i + 9])
                    got = dict(zip(fields, v[:6]), grid=tuple(v[6:9]))
                    check(got == want[kern], f'{tag} {kern}: C {got}, '
                          f'Python {want[kern]}')


def _plan_launch(v):
    return dict(zip(('q_tile', 'k_tile', 'stages', 'smem', 'threads'), v[:5]),
                grid=tuple(v[5:8]))


def check_attention_plan(shapes):
    """`ops.attention.forward_plan` and `backward_plan` (the launch plans
    the CPU tests check) equal the built libraries' `ddg_attention_fwd_plan`
    and `ddg_attention_bwd_plan` at every shape `check_attention` ran, in
    fp32 and bf16, rows aligned or not, and each pair refuses the same head
    widths (290 is the widest the CUDA-core forward's shared memory holds,
    and the CUDA-core backward, whose tiles halve past 174, takes it too)."""
    import ctypes
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import attention as A
    i32 = _build.i32
    fwd = _build.kernel('rope_attention', 'ddg_attention_fwd_plan',
                        (i32,) * 6 + (_build.i32p,))
    bwd = _build.kernel('rope_attention_bwd', 'ddg_attention_bwd_plan',
                        (i32,) * 6 + (_build.i32p,))
    dtypes = {torch.float32: 0, torch.bfloat16: 1}
    cases = [(*shape, dtype, aligned) for shape in shapes
             for dtype in dtypes for aligned in (True, False)]
    cases += [(1, 16, 1, D, torch.float32, True)
              for D in (174, 176, 290, 292)]
    for Bq, Lq, Hq, Dq, dtype, aligned in cases:
        args = (Bq, Lq, Hq, Dq, dtypes[dtype], int(aligned))
        out = (ctypes.c_int * 9)()
        rc = fwd(*args, out)
        try:
            py = A.forward_plan(Bq, Lq, Hq, Dq, dtype, aligned=aligned)
        except ValueError:
            py = None
        c = None if rc else dict(zip(
            ('path', 'q_tile', 'k_tile', 'stages', 'smem', 'threads'),
            out[:6]), grid=tuple(out[6:]))
        check(py == c, f'forward plan of {(Bq, Lq, Hq, Dq)} {dtype} '
              f'aligned={aligned}: {py} in ops.attention, {c} in csrc')
        out = (ctypes.c_int * 22)()
        rc = bwd(*args, out)
        try:
            py = A.backward_plan(Bq, Lq, Hq, Dq, dtype, aligned=aligned)
        except ValueError:
            py = None
        rope = (dict(threads=out[18], grid=tuple(out[19:22])) if out[18]
                else None)
        c = None if rc else dict(path=out[0], stats_len=out[1],
                                 q=_plan_launch(out[2:10]),
                                 kv=_plan_launch(out[10:18]), rope=rope)
        check(py == c, f'backward plan of {(Bq, Lq, Hq, Dq)} {dtype} '
              f'aligned={aligned}: {py} in ops.attention, {c} in csrc')
    emit({'phase': 'attention_plan_mirror', 'cases': len(cases)})


def _sample_inputs(gen, dtype, n_logits):
    logits = [_rand(gen, B, L, V, scale=2.0, dtype=dtype)
              for _ in range(n_logits)]
    x0 = torch.randint(0, V - 1, (B, L), generator=gen, device=DEV,
                       dtype=torch.int32)
    masked = torch.rand((B, L), generator=gen, device=DEV) < 0.7
    xt = torch.where(masked, torch.full_like(x0, MASK), x0)
    mct = 0.4 + 0.5 * torch.rand((B,), generator=gen, device=DEV)
    mcs = 0.6 * mct
    return logits, xt, mct, mcs


def _token_check(name, out, ref, scores, xt, vocab=None, mask=None):
    """Identical tokens where the top-two perturbed scores differ by more
    than MARGIN; decoded positions copied over exactly; every token below
    `vocab` (default V). `mask`: the mask index (default MASK)."""
    vocab = vocab or V
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > MARGIN
    masked = xt == (MASK if mask is None else mask)
    bad = ((out != ref) & decided & masked).sum().item()
    check(bad == 0, f'{name}: {bad} tokens differ where the margin > '
                    f'{MARGIN}')
    check(torch.equal(out[~masked], xt[~masked]),
          f'{name}: decoded tokens not copied over')
    check(bool(((out >= 0) & (out < vocab)).all()),
          f'{name}: token outside V')
    return int(decided[masked].sum().item())


def _tie_check(fs):
    """All scores equal outside the mask channel: the lowest index wins,
    with the mask first, in the middle and last; with log_stay far above
    every other score the mask channel wins."""
    Bt, Lt, Vt = 2, 4, 40
    z = torch.zeros((Bt, Lt, Vt), device=DEV)
    g = torch.zeros_like(z)
    mct = torch.full((Bt,), 0.9, device=DEV)
    for mask, mcs_value, want in ((Vt - 1, 1e-3, 0), (0, 1e-3, 1),
                                  (Vt // 2, 1e-3, 0), (Vt // 2, 0.8999,
                                                       Vt // 2)):
        xt = torch.full((Bt, Lt), mask, dtype=torch.int32, device=DEV)
        mcs = torch.full((Bt,), mcs_value, device=DEV)
        a = fs.fused_absorbing_sample(0, xt, z, mct, mcs, mask_index=mask,
                                      gumbel=g)
        c = fs.fused_absorbing_cfg_sample(0, xt, z, z, GAMMA, mct, mcs,
                                          mask_index=mask, gumbel=g)
        check(bool((a == want).all()) and bool((c == want).all()),
              f'mask {mask}, mcs {mcs_value}: every token must be {want} '
              '(ties to the lowest index; the mask channel where log_stay '
              'dominates)')


def _tv_check(fs):
    """Internal-RNG draws against the exact posterior at small V: TV below
    twice the binomial floor 0.5 sum_v sqrt(2 q_v (1 - q_v) / (pi N))."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    Bt, Lt, Vt = 64, 1024, 16
    n = Bt * Lt
    row_c = torch.randn((Vt,), generator=gen, device=DEV)
    row_u = torch.randn((Vt,), generator=gen, device=DEV)
    xt = torch.full((Bt, Lt), Vt - 1, dtype=torch.int32, device=DEV)
    mct = torch.full((Bt,), 0.8, device=DEV)
    mcs = torch.full((Bt,), 0.3, device=DEV)
    out = {}
    for name, z_row, call in (
            ('fused_absorbing_sample', row_c,
             lambda: fs.fused_absorbing_sample(
                 1234, xt, row_c.expand(Bt, Lt, Vt).contiguous(), mct, mcs,
                 mask_index=Vt - 1)),
            ('fused_absorbing_cfg_sample', GAMMA * row_c + (1 - GAMMA) * row_u,
             lambda: fs.fused_absorbing_cfg_sample(
                 4321, xt, row_c.expand(Bt, Lt, Vt).contiguous(),
                 row_u.expand(Bt, Lt, Vt).contiguous(), GAMMA, mct, mcs,
                 mask_index=Vt - 1))):
        z = z_row.clone()
        z[Vt - 1] = -1e30
        p = torch.softmax(z, -1) * (0.8 - 0.3)
        p[Vt - 1] = 0.3
        q = (p / p.sum()).double()
        hist = torch.bincount(call().flatten().long(),
                              minlength=Vt).double() / n
        tv = 0.5 * (hist - q).abs().sum().item()
        floor = 0.5 * torch.sqrt(2 * q * (1 - q) / (math.pi * n)).sum().item()
        check(tv < 2 * floor, f'{name} internal RNG: TV {tv} >= 2 x floor '
                              f'{floor}')
        out[name] = {'tv': tv, 'floor': floor, 'draws': n}
    return out


def _close_sum(name, dtype, out, ref):
    """Sums over L or B*L rows, taken in another order than the plain
    version: fp32 to 1e-5 of the reference's largest magnitude; bf16 as
    the rows, 2 ulp of that magnitude."""
    err = (out.float() - ref.float()).abs().max().item()
    tol = (SUM_RTOL * ref.float().abs().max().item()
           if out.dtype == torch.float32 else bf16_tol(ref))
    check(err <= tol, f'{name} {dtype}: max abs err {err} > {tol}')
    return err


# K4 and K6 beyond the training shapes: one batch row, an L off the
# blocks' 64 rows, and rows of 512 and 1024 16-byte vectors (D = 4096 and
# 8192 in bf16, 4096 in fp32: a row to a team of 4 and 8 warps).
# (label, B, L, D, dtypes)
ADALN_BWD_SHAPES = (('b1', 1, 128, D, (torch.float32, torch.bfloat16)),
                    ('l100', 4, 100, D, (torch.float32, torch.bfloat16)),
                    ('d4096', 2, 64, 4096, (torch.float32, torch.bfloat16)),
                    ('d8192', 2, 64, 8192, (torch.bfloat16,)))
# K4 and K6 at the classifier-guided paths' shapes: the tiny classifier's
# first-order CBG gradient (16 x 32 x 512) and its training batch (256 x 32
# x 512); K4 also at NOS's denoiser head (16 x 128 x 768). Timed in bf16.
QM9_ADALN_BWD = (('qm9_grad', 16, 32, 512, (torch.float32, torch.bfloat16)),
                 ('qm9_training', 256, 32, 512,
                  (torch.float32, torch.bfloat16)),
                 ('nos_head', 16, L, D, (torch.float32, torch.bfloat16)))


# Traces that `kernel_trace` took again because device records were lost.
TRACE_RETAKES = []


def kernel_trace(fn, reps=20, tries=4):
    """{kernel name: (launches, device ms)} a call of `fn`, by kernel name
    (the part of the name before its template arguments), from one
    torch.profiler trace of `reps` calls after a warm-up. Short sleep
    kernels (`spin_kernel`, three on each side, a synchronize between them
    and the calls) open and close the traced calls. CUPTI
    hands device records over asynchronously, and a trace has come back
    without some of them: once with no kernel of one K13 launch, once with
    one of the two single sleep kernels the bracket had then. A trace in
    which no sleep kernel came before the first traced kernel, or none
    after the last, is taken again, at most `tries` times in all (each
    retake is noted in TRACE_RETAKES), and the check fails if none is
    whole. The sleep kernels are not counted."""
    import os
    import tempfile
    pad = 3
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(pad):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            for _ in range(pad):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'trace.json')
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)['traceEvents']
        out, spins, ts = {}, [], []
        for e in events:
            if e.get('cat') != 'kernel':
                continue
            name = e['name'].split('<')[0].split('::')[-1].split('(')[0]
            name = (name.split() or [e['name'][:48]])[-1]
            if name == 'spin_kernel':
                spins.append(e['ts'])
                continue
            ts.append(e['ts'])
            n, ms = out.get(name, (0, 0.0))
            out[name] = (n + 1, ms + e['dur'] / 1e3)
        if ts:
            opened = sum(t < min(ts) for t in spins)
            closed = sum(t > max(ts) for t in spins)
        else:
            opened = closed = len(spins) // 2
        if opened and closed:
            break
        TRACE_RETAKES.append({'attempt': attempt, 'opening': opened,
                              'closing': closed, 'kernels': len(ts)})
    check(opened and closed, f'{tries} profiler traces in a row lost device '
          f'records (sleep kernels seen in the last: {opened} of {pad} '
          f'before the traced kernels, {closed} of {pad} after)')
    check(out, 'the profiler recorded no kernel on the card')
    return {k: (n / reps, ms / reps) for k, (n, ms) in out.items()}


def kernel_ms(fn, reps=20):
    """Device ms a call of `fn` by kernel name (`kernel_trace`)."""
    return {k: ms for k, (_, ms) in kernel_trace(fn, reps).items()}


def kernel_launches(fn):
    """{kernel name: launches} of one call of `fn` (`kernel_trace`)."""
    return {k: int(n) for k, (n, _) in kernel_trace(fn, 1).items()}


def _adaln_bwd_inputs(gen, nb, Lr, Dr, dtype):
    x = _rand(gen, nb, Lr, Dr, dtype=dtype)
    y = _rand(gen, nb, Lr, Dr, dtype=dtype)
    dx = _rand(gen, nb, Lr, Dr, dtype=dtype)
    dh = _rand(gen, nb, Lr, Dr, dtype=dtype)
    mod = _rand(gen, nb, 6 * Dr, scale=0.5, dtype=dtype)
    scale, gate = mod[:, Dr:2 * Dr], mod[:, 2 * Dr:3 * Dr]
    w = 1.0 + _rand(gen, Dr, scale=0.1)
    return x, y, gate, w, scale, dx, dh


def _adaln_bwd_composite(x, y, gate, w, scale, dx, dh):
    """The same grads from library calls in the rows' dtype (the yardstick):
    the LN statistics and xn (`native_layer_norm`), dxn = dh w (1 + scale),
    dx_ln (`native_layer_norm_backward`), the column sums and, with y, the
    residual terms."""
    aten = torch.ops.aten
    Dr = x.shape[-1]
    xn, mean, rstd = aten.native_layer_norm(x, [Dr], None, None, 1e-5)
    sc = 1.0 + scale.float()
    dxn = (dh * (w * sc)[:, None]).to(x.dtype)
    dx_ln = aten.native_layer_norm_backward(dxn, x, [Dr], mean, rstd, None,
                                            None, [True, False, False])[0]
    dhf = dh.float()
    s = (dhf * xn.float()).sum(1)
    conds = (dhf.sum(1).to(x.dtype), (s * w).to(x.dtype))
    dw = (s * sc).sum(0)
    if y is None:
        return (dx_ln, dw, *conds)
    dx_tot = dx + dx_ln
    return (dx_tot * gate[:, None], dx_tot,
            (dx_tot.float() * y.float()).sum(1).to(x.dtype), dw, *conds)


def _adaln_bwd_cases(adaln, x, y, gate, w, scale, dx, dh):
    """(name, kernel call, plain call, composite call, row outputs)."""
    return (('ln_modulate_bwd',
             lambda: adaln.ln_modulate_bwd(x, w, scale, dh),
             lambda: adaln.ln_modulate_bwd_plain(x, w, scale, dh),
             lambda: _adaln_bwd_composite(x, None, None, w, scale, None,
                                          dh), 1),
            ('gate_res_ln_modulate_bwd',
             lambda: adaln.gate_res_ln_modulate_bwd(x, y, gate, w, scale,
                                                    dx, dh),
             lambda: adaln.gate_res_ln_modulate_bwd_plain(
                 x, y, gate, w, scale, dx, dh),
             lambda: _adaln_bwd_composite(x, y, gate, w, scale, dx, dh), 2))


def _adaln_bwd_hold(name, dtype, out, again, ref, n_rows):
    """The bars and the rerun's bits: row grads at `_close`'s, the sums
    (dgate, dw, dshift, dscale) at `_close_sum`'s."""
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f'{name} {dtype}: a rerun is not bit-identical')
    rec = {'err': 0.0, 'sum_err': 0.0, 'bit_identical_rerun': True}
    for i, (o, r) in enumerate(zip(out, ref)):
        if i < n_rows:      # the row grads
            e, rec['tol'] = _close(f'{name} out {i}', dtype, o, r)
            rec['err'] = max(rec['err'], e)
        else:
            rec['sum_err'] = max(rec['sum_err'], _close_sum(
                f'{name} out {i}', dtype, o, r))
    return rec


def _adaln_bwd_timing(rec, call, plain, composite, nb, Lr, Dr, n_rows, es):
    """ms, plain and composite ms, the bound and the rows / sums split of
    one bf16 case."""
    rec['ms'] = time_ms(call)
    rec['plain_ms'] = time_ms(plain)
    rec['composite_ms'] = time_ms(composite)
    rec['composite'] = ('native_layer_norm + dh w (1 + scale) + '
                        'native_layer_norm_backward + column sums'
                        + (' + residual terms' if n_rows == 2 else ''))
    rec['library_ms'] = None
    by = kernel_ms(call)
    rec['split_ms'] = {
        'rows': sum(v for k, v in by.items() if 'rows' in k),
        'sums': sum(v for k, v in by.items() if 'rows' not in k)}
    rec['bound_ms'], rec['bound_by'] = adaln_bwd_bound(nb, Lr, Dr, n_rows, es)
    rec['shape'] = [nb, Lr, Dr]


def adaln_bwd_bound(nb, Lr, Dr, n_rows, es):
    """(ms, 'bytes' or 'operations') of K4 (n_rows 1) or K6 (2): K4 reads
    x, dh and writes dx; K6 reads x', y, dx, dh and writes dy, dskip; both
    read scale (and gate) and w and write the conditioning grads and dw;
    about 15 (K4) and 20 (K6) fp32 operations per element."""
    rows = nb * Lr
    n_stream = 3 if n_rows == 1 else 6
    return bound(
        n_stream * rows * Dr * es + (n_rows + 2) * nb * Dr * es + 8 * Dr,
        (15 if n_rows == 1 else 20) * rows * Dr, PEAK_FP32)


def check_adaln_plan(shapes):
    """`ops.adaln.bwd_plan` (what the wrappers allocate and pass) equals
    the built kernels' `ddg_adaln_bwd_plan` at each (B, L, D), both
    dtypes and both forms."""
    import ctypes
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import adaln
    fn = _build.kernel('adaln', 'ddg_adaln_bwd_plan',
                       (_build.i32,) * 5 + (_build.i32p,))
    keys = ('rows', 'tiles', 'groups', 'warps_per_row', 'vectors_per_lane',
            'teams', 'threads', 'smem', 'workspace')
    n = 0
    for nb, Lr, Dr in shapes:
        for dtype, es in ((0, 4), (1, 2)):
            if Dr // (16 // es) > 1024:
                continue
            for res in (0, 1):
                out = (ctypes.c_int * 9)()
                check(fn(nb, Lr, Dr, dtype, res, out) == 0,
                      f'ddg_adaln_bwd_plan refused {nb} x {Lr} x {Dr}')
                c = dict(zip(keys, out))
                c['workspace'] *= Dr
                py = adaln.bwd_plan(nb, Lr, Dr, es, bool(res))
                check(py == c, f'adaLN backward plan {nb} x {Lr} x {Dr} '
                      f'({es}-byte rows, residual {res}): {py} in ops.adaln,'
                      f' {c} in csrc')
                n += 1
    return n


def check_adaln_bwd(results):
    """K4 and K6 against their plain backwards at the LM1B training
    micro-batch (256 x 128) and text8's (256 x 256), at the classifier-
    guided paths' QM9_ADALN_BWD (timed) and at ADALN_BWD_SHAPES, with the conditioning as strided chunks of one
    (B, 6D) projection; each kernel run twice must give bit-identical
    grads. Timed in bf16 at both training shapes beside the bound, the
    plain version and the composite of library calls, with the split
    between the rows kernel and the sums after it; the launch plan held
    against csrc's."""
    from ddg_tpu_torch.entry import TEXT8_TRAIN_MICRO_BATCH as tb
    from ddg_tpu_torch.entry import TRAIN_MICRO_BATCH as nb
    from ddg_tpu_torch.ops import adaln
    gen = torch.Generator(device=DEV).manual_seed(8)
    shapes = [('lm1b_training', nb, L, D, (torch.float32, torch.bfloat16)),
              ('text8_training', tb, 256, D, (torch.bfloat16,)),
              *QM9_ADALN_BWD, *ADALN_BWD_SHAPES]
    for label, nbr, Lr, Dr, dtypes in shapes:
        for dtype in dtypes:
            es = torch.tensor([], dtype=dtype).element_size()
            ins = _adaln_bwd_inputs(gen, nbr, Lr, Dr, dtype)
            for name, call, plain, composite, n_rows in _adaln_bwd_cases(
                    adaln, *ins):
                ref = plain()
                rec = _adaln_bwd_hold(f'{name} {label}', dtype, call(),
                                      call(), ref, n_rows)
                comp = composite()
                rec['composite_err'] = max(
                    (c.float() - r.float()).abs().max().item()
                    / max(r.float().abs().max().item(), 1e-30)
                    for c, r in zip(comp, ref))
                check(rec['composite_err'] < 0.05,
                      f'{name} {label}: the composite differs from the '
                      f'plain version by {rec["composite_err"]} of its '
                      'largest magnitude')
                if dtype == torch.bfloat16 and (label.endswith('training')
                                                or label in QM9_LABELS):
                    _adaln_bwd_timing(rec, call, plain, composite, nbr, Lr,
                                      Dr, n_rows, es)
                if label == 'lm1b_training':
                    results[name][str(dtype)] = rec
                else:
                    results[name].setdefault(label, {})[str(dtype)] = rec
            del ins
    n = check_adaln_plan([(nb, L, D), (tb, 256, D), (3, 40, 64),
                          (2, 64, 1280)]
                         + [(b, l, d) for _, b, l, d, _ in QM9_ADALN_BWD]
                         + [(b, l, d) for _, b, l, d, _ in ADALN_BWD_SHAPES])
    emit({'phase': 'adaln_bwd_plan_mirror', 'cases': n})


# K7 and K8 off the main shape: (label, B, L, V, mask index, dtype, element
# offset of the logits, of the unconditional logits). An odd V puts the
# rows' starts at every phase of 16 bytes; the offsets move the first
# row's; logits at two phases (the last case) take K8's column-by-column
# path for the unconditional half.
SAMPLE_EDGES = (('v37_mask0', 2, 16, 37, 0, torch.bfloat16, 0, 0),
                ('v37_mid', 2, 16, 37, 18, torch.float32, 3, 3),
                ('v1031_mid', 2, 16, 1031, 515, torch.bfloat16, 5, 5),
                ('v1031_mask0', 2, 16, 1031, 0, torch.float32, 1, 1),
                ('v1031_two_phases', 2, 16, 1031, 1030, torch.bfloat16, 2,
                 7))


def _offset_view(gen, shape, dtype, offset, scale=2.0):
    """A contiguous tensor of `shape` that starts `offset` elements into a
    fresh buffer."""
    n = math.prod(shape)
    return _rand(gen, n + offset, scale=scale, dtype=dtype)[offset:].view(
        shape)


def _absorbing_cases(fs, lc, lu, mask):
    """(name, fp32 z (a function), kernel call, plain call) of K7 and K8;
    each call takes the seed, xt and the move chances, and `gumbel=`."""
    return (('fused_absorbing_sample', lambda: lc.float(),
             lambda seed, xt, mct, mcs, **kw: fs.fused_absorbing_sample(
                 seed, xt, lc, mct, mcs, mask_index=mask, **kw),
             lambda seed, xt, mct, mcs, **kw:
                 fs.fused_absorbing_sample_plain(
                     seed, xt, lc, mct, mcs, mask_index=mask, **kw)),
            ('fused_absorbing_cfg_sample', lambda: fs.cfg_mix(lc, lu, GAMMA),
             lambda seed, xt, mct, mcs, **kw: fs.fused_absorbing_cfg_sample(
                 seed, xt, lc, lu, GAMMA, mct, mcs, mask_index=mask, **kw),
             lambda seed, xt, mct, mcs, **kw:
                 fs.fused_absorbing_cfg_sample_plain(
                     seed, xt, lc, lu, GAMMA, mct, mcs, mask_index=mask,
                     **kw)))


def _sample_edge(fs, gen, label, Bt, Lt, Vt, mask, dtype, off_c, off_u):
    """K7 and K8 at one SAMPLE_EDGES case: tokens against the plain version
    under an external Gumbel; with the in-kernel noise against the plain
    version fed the same draws (`_philox_gumbel`), near-ties within MARGIN;
    a rerun bit-identical."""
    lc = _offset_view(gen, (Bt, Lt, Vt), dtype, off_c)
    lu = _offset_view(gen, (Bt, Lt, Vt), dtype, off_u)
    x0 = torch.randint(0, Vt, (Bt, Lt), generator=gen, device=DEV,
                       dtype=torch.int32)
    x0 = torch.where(x0 == mask, (x0 + 1) % Vt, x0)
    xt = torch.where(torch.rand((Bt, Lt), generator=gen, device=DEV) < 0.7,
                     torch.full_like(x0, mask), x0)
    mct = 0.4 + 0.5 * torch.rand((Bt,), generator=gen, device=DEV)
    mcs = 0.6 * mct
    g = -torch.log(-torch.log(torch.rand((Bt, Lt, Vt), generator=gen,
                                         device=DEV).clamp_min(1e-20)))
    b, l, v = torch.meshgrid(*(torch.arange(n, device=DEV)
                               for n in (Bt, Lt, Vt)), indexing='ij')
    g_philox = _philox_gumbel(99, b, l, v)
    seed = torch.tensor([99], dtype=torch.int32, device=DEV)
    recs = {}
    for name, zf, call, plain in _absorbing_cases(fs, lc, lu, mask):
        tag = f'{name} {label} {dtype}'
        z = zf()
        out = call(7, xt, mct, mcs, gumbel=g)
        ref = plain(7, xt, mct, mcs, gumbel=g)
        scores = fs.perturbed_scores(7, z, mct, mcs, mask_index=mask,
                                     gumbel=g)
        n_cmp = _token_check(tag, out, ref, scores, xt, Vt, mask)
        got = call(seed, xt, mct, mcs)
        check(torch.equal(got, call(seed, xt, mct, mcs)),
              f'{tag}: a rerun differs')
        want = plain(seed, xt, mct, mcs, gumbel=g_philox)
        n_tie = _rng_gap_check(f'{tag} in-kernel noise', got, want, z, xt,
                               mct, mcs, 99, mask)
        recs[name] = {'shape': [Bt, Lt, Vt], 'mask_index': mask,
                      'dtype': str(dtype), 'offsets': [off_c, off_u],
                      'compared_tokens': n_cmp, 'rng_near_ties': n_tie}
    return recs


def _check_gumbel_probe():
    """The sampling kernels' Gumbel noise (`ddg_absorbing_gumbel`: the
    polynomial inner log, the SFU's outer one) against -log(-log(u)) in
    float64 of the same fp32 u, over every 61st 24-bit uniform and the
    lowest and highest 2^16: within 2e-6 (one fp32 ulp at |g| = 16 plus
    the SFU's error). Returns the largest error."""
    from ddg_tpu_torch.ops import _build
    fn = _build.kernel('absorbing_sample', 'ddg_absorbing_gumbel',
                       (_build.ptr, _build.ptr, _build.i32, _build.ptr))
    top = torch.cat([torch.arange(0, 1 << 24, 61),
                     torch.arange(0, 1 << 16),
                     torch.arange((1 << 24) - (1 << 16), 1 << 24)]).to(DEV)
    words = (top << 8) | 0x5A
    bits = torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)
    g = torch.empty(bits.shape, dtype=torch.float32, device=DEV)
    _build.check(fn(bits.data_ptr(), g.data_ptr(), bits.numel(),
                    _build.stream(g)), 'ddg_absorbing_gumbel')
    u = top.float() * (1.0 / 16777216.0) + 1e-10
    ref = -torch.log(-torch.log(u.double()))
    err = (g.double() - ref).abs().max().item()
    check(err <= 2e-6, f'the sampling kernels\' Gumbel noise is {err} off '
                       '-log(-log(u))')
    return err


# The work a logit that any exact absorbing step with in-kernel noise must
# do, besides moving its bytes: on the SFU one exp2 for the LSE; on the
# CUDA cores the Philox words (Philox4x32-10 gives four: 10 rounds of two
# 32 x 32 -> 64-bit products and two three-input xors, the key schedule
# the same for every call, so 10 instructions a logit), the compare of the
# word's top 24 bits that decides whether the noise can win, and the LSE's
# max, exp argument and add. The noise's int-to-float and two logs are
# needed only where it can win (about 7% of the logits at the main shape),
# so they are not counted: the bound is a lower one. Forming the fp32
# logit adds its own slots (`extra`: a bf16 conversion, the CFG mix, a
# bias add).
NOISE_ISSUE_PER_LOGIT = 10 + 1 + 3


def _noise_kinds(n_logits, extra):
    """(operations, peak) kinds of `n_logits` logits' per-logit work
    (NOISE_ISSUE_PER_LOGIT + `extra` issue slots, one SFU result), and the
    issue term's ms."""
    issue = (NOISE_ISSUE_PER_LOGIT + extra) * n_logits
    return ([(n_logits, PEAK_SFU), (issue, PEAK_ISSUE)],
            issue / PEAK_ISSUE * 1e3)


def _absorbing_bound(n_logits, es, n_streams):
    """K7 (one stream of logits) or K8 (two, mixed): bytes (each masked row
    of the logits once, xt and the output) and `_noise_kinds` (a bf16
    logit's conversion to fp32, and for K8 the mix's two products and add),
    through bound_mixed; returns (ms, by, issue ms)."""
    nbytes = n_streams * n_logits * es + 2 * B * L * 4 + 2 * B * 4 + 4
    extra = n_streams * (es == 2) + 3 * (n_streams == 2)
    kinds, issue_ms = _noise_kinds(n_logits, extra)
    return (*bound_mixed(nbytes, kinds), issue_ms)


def check_sampling(results):
    """K7 and K8 against their plain versions on the card: at the main shape
    (fp32 and bf16) under an external Gumbel, and at SAMPLE_EDGES (also the
    in-kernel noise against the plain version fed the same draws); the
    Gumbel noise against float64; ties to the lowest index; TV of the
    in-kernel noise. Timed in bf16 with every token masked (the first step)
    and with half of them (the run's average under the log-linear
    schedule), noise from the in-kernel generator."""
    from ddg_tpu_torch.ops import fused_sampling as fs
    gen = torch.Generator(device=DEV).manual_seed(6)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        (lc, lu), xt, mct, mcs = _sample_inputs(gen, dtype, 2)
        g = -torch.log(-torch.log(
            torch.rand((B, L, V), generator=gen, device=DEV)
            .clamp_min(1e-20)))
        recs = {}
        for name, zf, call, plain in _absorbing_cases(fs, lc, lu, MASK):
            z = zf()
            out = call(7, xt, mct, mcs, gumbel=g)
            ref = plain(7, xt, mct, mcs, gumbel=g)
            scores = fs.perturbed_scores(7, z, mct, mcs, mask_index=MASK,
                                         gumbel=g)
            recs[name] = {'err': 0, 'compared_tokens': _token_check(
                name, out, ref, scores, xt)}
            del scores, z
        del g
        if dtype == torch.bfloat16:
            # Every token masked, as in the first step, and half of them.
            xm = torch.full((B, L), MASK, dtype=torch.int32, device=DEV)
            x0 = torch.randint(0, V - 1, (B, L), generator=gen, device=DEV,
                               dtype=torch.int32)
            xh = torch.where(torch.rand((B, L), generator=gen, device=DEV)
                             < 0.5, torch.full_like(x0, MASK), x0)
            frac = (xh == MASK).float().mean().item()
            seed = torch.tensor([11], dtype=torch.int32, device=DEV)
            for (name, _, call, plain), streams in zip(
                    _absorbing_cases(fs, lc, lu, MASK), (1, 2)):
                rec = recs[name]
                first = call(seed, xm, mct, mcs)
                check(torch.equal(first, call(seed, xm, mct, mcs)),
                      f'{name}: a rerun differs')
                rec['bit_identical_rerun'] = True
                rec['ms'] = time_ms(lambda: call(seed, xm, mct, mcs))
                rec['ms_half_masked'] = time_ms(
                    lambda: call(seed, xh, mct, mcs))
                rec['half_masked_share'] = frac
                rec['plain_ms'] = time_ms(
                    lambda: plain(seed, xm, mct, mcs), reps=10)
                rec['bound_ms'], rec['bound_by'], rec['bound_issue_ms'] = (
                    _absorbing_bound(B * L * V, es, streams))
                rec['bound_ms_half_masked'] = _absorbing_bound(
                    frac * B * L * V, es, streams)[0]
        for name, rec in recs.items():
            results[name][str(dtype)] = rec
    for case in SAMPLE_EDGES:
        for name, rec in _sample_edge(fs, gen, *case).items():
            results[name].setdefault('edges', {})[case[0]] = rec
    results['fused_absorbing_sample']['gumbel_max_abs_err'] = (
        _check_gumbel_probe())
    _check_philox_mirror(fs)
    _tie_check(fs)
    return _tv_check(fs)


# ---------------------------------------------------------------------------
# K11 and K12: the head-fused absorbing step
# ---------------------------------------------------------------------------

PEAK_INT8_TENSOR = 1979e12       # dense int8 tensor-core OP/s
TILE_V = 2048                    # the JAX kernel's vocab tile: Vp = 30720


def _philox_gumbel(seed, b, l, v):
    """K7's in-kernel Gumbel draws at the given (b, l, v) int64 tensors
    (any shape), rebuilt in PyTorch: Philox4x32-10 keyed on (seed, 0),
    counter (v / 4, l, b, 0), word v % 4, g = -log(-log(top24 / 2^24 +
    1e-10)). Used where two samplers disagree, to read the gap of the
    perturbed scores there."""
    c = _philox4x32_10([v >> 2, l, b, torch.zeros_like(v)], int(seed), 0)
    word = torch.stack(c, -1).gather(-1, (v & 3)[..., None])[..., 0]
    u = (word >> 8).float() * (1.0 / 16777216.0) + 1e-10
    return -torch.log(-torch.log(u))


def _philox4x32_10(c, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit words (counter c, a
    list of four; key k0, k1), as `csrc/common.cuh` runs it."""
    M32 = 0xFFFFFFFF

    def mulhilo(a, m):
        ah, al, mh, ml = a >> 16, a & 0xFFFF, m >> 16, m & 0xFFFF
        mid = ah * ml + al * mh
        lo = al * ml + ((mid & 0xFFFF) << 16)
        return (ah * mh + (mid >> 16) + (lo >> 32)) & M32, lo & M32

    k0, k1 = k0 & M32, k1 & M32
    for _ in range(10):
        hi0, lo0 = mulhilo(c[0], 0xD2511F53)
        hi1, lo1 = mulhilo(c[2], 0xCD9E8D57)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c


def _check_philox_mirror(fs):
    """`_philox_gumbel` against K7's own draws: with zero logits K7 picks
    the argmax of the Gumbel noise over the non-mask channels."""
    Bt, Lt, Vt = 2, 8, 64
    xt = torch.full((Bt, Lt), Vt - 1, dtype=torch.int32, device=DEV)
    mct = torch.full((Bt,), 0.9, device=DEV)
    mcs = torch.full((Bt,), 1e-30, device=DEV)
    out = fs.fused_absorbing_sample(
        777, xt, torch.zeros((Bt, Lt, Vt), device=DEV), mct, mcs,
        mask_index=Vt - 1)
    b, l, v = torch.meshgrid(*(torch.arange(n, device=DEV)
                               for n in (Bt, Lt, Vt)), indexing='ij')
    g = _philox_gumbel(777, b, l, v)
    g[..., Vt - 1] = -math.inf
    check(torch.equal(out.long(), g.argmax(-1)),
          'the PyTorch mirror of the kernels\' Philox draws disagrees with '
          'K7')


def _rng_gap_check(name, got, ref, z, xt, mct, mcs, seed, mask=None):
    """Tokens of two samplers with the same in-kernel noise (`got`, `ref`)
    are equal wherever the top-two perturbed scores of the fp32 logits z
    differ by more than MARGIN: at every masked token where they differ,
    the two tokens' scores (K7's, with the Philox noise rebuilt) must lie
    within MARGIN. Returns the number of such near-ties. `mask`: the mask
    index (default MASK)."""
    mask = MASK if mask is None else mask
    masked = xt == mask
    check(torch.equal(got[~masked], xt[~masked]),
          f'{name}: decoded tokens not copied over')
    diff = (got != ref) & masked
    n = int(diff.sum().item())
    if n == 0:
        return 0
    check(n <= max(4, masked.sum().item() // 1000),
          f'{name}: {n} tokens differ from the composite')
    bi, li = diff.nonzero(as_tuple=True)
    V = z.shape[-1]
    zm = z[bi, li].double()
    zm[:, mask] = -math.inf
    lse = torch.logsumexp(zm, -1)
    log_move = torch.log((mct - mcs)[bi].double())
    log_stay = torch.log(mcs[bi].double())
    gaps = []
    for v in (got[bi, li].long(), ref[bi, li].long()):
        g = _philox_gumbel(seed, bi, li, v).double()
        zv = zm.gather(-1, v[:, None])[:, 0]
        gaps.append(torch.where(v == mask, log_stay, zv - lse + log_move)
                    + g)
    worst = (gaps[0] - gaps[1]).abs().max().item()
    check(worst <= MARGIN, f'{name}: tokens differ from the composite '
                           f'where the scores differ by {worst}')
    return n


def _head_inputs(gen, Bt, Lt, Vt, mask, tile_v, dtype, Dm=D):
    """Features (Bt, Lt, Dm), the head prepared for K11 (dtype) or K12
    (int8), xt with 70% masked, move chances and JAX-layout Gumbel."""
    from ddg_tpu_torch.ops import fused_sampling as fs
    feats = _rand(gen, Bt, Lt, Dm)
    weight = _rand(gen, Vt, Dm, scale=0.05)
    bias = _rand(gen, Vt, scale=0.5)
    if dtype == torch.int8:
        head = fs.quantize_head_weights(weight, bias, tile_v=tile_v)
        fin = fs.quantize_head_inputs(feats)
    else:
        head = fs.pad_head_weights(weight.to(dtype), bias, tile_v=tile_v)
        fin = (feats.to(dtype),)
    x0 = torch.randint(0, Vt, (Bt, Lt), generator=gen, device=DEV,
                       dtype=torch.int32)
    x0 = torch.where(x0 == mask, (x0 + 1) % Vt, x0)
    xt = torch.where(torch.rand((Bt, Lt), generator=gen, device=DEV) < 0.7,
                     torch.full_like(x0, mask), x0)
    mct = 0.4 + 0.5 * torch.rand((Bt,), generator=gen, device=DEV)
    mcs = 0.6 * mct
    Vp = head[0].shape[0]
    g = -torch.log(-torch.log(torch.rand((Bt, Vp, Lt), generator=gen,
                                         device=DEV).clamp_min(1e-20)))
    return fin, head, xt, mct, mcs, g


def check_head_sample(results):
    """K11 (bf16 and fp32) and K12 against their plain versions on the card,
    at the main path's 24 x 128 x 768 x V=30523 (Vp 30720) and at a ragged
    case (V=1000 off the 256-row tile with the mask in a non-final tile,
    L=32, a partial token tile): tokens equal under an external Gumbel
    wherever the top-two gap exceeds MARGIN; the logits the kernel forms
    (a probe buffer) equal to the plain version's, K12's bit for bit; with
    the in-kernel noise, equal to the composite that K11/K12 replace (fp32
    logits by a PyTorch product, then K7 with the same seed) under the same
    gap rule; reruns identical. The bf16 head runs the wgmma kernel
    (`head_plan`'s path 1) at the main shape, at the first ragged case
    (Vp 1024), at 3 x 40 and 2 x 32 tokens over V = 3000 (Vp 4096: a
    partial token tile, the mask in the first of four splits, or in the
    last; one token tile) and at 2 x 40 tokens over V = 2900 (Vp 2944: a
    last split of 7 chunks, the mask in it), and the first kernel, in the
    same 1024-row splits, at D = 1536 and 2688; the int8 head runs its
    wgmma kernel (3840-row splits) up to D = 1536 and the first kernel at
    D = 2688; fp32 the first kernel throughout. The plan's mirror
    (`ddg_head_plan` against `head_plan`) and
    the wgmma kernel's in-kernel noise against the exact posterior at
    V = 16 (TV under twice the binomial floor, `_head_tv_check`). Timed at
    the main shape, every token masked, in-kernel noise, beside the plain
    version and the composite the port's unfused path runs (the head
    product, then K7)."""
    global MASK
    from ddg_tpu_torch.ops import fused_sampling as fs
    from ddg_tpu_torch.ops import quant
    _check_philox_mirror(fs)
    _check_head_plan(fs)
    gen = torch.Generator(device=DEV).manual_seed(12)
    cases = (('main_path', B, L, V, V - 1, TILE_V, D),
             ('ragged', 3, 32, 1000, 300, 256, D),
             ('ragged_split', 3, 40, 3000, 300, TILE_V, D),
             ('one_tile', 2, 32, 3000, 2999, TILE_V, D),
             ('partial_split', 2, 40, 2900, 2800, 128, D),
             ('wide_d', 2, 32, 3000, 1500, TILE_V, 1536),
             ('wider_d', 2, 32, 3000, 1500, TILE_V, 2688))
    saved_mask = MASK
    try:
        for dtype in (torch.bfloat16, torch.float32, torch.int8):
            int8 = dtype == torch.int8
            name = ('fused_absorbing_head_sample_int8' if int8
                    else 'fused_absorbing_head_sample')
            kern = getattr(fs, name)
            plain = getattr(fs, name + '_plain')
            for label, Bt, Lt, Vt, mask, tile_v, Dm in cases:
                MASK = mask
                fin, head, xt, mct, mcs, g = _head_inputs(
                    gen, Bt, Lt, Vt, mask, tile_v, dtype, Dm)
                kw = dict(vocab_size=Vt, mask_index=mask, tile_v=tile_v)
                z = (fs.head_logits_int8(*fin, *head) if int8
                     else fs.head_logits(*fin, *head))
                # External Gumbel against the plain version.
                out = kern(7, xt, *fin, *head, mct, mcs, gumbel_t=g, **kw)
                ref = plain(7, xt, *fin, *head, mct, mcs, gumbel_t=g, **kw)
                scores = fs.perturbed_scores(
                    7, z[..., :Vt], mct, mcs, mask_index=mask,
                    gumbel=g.transpose(1, 2)[..., :Vt])
                n_cmp = _token_check(f'{name} {dtype} {label}', out, ref,
                                     scores, xt, Vt)
                del scores
                # The logits the kernel formed.
                probe = torch.empty((Bt, Lt, head[0].shape[0]),
                                    device=DEV)
                args = ((fin[0], head[0], head[2], fin[1], head[1]) if int8
                        else (fin[0], head[0], head[1], None, None))
                fs._launch_head(kern, 7, xt, *args, mct, mcs, Vt, mask,
                                tile_v, None, logits_out=probe)
                if int8:
                    check(torch.equal(probe, z),
                          f'{name} {label}: the kernel\'s logits are not '
                          'bit-equal to int8_dense\'s')
                    err = 0.0
                else:
                    err = (probe - z).abs().max().item()
                    tol = FP32_TOL * max(1.0, z.abs().max().item())
                    check(err <= tol, f'{name} {dtype} {label}: logits '
                                      f'differ by {err} > {tol}')
                # In-kernel noise against the composite, and a rerun.
                seed = torch.tensor([4321], dtype=torch.int32, device=DEV)
                got = kern(seed, xt, *fin, *head, mct, mcs, **kw)
                check(torch.equal(got, kern(seed, xt, *fin, *head, mct,
                                            mcs, **kw)),
                      f'{name} {dtype} {label}: a rerun differs')
                comp = fs.fused_absorbing_sample(
                    seed, xt, z[..., :Vt].contiguous(), mct, mcs,
                    mask_index=mask)
                n_tie = _rng_gap_check(f'{name} {dtype} {label} vs K7',
                                       got, comp, z[..., :Vt], xt, mct,
                                       mcs, 4321)
                rec = {'err': err, 'compared_tokens': n_cmp,
                       'rng_near_ties_vs_k7': n_tie,
                       'bit_identical_rerun': True,
                       'shape': [Bt, Lt, Dm, Vt], 'mask_index': mask,
                       'tile_v': tile_v}
                if int8:
                    rec['logits_bit_equal_int8_dense'] = True
                plan = fs.head_plan(Bt * Lt, Dm, head[0].shape[0], dtype)
                rec['path'], rec['splits'] = plan['path'], plan['splits']
                if label == 'main_path':
                    rec.update(_time_head(fs, quant, kern, plain, fin,
                                          head, mct, mcs, kw, dtype))
                    if dtype == torch.bfloat16:
                        rec['tv'] = _head_tv_check(fs)
                    results[name][str(dtype)] = rec
                else:
                    results[name].setdefault(label, {})[str(dtype)] = rec
                del fin, head, g, z, probe
    finally:
        MASK = saved_mask


def _check_head_plan(fs):
    """The wrapper's `head_plan` equals the built kernel's
    (`ddg_head_plan`) at the LM1B slice and at shapes around the limits
    of each field; a bf16 head's splits are 1024 vocab rows on either
    path; the main path's bf16 head takes the wgmma kernel."""
    import ctypes
    from ddg_tpu_torch.ops import _build
    fn = _build.kernel('head_sample', 'ddg_head_plan',
                       (_build.i32,) * 4 + (_build.i32p,), None)
    for T, Dm, Vp in ((B * L, D, 30720), (64, D, 2048), (96, 1280, 4096),
                      (7, 1600, 4096), (B * L, D, 30720 + 128),
                      (4096 * 8, 1024, 1024), (80, D, 2944),
                      (64, 1536, 3072 + 896), (64, 896, 2048),
                      (200, 1024, 2048), (64, 784, 2048)):
        for dtype, mode in ((torch.bfloat16, 1), (torch.float32, 0),
                            (torch.int8, 2)):
            out = (ctypes.c_int * 7)()
            fn(T, Dm, Vp, mode, out)
            want = fs.head_plan(T, Dm, Vp, dtype)
            check(list(out) == list(want.values()),
                  f'head_plan({T}, {Dm}, {Vp}, {dtype}): the kernel\'s '
                  f'{list(out)} != the wrapper\'s {list(want.values())}')
            if dtype == torch.bfloat16:
                check(want['splits'] == -(-Vp // 1024),
                      f'head_plan({T}, {Dm}, {Vp}): bf16 splits '
                      f'{want["splits"]} are not 1024 rows')
    check(fs.head_plan(B * L, D, 30720, torch.bfloat16)['path'] == 1,
          'the LM1B slice\'s bf16 head does not take the wgmma kernel')
    check(fs.head_plan(B * L, D, 30720, torch.int8)['path'] == 1,
          'the LM1B slice\'s int8 head does not take the int8 wgmma kernel')


def _head_tv_check(fs):
    """The bf16 head's in-kernel noise (the wgmma kernel) against the exact
    posterior at V = 16 (Vp 2048): every token the same features, so one
    row of logits; the histogram of 64 x 1024 draws within twice the
    binomial floor of it in TV (as `_tv_check` for K7)."""
    gen = torch.Generator(device=DEV).manual_seed(6)
    Bt, Lt, Vt = 64, 1024, 16
    n = Bt * Lt
    feats = _rand(gen, D, dtype=torch.bfloat16).expand(Bt, Lt, D).contiguous()
    head = fs.pad_head_weights(_rand(gen, Vt, D, scale=0.05).to(
        torch.bfloat16), _rand(gen, Vt, scale=0.5), tile_v=TILE_V)
    check(fs.head_plan(n, D, head[0].shape[0], torch.bfloat16)['path'] == 1,
          'the TV check does not run the wgmma kernel')
    xt = torch.full((Bt, Lt), Vt - 1, dtype=torch.int32, device=DEV)
    mct = torch.full((Bt,), 0.8, device=DEV)
    mcs = torch.full((Bt,), 0.3, device=DEV)
    out = fs.fused_absorbing_head_sample(
        2468, xt, feats, *head, mct, mcs, vocab_size=Vt, mask_index=Vt - 1,
        tile_v=TILE_V)
    z = fs.head_logits(feats[:1, :1], *head)[0, 0, :Vt].clone()
    z[Vt - 1] = -1e30
    p = torch.softmax(z, -1) * (0.8 - 0.3)
    p[Vt - 1] = 0.3
    q = (p / p.sum()).double()
    hist = torch.bincount(out.flatten().long(), minlength=Vt).double() / n
    tv = 0.5 * (hist - q).abs().sum().item()
    floor = 0.5 * torch.sqrt(2 * q * (1 - q) / (math.pi * n)).sum().item()
    check(tv < 2 * floor, f'fused_absorbing_head_sample bf16 internal RNG: '
                          f'TV {tv} >= 2 x floor {floor}')
    return {'tv': tv, 'floor': floor, 'draws': n}


def _time_head(fs, quant, kern, plain, fin, head, mct, mcs, kw, dtype):
    """CUDA-event medians at the main shape, every token masked, in-kernel
    noise: the kernel, its plain version, and the composite of the port's
    unfused path (the head product in the head's dtype, then K7)."""
    xm = torch.full((B, L), MASK, dtype=torch.int32, device=DEV)
    seed = torch.tensor([11], dtype=torch.int32, device=DEV)
    Vt = kw['vocab_size']
    rec = {'ms': time_ms(lambda: kern(seed, xm, *fin, *head, mct, mcs,
                                      **kw)),
           'plain_ms': time_ms(lambda: plain(seed, xm, *fin, *head, mct,
                                             mcs, **kw), reps=5)}
    if dtype == torch.int8:
        w_q, w_scale, bias_col = head

        def composite():
            acc = quant.int8_matmul(fin[0].reshape(B * L, D), w_q)[:, :Vt]
            z = quant.rescale(acc.reshape(B, L, Vt), fin[1],
                              w_scale[:Vt, 0], bias_col[:Vt, 0],
                              torch.bfloat16)
            return fs.fused_absorbing_sample(seed, xm, z, mct, mcs,
                                             mask_index=MASK)
        what = ('quant.int8_matmul (torch._int_mm) + the rescale to bf16 '
                'logits + K7')
    else:
        w, bias = head[0][:Vt], head[1][:Vt, 0].to(dtype)

        def composite():
            z = torch.nn.functional.linear(fin[0], w, bias)
            return fs.fused_absorbing_sample(seed, xm, z, mct, mcs,
                                             mask_index=MASK)
        what = f'F.linear ({dtype} logits) + K7'
    rec['composite_ms'] = time_ms(composite)
    rec['composite'] = what
    es = {torch.bfloat16: 2, torch.float32: 4, torch.int8: 1}[dtype]
    peak = {torch.bfloat16: PEAK_BF16_TENSOR, torch.float32: PEAK_FP32,
            torch.int8: PEAK_INT8_TENSOR}[dtype]
    T = B * L
    # W, the features, the bias (and scales), xt and the output once; the
    # product's 2 T D V operations; the sampling's work a logit
    # (`_noise_kinds`, with the bias add). The tensor cores' products run
    # beside the CUDA cores' and the SFU's work (wgmma asynchronously, a
    # warpgroup issuing one instruction a 64 x 128 x 16 product), so each
    # is a kind of its own, maxed with the others.
    nbytes = (Vt * D + T * D) * es + Vt * 4 + 2 * T * 4 + B * 8
    if dtype == torch.int8:
        nbytes += Vt * 4 + T * 4
    kinds, rec['bound_issue_ms'] = _noise_kinds(T * Vt, 1)
    kinds.append((2 * T * D * Vt, peak))
    rec['bound_ms'], rec['bound_by'] = bound_mixed(nbytes, kinds)
    rec['library_ms'] = None
    return rec


# The UNet path's shapes: CIFAR10 32 x 32 x 3 as 3072 tokens over V=256,
# B=32 images, 2B=64 under D-CFG.
UB, UL, UV = 32, 3072, 256
# SFU results (exp2, log2, rcp) per second: 16 a clock per SM (the CUDA
# programming guide's throughput table for compute capability 9.0) x 132
# SMs x 1.98 GHz (H100 SXM boost clock).
PEAK_SFU = 16 * 132 * 1.98e9
# fp32 or int32 instructions a second on the CUDA cores: 128 lanes a clock
# per SM x 132 SMs x 1.98 GHz (the 67 TFLOP/s fp32 rate counts an FMA as 2).
PEAK_ISSUE = 128 * 132 * 1.98e9


def _uniform_inputs(gen, dtype, V, n_logits=2, Bu=UB, Lu=UL):
    """Logits as the two halves of one [cond; uncond] tensor, as the main
    path slices them; alpha(s) > alpha(t)."""
    both = _rand(gen, n_logits * Bu, Lu, V, scale=2.0, dtype=dtype)
    logits = [both[i * Bu:(i + 1) * Bu] for i in range(n_logits)]
    xt = torch.randint(0, V, (Bu, Lu), generator=gen, device=DEV,
                       dtype=torch.int32)
    a_t = 0.05 + 0.8 * torch.rand((Bu,), generator=gen, device=DEV)
    a_s = a_t + (1 - a_t) * torch.rand((Bu,), generator=gen, device=DEV)
    return logits, xt, a_t, a_s


def _uniform_token_check(name, out, ref, scores, vocab):
    """Identical tokens where the top-two perturbed scores differ by more
    than MARGIN; every token inside the vocabulary. Returns the tokens
    that differ there and the tokens compared."""
    top2 = scores.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > MARGIN
    bad = int(((out != ref) & decided).sum().item())
    check(bad == 0, f'{name}: {bad} tokens differ where the margin > '
                    f'{MARGIN}')
    check(bool(((out >= 0) & (out < vocab)).all()),
          f'{name}: token outside the vocabulary')
    return bad, int(decided.sum().item())


def _uniform_cases(fs, seed, xt, lc, lu, a_t, a_s, vocab, g):
    """(name, kernel call, plain call, scores) of K9 and K10."""
    kw = dict(vocab_size=vocab, gumbel=g)
    return (
        ('fused_uniform_sample',
         lambda: fs.fused_uniform_sample(seed, xt, lc, a_t, a_s, **kw),
         lambda: fs.fused_uniform_sample_plain(seed, xt, lc, a_t, a_s, **kw),
         lambda: fs.uniform_perturbed_scores(
             seed, fs.uniform_log_num(lc, xt, a_t, a_s, vocab_size=vocab),
             **kw)),
        ('fused_uniform_cfg_sample',
         lambda: fs.fused_uniform_cfg_sample(seed, xt, lc, lu, GAMMA, a_t,
                                             a_s, **kw),
         lambda: fs.fused_uniform_cfg_sample_plain(seed, xt, lc, lu, GAMMA,
                                                   a_t, a_s, **kw),
         lambda: fs.uniform_perturbed_scores(
             seed, fs.uniform_cfg_log_num(lc, lu, GAMMA, xt, a_t, a_s,
                                          vocab_size=vocab), **kw)))


def _uniform_tv_check(fs, Vt=20, vocab=16):
    """Internal-RNG draws of K9/K10 against their exact distribution at a
    small V (by default with columns past the vocabulary): TV below twice
    the binomial floor."""
    gen = torch.Generator(device=DEV).manual_seed(12)
    Bt, Lt = 64, 1024
    n = Bt * Lt
    row_c = torch.randn((Vt,), generator=gen, device=DEV)
    row_u = torch.randn((Vt,), generator=gen, device=DEV)
    lc = row_c.expand(Bt, Lt, Vt).contiguous()
    lu = row_u.expand(Bt, Lt, Vt).contiguous()
    xt = torch.full((Bt, Lt), 3, dtype=torch.int32, device=DEV)
    a_t = torch.full((Bt,), 0.3, device=DEV)
    a_s = torch.full((Bt,), 0.6, device=DEV)
    out = {}
    for name, call, log_q in (
            ('fused_uniform_sample',
             lambda: fs.fused_uniform_sample(1234, xt, lc, a_t, a_s,
                                             vocab_size=vocab),
             fs.uniform_log_num(lc[:1, :1], xt[:1, :1], a_t[:1], a_s[:1],
                                vocab_size=vocab)),
            ('fused_uniform_cfg_sample',
             lambda: fs.fused_uniform_cfg_sample(
                 4321, xt, lc, lu, GAMMA, a_t, a_s, vocab_size=vocab),
             fs.uniform_cfg_log_num(lc[:1, :1], lu[:1, :1], GAMMA, xt[:1, :1],
                                    a_t[:1], a_s[:1], vocab_size=vocab))):
        q = torch.softmax(log_q.flatten().double(), -1)
        hist = torch.bincount(call().flatten().long(),
                              minlength=Vt).double() / n
        tv = 0.5 * (hist - q).abs().sum().item()
        floor = 0.5 * torch.sqrt(2 * q * (1 - q) / (math.pi * n)).sum().item()
        check(tv < 2 * floor, f'{name} internal RNG: TV {tv} >= 2 x floor '
                              f'{floor}')
        out[f'{name} V={Vt}'] = {'tv': tv, 'floor': floor, 'draws': n}
    return out


# K9's and K10's widths (V, vocab_size): a thread a row holding 12, 16 or
# 32 columns (V=12, V=20 / 16, V=40 / 30), a warp a row in one turn (V=250 /
# 243, V=256) or in four (V=1000 / 997).
UNIFORM_WIDTHS = ((12, 12), (20, 16), (40, 30), (250, 243), (256, 256),
                  (1000, 997))

# The work a logit and logits tensor that any exact uniform step must do
# besides moving its bytes: the bf16 conversion, the LSE's max, exp
# argument and add (the exp itself on the SFU), p = e / sum, the
# numerator's products and adds and the log's scale (the log on the SFU);
# then a logit's Philox words (10 slots, as NOISE_ISSUE_PER_LOGIT), the
# compare of its top 24 bits and the score's add and compare (2); with two
# tensors (K10) the CFG mix (2) too. The noise's logs, formed only where
# the draw can win, are not counted.
UNIFORM_ISSUE_PER_TENSOR = 8
UNIFORM_ISSUE_PER_LOGIT = 10 + 1 + 2
UNIFORM_ISSUE_MIX = 2


def _uniform_bound(n_rows, V, es, n_in):
    """K9 (n_in 1) or K10 (n_in 2) at n_rows rows of V columns: bytes (the
    logits, xt in and the tokens out) and, per logit, one exp and one log
    of the numerator for each logits tensor on the SFU and the issue of
    UNIFORM_ISSUE_PER_* (and the mix, UNIFORM_ISSUE_MIX, for K10 alone);
    returns (ms, by, issue ms). The count of the
    first design, which forms every logit's noise (two logs more on the
    SFU), is `_uniform_bound_full_noise`."""
    n = n_rows * V
    nbytes = n_in * n * es + 2 * n_rows * 4
    issue = (UNIFORM_ISSUE_PER_LOGIT + n_in * UNIFORM_ISSUE_PER_TENSOR
             + (UNIFORM_ISSUE_MIX if n_in == 2 else 0)) * n
    ms, by = bound_mixed(nbytes, ((2 * n_in * n, PEAK_SFU),
                                  (issue, PEAK_ISSUE)))
    return ms, by, issue / PEAK_ISSUE * 1e3


def _uniform_bound_full_noise(n_rows, V, es, n_in):
    """The bound as it was counted for the first design, which forms every
    logit's noise: bytes, and 2 n_in + 2 SFU results a logit (the exps and
    logs of each tensor and the noise's two logs)."""
    return bound(n_in * n_rows * V * es + 2 * n_rows * 4 + 8,
                 (2 * n_in + 2) * n_rows * V, PEAK_SFU)


def _check_uniform_plan(fs):
    """The wrapper's `uniform_plan` equals the built kernel's
    (`ddg_uniform_plan`) around each limit; one plan serves one logits
    tensor (K9) and two (K10). Species10's V=12 takes a thread a row and
    the UNet's V=256 a warp a row with 16-byte loads."""
    import ctypes
    from ddg_tpu_torch.ops import _build
    fn = _build.kernel('uniform_sample', 'ddg_uniform_plan',
                       (_build.i32,) * 2 + (_build.i32p,), None)
    for V, vocab in ((1, 1), (12, 12), (13, 13), (16, 16), (20, 16),
                     (17, 17), (32, 32), (40, 33), (256, 256), (250, 243),
                     (264, 257), (30522, 30522)):
        for aligned in (False, True):
            want = fs.uniform_plan(V, vocab, torch.bfloat16, aligned)
            out = (ctypes.c_int * 4)()
            fn(vocab, want['vec'], out)
            check(list(out) == list(want.values()),
                  f'uniform_plan({V}, {vocab}, aligned={aligned}): the '
                  f'kernel\'s {list(out)} != the wrapper\'s '
                  f'{list(want.values())}')
    check(fs.uniform_plan(SV, SV, torch.bfloat16, True)['kernel'] == 1,
          'Species10\'s step does not take a thread a row')
    check(fs.uniform_plan(UV, UV, torch.bfloat16, True) == dict(
        kernel=2, rows=8, cols=8, vec=1),
          'the UNet\'s step does not take a warp a row in one turn')


def _uniform_rng_and_ties(fs):
    """K9 and K10 at UNIFORM_WIDTHS, fp32 and bf16: the in-kernel noise
    against the plain version fed the same Philox draws (`_philox_gumbel`;
    tokens equal wherever the top-two gap of those scores exceeds MARGIN,
    and a rerun bit-identical), and ties: with alpha(s) = 1 the numerator
    of xt's column is that of its probability, so with xt's logit far below
    the others and no noise every other column ties, and the lowest wins.
    Returns {name: {width: compared tokens}}."""
    gen = torch.Generator(device=DEV).manual_seed(19)
    Bt, Lt = 2, 64
    out = {'fused_uniform_sample': {}, 'fused_uniform_cfg_sample': {}}
    for V, vocab in UNIFORM_WIDTHS:
        b, l, v = torch.meshgrid(*(torch.arange(n, device=DEV)
                                   for n in (Bt, Lt, V)), indexing='ij')
        g_philox = _philox_gumbel(99, b, l, v)
        for dtype in (torch.float32, torch.bfloat16):
            (lc, lu), xt, a_t, a_s = _uniform_inputs(gen, dtype, V, Bu=Bt,
                                                     Lu=Lt)
            xt = xt % vocab
            seed = torch.tensor([99], dtype=torch.int32, device=DEV)
            for name, call, plain, scores in _uniform_cases(
                    fs, seed, xt, lc, lu, a_t, a_s, vocab, None):
                got = call()
                check(torch.equal(got, call()),
                      f'{name} V={V}: a rerun differs')
                ref = {c[0]: c for c in _uniform_cases(
                    fs, 0, xt, lc, lu, a_t, a_s, vocab, g_philox)}[name]
                _, n_cmp = _uniform_token_check(
                    f'{name} V={V}/{vocab} {dtype} in-kernel noise', got,
                    ref[2](), ref[3](), vocab)
                out[name][f'{V}/{vocab} {dtype}'] = n_cmp
        for x_col, want in ((0, 1), (vocab // 2, 0)):
            z = torch.zeros((Bt, Lt, V), device=DEV)
            z[..., x_col] = -100.0
            xt = torch.full((Bt, Lt), x_col, dtype=torch.int32, device=DEV)
            ones = torch.ones((Bt,), device=DEV)
            for name, call, _, _ in _uniform_cases(
                    fs, 0, xt, z, z, 0.5 * ones, ones, vocab,
                    torch.zeros_like(z)):
                check(bool((call() == want).all()),
                      f'{name} V={V}: tied columns do not go to the lowest '
                      f'index {want}')
    return out


def check_uniform(results):
    """K9/K10 against their plain versions with the same noise at the main
    path's shape (and at a V that is not a multiple of 8, with columns past
    the vocabulary), timed with the in-kernel generator; K10's plan mirror,
    its in-kernel noise against the plain version fed the same draws and
    its ties at every width of UNIFORM_WIDTHS."""
    from ddg_tpu_torch.ops import fused_sampling as fs
    gen = torch.Generator(device=DEV).manual_seed(10)
    for V, vocab in ((UV, UV), (250, 243)):
        for dtype in (torch.float32, torch.bfloat16):
            (lc, lu), xt, a_t, a_s = _uniform_inputs(gen, dtype, V)
            g = -torch.log(-torch.log(
                torch.rand((UB, UL, V), generator=gen, device=DEV)
                .clamp_min(1e-20)))
            for name, call, plain, scores in _uniform_cases(
                    fs, 7, xt, lc, lu, a_t, a_s, vocab, g):
                bad, n_cmp = _uniform_token_check(
                    f'{name} V={V} {dtype}', call(), plain(), scores(), vocab)
                if V == UV:
                    results[name][str(dtype)] = {'err': bad,
                                                 'compared_tokens': n_cmp}
            del g
            if V != UV or dtype != torch.bfloat16:
                continue
            seed = torch.tensor([11], dtype=torch.int32, device=DEV)
            for name, call, plain, _ in _uniform_cases(
                    fs, seed, xt, lc, lu, a_t, a_s, vocab, None):
                rec = results[name][str(dtype)]
                rec['ms'] = time_ms(call)
                rec['plain_ms'] = time_ms(plain, reps=10)
                _uniform_timing_bounds(rec, name, UB * UL, V)
    _check_uniform_plan(fs)
    for name, widths in _uniform_rng_and_ties(fs).items():
        results[name]['widths'] = widths
    return _uniform_tv_check(fs)


def _uniform_timing_bounds(rec, name, n_rows, V):
    """The bound of a timed bf16 K9 or K10 record (`_uniform_bound`), with
    the first design's count, which forms every logit's noise, beside it."""
    n_in = 2 if 'cfg' in name else 1
    rec['bound_ms'], rec['bound_by'], rec['bound_issue_ms'] = (
        _uniform_bound(n_rows, V, 2, n_in))
    rec['bound_ms_full_noise'] = _uniform_bound_full_noise(n_rows, V, 2,
                                                           n_in)[0]


def _check_gn_plan(gn, HW, C, G):
    """The wrapper's `plan` equals the built kernel's
    (`ddg_group_norm_plan`) with bf16 and with fp32 in, and both hold the
    slab on chip (one launch). Returns the bf16 plan."""
    import ctypes
    from ddg_tpu_torch.ops import _build
    fn = _build.kernel('groupnorm', 'ddg_group_norm_plan',
                       (_build.i32,) * 4 + (_build.i32p,), None)
    for size in (2, 4):
        out = (ctypes.c_int * 4)()
        fn(HW, C, G, size, out)
        want = gn.plan(HW, C, G, size)
        check(tuple(out) == want, f'groupnorm plan({HW}, {C}, {G}, {size}): '
                                  f'the kernel\'s {tuple(out)} != {want}')
        check(want[0] == 1, f'groupnorm plan({HW}, {C}, {G}, {size}) is not '
                            'the slab path')
    return list(gn.plan(HW, C, G, 2))


def check_groupnorm(results, norms):
    """K13 against its plain version at every (HW, C, act) of one UNet
    forward (`norms`: {(H, W, C, act): count}), bf16 in and fp32 out, at
    N=64 (D-CFG) and N=32, and bf16 in and out (the int8 line's
    norm_dtype=bf16) at N=64, one launch a call; the other two dtype pairs
    at one shape. At
    each shape the plan's mirror (`_check_gn_plan`, bf16 and fp32 in) and
    one launch a call (torch.profiler: one `gn_slab_kernel`). `ms_sequence`
    times the 51 calls back to back, as a forward runs them. The times
    are sums over one D-CFG forward's norms (N=64), each shape weighted by
    its count; the library yardstick is F.group_norm without the SiLU, on
    the NCHW view of the same channels-last input (bf16 out)."""
    import torch.nn.functional as F
    from ddg_tpu_torch.ops import groupnorm as gn
    gen = torch.Generator(device=DEV).manual_seed(13)
    rec = {'err': 0.0, 'tol': FP32_TOL, 'ms': 0.0, 'plain_ms': 0.0,
           'library_ms': 0.0, 'shapes': []}
    nbytes = 0
    forward = []
    for (Hh, Ww, C, act), count in sorted(norms.items()):
        G = min(C // 4, 32)
        scale = 1.0 + _rand(gen, C, scale=0.2)
        bias = _rand(gen, C, scale=0.2)
        for N in (2 * UB, UB):
            x = (0.3 + 2.0 * torch.randn((N, Hh, Ww, C), generator=gen,
                                         device=DEV)).to(torch.bfloat16)
            kw = dict(num_groups=G, eps=1e-6, act=act,
                      out_dtype=torch.float32)
            out = gn.fused_group_norm_act(x, scale, bias, **kw)
            ref = gn.fused_group_norm_act_plain(x, scale, bias, **kw)
            err, _ = _close(f'fused_group_norm_act {(N, Hh, Ww, C, act)}',
                            torch.float32, out, ref)
            rec['err'] = max(rec['err'], err)
            if N != 2 * UB:
                continue
            again = gn.fused_group_norm_act(x, scale, bias, **kw)
            check(torch.equal(out, again),
                  f'fused_group_norm_act {(N, Hh, Ww, C)}: a rerun is not '
                  'bit-identical')
            # bf16 out as well: the int8 UNet line (norm_dtype=bf16) runs
            # every one of these shapes at this N with bf16 in and out.
            kw16 = dict(kw, out_dtype=torch.bfloat16)
            _close(f'fused_group_norm_act {(N, Hh, Ww, C, act)} bf16 out',
                   torch.bfloat16,
                   gn.fused_group_norm_act(x, scale, bias, **kw16),
                   gn.fused_group_norm_act_plain(x, scale, bias, **kw16))
            launches16 = kernel_launches(
                lambda: gn.fused_group_norm_act(x, scale, bias, **kw16))
            check(launches16 == {'gn_slab_kernel': 1},
                  f'fused_group_norm_act {(N, Hh, Ww, C)} bf16 out: '
                  f'launched {launches16}, not one slab kernel')
            plan = _check_gn_plan(gn, Hh * Ww, C, G)
            launches = kernel_launches(
                lambda: gn.fused_group_norm_act(x, scale, bias, **kw))
            check(launches == {'gn_slab_kernel': 1},
                  f'fused_group_norm_act {(N, Hh, Ww, C)}: launched '
                  f'{launches}, not one slab kernel')
            ms = time_ms(lambda: gn.fused_group_norm_act(x, scale, bias, **kw))
            plain_ms = time_ms(
                lambda: gn.fused_group_norm_act_plain(x, scale, bias, **kw),
                reps=10)
            xc = x.permute(0, 3, 1, 2)
            sb, bb = scale.to(x.dtype), bias.to(x.dtype)
            lib_ms = time_ms(lambda: F.group_norm(xc, G, sb, bb, 1e-6))
            rec['ms'] += count * ms
            rec['plain_ms'] += count * plain_ms
            rec['library_ms'] += count * lib_ms
            forward.append((count, x, scale, bias, kw))
            nbytes += count * (N * Hh * Ww * C * (2 + 4) + 2 * C * 4)
            rec['shapes'].append({'N': N, 'H': Hh, 'W': Ww, 'C': C,
                                  'act': act, 'count': count, 'ms': ms,
                                  'plain_ms': plain_ms, 'library_ms': lib_ms,
                                  'plan': plan, 'launches': launches})
    # The 51 calls back to back, as a forward runs them (one pair of
    # events around them all, so no event falls between two calls).
    def one_forward():
        for count, xf, sf, bf, kwf in forward:
            for _ in range(count):
                gn.fused_group_norm_act(xf, sf, bf, **kwf)
    rec['ms_sequence'] = time_ms(one_forward, reps=10)
    del forward
    # The other dtypes, at the largest shape: fp32 in with fp32 or bf16
    # out, and bf16 in and out (norm_dtype=bf16).
    x32 = torch.randn((UB, 32, 32, 384), generator=gen, device=DEV)
    scale, bias = 1.0 + _rand(gen, 384, scale=0.2), _rand(gen, 384, scale=0.2)
    for in_dtype, out_dtype in ((torch.float32, torch.float32),
                                (torch.float32, torch.bfloat16),
                                (torch.bfloat16, torch.bfloat16)):
        x = x32.to(in_dtype)
        kw = dict(num_groups=32, act=True, out_dtype=out_dtype)
        _close(f'fused_group_norm_act {in_dtype} in, {out_dtype} out',
               out_dtype, gn.fused_group_norm_act(x, scale, bias, **kw),
               gn.fused_group_norm_act_plain(x, scale, bias, **kw))
        check(kernel_launches(lambda: gn.fused_group_norm_act(
            x, scale, bias, **kw)) == {'gn_slab_kernel': 1},
              f'fused_group_norm_act {in_dtype} in at 32 x 32 x 384: not '
              'one slab kernel')
    rec['launches_per_call'] = 1
    # Read once and write once per norm; about 10 fp32 operations per
    # element (stats, normalize, SiLU), under the fp32 rate.
    n_elem = nbytes / 6
    rec['bound_ms'], rec['bound_by'] = bound(nbytes, 10 * n_elem, PEAK_FP32)
    rec['ms_covers'] = (f'{sum(norms.values())} launches, one D-CFG '
                        f'forward at N={2 * UB}')
    results['fused_group_norm_act'][str(torch.bfloat16)] = rec


# The Species10 DiMamba path's shapes: B=8 sequences of L=32768 (2B=16 rows
# a forward under D-CFG), hidden 256, d_inner 512, d_state 16, dt_rank 16,
# the DNA vocabulary of 12.
SB, SL, SH, SD, SN, SR, SV = 8, 32768, 256, 512, 16, 16, 12


def check_uniform_species(results, tv):
    """K9/K10 at the Species10 shape (B=8 x 32768, V=12: the scalar path,
    12 being no multiple of 8) against their plain versions with the same
    noise, timed with the in-kernel generator; their in-kernel noise at
    V=12 by TV. The records go under 'species10'."""
    from ddg_tpu_torch.ops import fused_sampling as fs
    gen = torch.Generator(device=DEV).manual_seed(15)
    for dtype in (torch.float32, torch.bfloat16):
        (lc, lu), xt, a_t, a_s = _uniform_inputs(gen, dtype, SV, Bu=SB,
                                                 Lu=SL)
        g = -torch.log(-torch.log(
            torch.rand((SB, SL, SV), generator=gen, device=DEV)
            .clamp_min(1e-20)))
        for name, call, plain, scores in _uniform_cases(
                fs, 7, xt, lc, lu, a_t, a_s, SV, g):
            bad, n_cmp = _uniform_token_check(f'{name} V={SV} {dtype}',
                                              call(), plain(), scores(), SV)
            rec = {'err': bad, 'compared_tokens': n_cmp,
                   'shape': [SB, SL, SV]}
            if dtype == torch.bfloat16:
                seed = torch.tensor([11], dtype=torch.int32, device=DEV)
                case = {c[0]: c for c in _uniform_cases(
                    fs, seed, xt, lc, lu, a_t, a_s, SV, None)}[name]
                rec['ms'] = time_ms(case[1])
                rec['plain_ms'] = time_ms(case[2], reps=10)
                _uniform_timing_bounds(rec, name, SB * SL, SV)
                results[name]['species10'] = rec
        del g
    tv.update(_uniform_tv_check(fs, SV, SV))


def _mamba_weights(gen, dtype, H=SH, d=SD, R=SR, N=SN, K=4):
    """One direction's weights as the model hands them over: flax (in, out)
    views of torch-layout matrices in `dtype`, scaled so the outputs are of
    order one; A = -exp(A_log) around the S4D init, dt biases near the
    reference's softplus range."""
    def mat(n_out, n_in):
        return _rand(gen, n_out, n_in, scale=n_in ** -0.5, dtype=dtype).t()
    a_log = torch.log(torch.arange(1, N + 1, device=DEV, dtype=torch.float32))
    return dict(W_in=mat(2 * d, H),
                conv_w=_rand(gen, K, 1, d, scale=0.5, dtype=dtype),
                conv_b=_rand(gen, d, scale=0.1, dtype=dtype),
                W_x=mat(R + 2 * N, d),
                W_dt=_rand(gen, d, R, scale=R ** -0.5).t(),
                b_dt=_rand(gen, d, scale=0.5) - 3.0,
                A=-torch.exp(a_log + _rand(gen, d, N, scale=0.1)),
                D=_rand(gen, d), W_out=mat(H, d))


def _close_states(name, dtype, out, ref):
    """Chunk entry states (fp32 sums over up to L rows): 1e-5 of their
    largest magnitude, 2^-7 of it when the inputs were rounded to bf16
    (one rounding flip of an input moves a state by that much)."""
    rtol = SUM_RTOL if dtype == torch.float32 else 2.0 ** -7
    err = (out - ref).abs().max().item()
    tol = rtol * ref.abs().max().item()
    check(err <= tol, f'{name} h0s {dtype}: max abs err {err} > {tol}')
    return err


def _fwd_pair(rec, name, dtype, got, want, rel=False):
    """(out, h0s) of a kernel against another computation of them: out to
    the usual bars (`_close`, with `rel`), h0s to `_close_states`; the
    errors also raise `rec`'s maxima (and set its 'tol'). Returns {err,
    tol, h0s_err}."""
    err, tol = _close(name, dtype, got[0], want[0], rel)
    h0s_err = _close_states(name, dtype, got[1], want[1])
    rec['tol'] = tol
    rec['err'] = max(rec.get('err', 0.0), err)
    rec['h0s_err'] = max(rec.get('h0s_err', 0.0), h0s_err)
    return {'err': err, 'tol': tol, 'h0s_err': h0s_err}


def _rerun_equal(name, fn, first):
    """A second call of fn returns outputs bit-identical to `first`."""
    again = fn()
    check(all(torch.equal(a, b) for a, b in zip(again, first)),
          f'{name}: reruns differ')


def _batched(args, n):
    """The first n rows of every batched argument (a tensor of 3 or more
    dimensions whose first is the batch's), the rest as they are."""
    Bt = args[0].shape[0]
    return tuple(t[:n] if isinstance(t, torch.Tensor) and t.dim() >= 3
                 and t.shape[0] == Bt else t for t in args)


def _rows_any_batch(name, fn, *args, batches=(1, 4, 8, 16, 32), keep=None):
    """ROADMAP C.8: a row's outputs follow its inputs only. fn on the first
    nb rows of its batched arguments, for each nb in `batches` (the
    arguments hold the largest): the first row of every output (those in
    `keep`, default all) bit-equal at every nb, and the first 4 rows at
    every nb from 4 up (the forward scan runs its three passes at a small
    batch and its walk at one that fills the card). Returns the largest
    difference between the first 4 rows at 4 and at 16 rows (0.0)."""
    outs = {nb: fn(*_batched(args, nb)) for nb in batches}
    keep = range(len(outs[batches[0]])) if keep is None else keep
    diff = 0.0
    for nb, out in outs.items():
        for k in keep:
            for m in (1, 4):
                if m > nb or m not in outs:
                    continue
                a, b = out[k][:m], outs[m][k]
                check(torch.equal(a, b),
                      f'{name}: output {k}, the first {m} rows among {nb} '
                      f'differ from the same rows among {m} by '
                      f'{(a.float() - b.float()).abs().max().item()}')
            if nb == 16 and 4 in outs:
                diff = max(diff, (out[k][:4].float()
                                  - outs[4][k].float()).abs().max().item())
    return diff


def check_mamba(results):
    """K18 (`mamba_inner`) and K14 (`ssm_scan`) against their plain versions
    on the card at the DiMamba's widths, in fp32 and bf16: K18 at B=2,
    L=2048 (16 chunks of 128) with the forward direction's weights and
    with another set on the flipped rows (as the model runs `core_rev`),
    at L=80, chunk 16 (a ragged last row tile of the conv kernel and of
    the products), there also with d_conv 3 (run as 4 taps, the first
    zero), at L=960, chunk 60 (chunk ends inside a batch of 8 rows) and
    at d_state 24, 64 and 192 (groups of 16 states in order, their sums of
    C . h through device memory); K14 on u, z, B, C as views into wider
    projections (as
    the model slices them) at L=2048, at L=2000 (a padded last chunk), at
    chunk 60, at d_state 24, 64 and 192 and with B and C at an odd offset
    and row stride (dt_rank 3). Every case is rerun and must
    give the same bits. Outputs to the usual bars, the chunk entry states
    to `_close_states`; in fp32 K14's y and h0s at L=2048 are also held
    against float64 (`f64_gap`, recorded). Timed in bf16 at the Species10
    shape, 16 x 32768 (256 chunks a row), and held against the plain
    versions there too (`main_path`); the walk's own edge cases run at
    batches that fill the card. ROADMAP C.8: at the main shape in bf16,
    and at L=4096 in fp32, K14's and K18's first rows give the same bits
    alone, among 4 (the three passes) and among 8, 16 and 32 (the walk)
    (`_rows_any_batch`)."""
    from ddg_tpu_torch.ops import mamba as M
    gen = torch.Generator(device=DEV).manual_seed(14)
    for dtype in (torch.float32, torch.bfloat16):
        rec18 = {}
        for Bt, Lm, chunk, rows, N in ((2, 2048, 128, 'fwd', SN),
                                       (2, 2048, 128, 'rev', SN),
                                       (2, 80, 16, 'ragged', SN),
                                       (2, 80, 16, 'taps3', SN),
                                       (2, 960, 60, 'chunk60', SN),
                                       (2, 1024, 128, 'd_state24', 24),
                                       (2, 1024, 128, 'd_state64', 64),
                                       (1, 512, 128, 'd_state192', 192)):
            w = _mamba_weights(gen, dtype, N=N,
                               K=3 if rows == 'taps3' else 4)
            h = _rand(gen, Bt, Lm, SH, dtype=dtype)
            if rows == 'rev':
                h = torch.flip(h, (1,))
            kw = dict(d_state=N, dt_rank=SR, chunk=chunk,
                      compute_dtype=dtype, return_h0s=True)
            name = f'mamba_inner {rows} B={Bt} L={Lm} chunk={chunk}'
            got = M.mamba_inner(h, **w, **kw)
            _fwd_pair(rec18, name, dtype, got,
                      M.mamba_inner_plain(h, **w, **kw), rel=N > SN)
            _rerun_equal(name, lambda: M.mamba_inner(h, **w, **kw), got)
        results['mamba_inner'][str(dtype)] = rec18
        rec14 = {}
        for Bt, Lm, chunk, N, R in ((2, 2048, 128, SN, SR),
                                    (2, 2000, 128, SN, SR),
                                    (2, 960, 60, SN, SR), (2, 1000, 60, SN, SR),
                                    (2, 1024, 128, 24, SR),
                                    (2, 1024, 128, 64, SR),
                                    (1, 512, 128, 192, SR),
                                    (2, 1000, 128, SN, 3)):
            # R = 3: B and C views of odd offset and row stride (copied by
            # loads and stores, not cp.async).
            xz = _rand(gen, Bt, Lm, 2 * SD, dtype=dtype)
            xd = _rand(gen, Bt, Lm, R + 2 * N, dtype=dtype)
            w = _mamba_weights(gen, dtype, N=N)
            args = (xz[..., :SD], M.softplus(_rand(gen, Bt, Lm, SD) - 3.0),
                    w['A'], xd[..., R:R + N], xd[..., R + N:], w['D'],
                    xz[..., SD:])
            name = f'ssm_scan B={Bt} L={Lm} chunk={chunk} d_state={N} R={R}'
            got = M.ssm_scan(*args, chunk=chunk, return_h0s=True)
            want = M.ssm_scan_plain(*args, chunk=chunk, return_h0s=True)
            _fwd_pair(rec14, name, dtype, got, want, rel=N > SN)
            _rerun_equal(name, lambda: M.ssm_scan(*args, chunk=chunk,
                                                  return_h0s=True), got)
            if dtype == torch.float32 and Lm == 2048:
                rec14['f64_gap'] = _f64_gap(('y', 'h0s'), got, want,
                                            _f64_scan(args, chunk))
        # The cases above run the three passes (a batch of 2); the walk
        # (`scan_fwd_kernel`) runs where a batch fills the card with 3
        # blocks of 16 channels an SM: a chunk that ends inside its 16-row
        # batch (60, 48), groups past 16 states, B and C of odd offset and
        # row stride, a ragged channel tile (d 200 at B=32), K14 and K18.
        for Bt, Lm, chunk, N, R, d in ((16, 240, 60, 24, 3, SD),
                                       (32, 128, 16, SN, SR, 200)):
            xz = _rand(gen, Bt, Lm, 2 * d, dtype=dtype)
            xd = _rand(gen, Bt, Lm, R + 2 * N, dtype=dtype)
            w = _mamba_weights(gen, dtype, d=d, N=N)
            args = (xz[..., :d], M.softplus(_rand(gen, Bt, Lm, d) - 3.0),
                    w['A'], xd[..., R:R + N], xd[..., R + N:], w['D'],
                    xz[..., d:])
            name = (f'ssm_scan walk B={Bt} L={Lm} d={d} chunk={chunk} '
                    f'd_state={N} R={R}')
            got = M.ssm_scan(*args, chunk=chunk, return_h0s=True)
            want = M.ssm_scan_plain(*args, chunk=chunk, return_h0s=True)
            _fwd_pair(rec14, name, dtype, got, want, rel=N > SN)
            _rerun_equal(name, lambda: M.ssm_scan(*args, chunk=chunk,
                                                  return_h0s=True), got)
            if dtype == torch.float32 and d == SD:
                rec14['f64_gap_walk'] = _f64_gap(('y', 'h0s'), got, want,
                                                 _f64_scan(args, chunk))
        for Bt, Lm, chunk, N in ((16, 240, 48, SN), (16, 256, 128, 24)):
            w = _mamba_weights(gen, dtype, N=N)
            h = _rand(gen, Bt, Lm, SH, dtype=dtype)
            kw = dict(d_state=N, dt_rank=SR, chunk=chunk,
                      compute_dtype=dtype, return_h0s=True)
            name = f'mamba_inner walk B={Bt} L={Lm} chunk={chunk} d_state={N}'
            got = M.mamba_inner(h, **w, **kw)
            _fwd_pair(rec18, name, dtype, got,
                      M.mamba_inner_plain(h, **w, **kw), rel=N > SN)
            _rerun_equal(name, lambda: M.mamba_inner(h, **w, **kw), got)
        results['ssm_scan'][str(dtype)] = rec14

    # Times at the main path's shape, bf16, on the first 16 of 32 rows.
    bf = torch.bfloat16
    M_rows, nx = 2 * SB * SL, SR + 2 * SN
    w = _mamba_weights(gen, bf)
    h32 = _rand(gen, 4 * SB, SL, SH, dtype=bf)
    h = h32[:2 * SB]
    kw = dict(d_state=SN, dt_rank=SR)
    rec18 = results['mamba_inner'][str(bf)]
    rec18['ms'] = time_ms(lambda: M.mamba_inner(h, **w, **kw))
    rec18['plain_ms'] = time_ms(lambda: M.mamba_inner_plain(h, **w, **kw),
                                reps=3, warmup=1)
    rec18['main_path'] = _fwd_pair(
        rec18, f'mamba_inner B={2 * SB} L={SL}', bf,
        M.mamba_inner(h, **w, **kw, return_h0s=True),
        M.mamba_inner_plain(h, **w, **kw, return_h0s=True))
    # C.8: a row's out and h0s are the same bits alone and among 4, 8, 16
    # and 32 rows (the three passes below 16 rows, the walk from 16).
    rec18['rows_at_4_vs_16_diff'] = _rows_any_batch(
        'mamba_inner bf16', lambda x: M.mamba_inner(
            x, **w, **kw, return_h0s=True), h32)
    del h32
    # The yardstick for its GEMM share: its four products through
    # torch.matmul at the same shapes (bf16; dt_proj fp32).
    u = _rand(gen, M_rows, SD, dtype=bf)
    lr = _rand(gen, M_rows, SR)
    h2 = h.reshape(M_rows, SH)
    rec18['products_matmul_ms'] = time_ms(lambda: (
        h2 @ w['W_in'], u @ w['W_x'], lr @ w['W_dt'], u @ w['W_out']))
    # Bytes: h in, out out, the weights once. Operations (per token): the
    # bf16 products of in_proj, x_proj and out_proj on the tensor cores,
    # dt_proj in fp32, and the exps and logs (exp(delta A) over d x N,
    # softplus's exp and log1p, the two sigmoids) on the SFU.
    wbytes = 2 * (SH * 2 * SD + SD * nx + SD * SH + 5 * SD) \
        + 4 * (SR * SD + 3 * SD + SD * SN)
    rec18['bound_ms'], rec18['bound_by'] = bound_mixed(
        2 * M_rows * SH * 2 + wbytes,
        ((2 * M_rows * (SH * 2 * SD + SD * nx + SD * SH), PEAK_BF16_TENSOR),
         (2 * M_rows * SR * SD, PEAK_FP32),
         (M_rows * SD * (SN + 4), PEAK_SFU)))
    del h, h2, u, lr

    rec14 = results['ssm_scan'][str(bf)]
    xz = _rand(gen, 4 * SB, SL, 2 * SD, dtype=bf)
    xd = _rand(gen, 4 * SB, SL, nx, dtype=bf)
    a32 = (xz[..., :SD], M.softplus(_rand(gen, 4 * SB, SL, SD) - 3.0),
           w['A'], xd[..., SR:SR + SN], xd[..., SR + SN:], w['D'],
           xz[..., SD:])
    args = _batched(a32, 2 * SB)
    rec14['ms'] = time_ms(lambda: M.ssm_scan(*args))
    rec14['plain_ms'] = time_ms(lambda: M.ssm_scan_plain(*args), reps=3,
                                warmup=1)
    rec14['main_path'] = _fwd_pair(
        rec14, f'ssm_scan B={2 * SB} L={SL}', bf,
        M.ssm_scan(*args, return_h0s=True),
        M.ssm_scan_plain(*args, return_h0s=True))
    rec14['rows_at_4_vs_16_diff'] = _rows_any_batch(
        'ssm_scan bf16', lambda *x: M.ssm_scan(*x, return_h0s=True), *a32)
    del a32, xz, xd
    # C.8 in fp32, at a shorter L (the design follows the batch and d, not
    # L): K14 and K18, the first rows alone and among 4 to 32.
    f32 = torch.float32
    w32 = _mamba_weights(gen, f32)
    xz = _rand(gen, 4 * SB, 4096, 2 * SD)
    xd = _rand(gen, 4 * SB, 4096, nx)
    a32 = (xz[..., :SD], M.softplus(_rand(gen, 4 * SB, 4096, SD) - 3.0),
           w32['A'], xd[..., SR:SR + SN], xd[..., SR + SN:], w32['D'],
           xz[..., SD:])
    results['ssm_scan'][str(f32)]['rows_at_4_vs_16_diff'] = _rows_any_batch(
        'ssm_scan fp32', lambda *x: M.ssm_scan(*x, return_h0s=True), *a32)
    results['mamba_inner'][str(f32)]['rows_at_4_vs_16_diff'] = \
        _rows_any_batch('mamba_inner fp32', lambda x: M.mamba_inner(
            x, **w32, **kw, compute_dtype=f32, return_h0s=True),
            _rand(gen, 4 * SB, 4096, SH))
    del a32, xz, xd
    # Bytes: u, z, y (bf16) and delta (fp32) per (row, channel), B and C
    # per row, the chunk entry states out. Operations: exp(delta A) per
    # state and the gate's sigmoid, on the SFU.
    n_chunks = SL // 128
    rec14['bound_ms'], rec14['bound_by'] = bound_mixed(
        M_rows * SD * (2 + 2 + 2 + 4) + M_rows * 2 * SN * 2
        + 2 * SB * n_chunks * SN * SD * 4 + 4 * SD * (SN + 1),
        ((M_rows * SD * (SN + 1), PEAK_SFU),))
    check_mamba_smem()
    check_mamba_dtlr(results, gen)
    check_mamba_wide(results, gen)


# ROADMAP C.1: the shapes the card's kernels were widened to take, run at
# B=2, L=1024 with fp32 rows held to 1e-4 of their largest magnitude
# (`_close`'s `rel`): (label, H, d_inner, d_state, dt_rank, d_conv).
WIDE_SHAPES = (('d_state24', SH, SD, 24, SR, 4), ('d_state64', SH, SD, 64, SR, 4),
               ('d_conv6', SH, SD, SN, SR, 6), ('d_conv8', SH, SD, SN, SR, 8),
               ('hidden768', 768, 1536, SN, 48, 4),
               ('hidden1536', 1536, 3072, SN, 96, 4))
WIDE_B, WIDE_L = 2, 1024
# The scans alone (K14-K17) also at d_state 192 with dt_rank 96, at the
# largest dt_rank the first K17 design held (248 at d_state 16, 184 past
# it), and past it in rank tiles (300 and 512 at d_state 16, 512 past K16's
# first 360-rank tile too; 256 at d_state 32): (label, d_inner, d_state,
# dt_rank).
WIDE_SCAN_SHAPES = (('d_state192_rank96', SD, 192, 96),
                    ('rank248', SD, SN, 248), ('d_state32_rank184', SD, 32, 184),
                    ('rank300', SD, SN, 300), ('d_state32_rank256', SD, 32, 256),
                    ('rank512', SD, SN, 512))
# ROADMAP C.6: K18 past the old front tile's d_inner cap (7120 in bf16,
# 3560 in fp32) at B=1, L=256, hidden 4096 (dt_rank 256); K14 and K18 at
# chunk 1024 with d_state 64 at B=2, L=2048 (label, B, L, H, d, N, R, chunk).
C6_SHAPES = (('d_inner8192', 1, 256, 4096, 8192, SN, 256, 128),
             ('chunk1024_d_state64', 2, 2048, SH, SD, 64, SR, 1024))


def _scan_inputs(gen, dtype, Bt, Lm, d=SD, N=SN, R=SR):
    """The scans' operands as the model hands them over: u, z, B, C (and
    dt_lr) views of wider projections of unit scale, W_dt a (R, d) view of
    a torch-layout weight. Returns (K16's nine arguments, K14's seven with
    delta = softplus(dt_lr W_dt + b_dt), the composite)."""
    from ddg_tpu_torch.ops import mamba as M
    xz = _rand(gen, Bt, Lm, 2 * d, dtype=dtype)
    xd = _rand(gen, Bt, Lm, R + 2 * N, dtype=dtype)
    w = _mamba_weights(gen, dtype, H=8, d=d, R=R, N=N)
    lr = xd[..., :R].float()
    u, z, Bc, Cc = xz[..., :d], xz[..., d:], xd[..., R:R + N], xd[..., R + N:]
    delta = M.softplus(lr @ w['W_dt'] + w['b_dt'])
    return ((u, lr, w['W_dt'], w['b_dt'], w['A'], Bc, Cc, w['D'], z),
            (u, delta, w['A'], Bc, Cc, w['D'], z))


def check_mamba_dtlr(results, gen):
    """K16 (`ssm_scan_dtlr`) against its plain version, and bit for bit
    against K14 fed the composite softplus(dt_lr W_dt + b_dt) (y and h0s
    equal), fp32 and bf16: at B=2, L=2048, at d_inner 200 (a ragged
    channel tile of the adjoint's 64; also at chunk 60, a sub-chunk of 60
    rows in the backward), at d_inner 100 with chunk 50 (a ragged tile of
    the forward scan's 16 channels, chunk ends inside a batch of 8 rows),
    at the dt-lowrank serving path's shape
    (16 x 32768: D-CFG doubles B=8; d 512, N 16, R 16) and at its training
    path's (DIMAMBA_DTLR_TRAIN_MICRO_BATCH x 32768). Timed in bf16 at the
    serving shape beside its bound, its plain version and the composite
    (dt_proj by torch.matmul, softplus, K14), and at the training shape
    (`ms_train_shape`)."""
    from ddg_tpu_torch.entry import DIMAMBA_DTLR_TRAIN_MICRO_BATCH as TB
    from ddg_tpu_torch.ops import mamba as M
    SB2 = 2 * SB
    for dtype in (torch.float32, torch.bfloat16):
        rec = {}
        for Bt, Lm, d, chunk in ((2, 2048, SD, 128), (2, 1024, 200, 128),
                                 (2, 960, 200, 60), (2, 1000, 100, 50),
                                 (SB2, SL, SD, 128), (TB, SL, SD, 128)):
            a16, a14 = _scan_inputs(gen, dtype, Bt, Lm, d=d)
            got = M.ssm_scan_dtlr(*a16, chunk=chunk, return_h0s=True)
            name = f'ssm_scan_dtlr B={Bt} L={Lm} d={d} chunk={chunk}'
            _fwd_pair(rec, name, dtype, got,
                      M.ssm_scan_dtlr_plain(*a16, chunk=chunk,
                                            return_h0s=True))
            want = M.ssm_scan(*a14, chunk=chunk, return_h0s=True)
            check(torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1]),
                  f'{name} {dtype}: differs from K14 fed the composite '
                  f'delta (y {(got[0].float() - want[0].float()).abs().max()}'
                  f', h0s {(got[1] - want[1]).abs().max()})')
            rec['equals_ssm_scan_on_composite'] = True
            del a16, a14, got, want
        results['ssm_scan_dtlr'][str(dtype)] = rec
    bf = torch.bfloat16
    rec = results['ssm_scan_dtlr'][str(bf)]
    a16, a14 = _scan_inputs(gen, bf, SB2, SL)
    rec['ms'] = time_ms(lambda: M.ssm_scan_dtlr(*a16), reps=10)
    rec['plain_ms'] = time_ms(lambda: M.ssm_scan_dtlr_plain(*a16), reps=3,
                              warmup=1)
    lr, w_dt, b_dt = a16[1], a16[2], a16[3]
    rec['composite_ms'] = time_ms(lambda: M.ssm_scan(
        a14[0], M.softplus(lr @ w_dt + b_dt), *a14[2:]), reps=10)
    rec['library_ms'] = None
    del a16, a14
    a16, _ = _scan_inputs(gen, bf, TB, SL)
    rec['ms_train_shape'] = time_ms(lambda: M.ssm_scan_dtlr(*a16), reps=10)
    del a16
    # C.8: y and h0s of the first rows alone and among 4 to 32, bf16 at the
    # serving path's L, fp32 at a shorter one.
    for dtype, Lm in ((bf, SL), (torch.float32, 4096)):
        a16, _ = _scan_inputs(gen, dtype, 4 * SB, Lm)
        results['ssm_scan_dtlr'][str(dtype)]['rows_at_4_vs_16_diff'] = \
            _rows_any_batch(f'ssm_scan_dtlr {dtype}', lambda *x:
                            M.ssm_scan_dtlr(*x, return_h0s=True), *a16)
        del a16
    # Bytes: u, z, y (bf16) per (row, channel); dt_lr (fp32), B and C per
    # row; the chunk entry states out; the weights. Operations: per (row,
    # channel) exp(delta A) per state, softplus's exp and log1p and the
    # gate's sigmoid on the SFU; dt_proj's FMAs in fp32.
    M_rows, n_chunks = SB2 * SL, SL // 128
    rec['bound_ms'], rec['bound_by'] = bound_mixed(
        M_rows * SD * 6 + M_rows * (4 * SR + 4 * SN)
        + SB2 * n_chunks * SN * SD * 4 + 4 * SD * (SR + SN + 2),
        ((M_rows * SD * (SN + 3), PEAK_SFU), (2 * M_rows * SR * SD, PEAK_FP32)))
    rec['shape'] = [SB2, SL, SD, SN, SR]


def check_mamba_smem():
    """The wrappers' mirror of the kernels' shared-memory sums
    (`ops.mamba.scan_smem`, `_front_smem`, `_SMEM`, which decide what
    `ssm_scan_takes`, `ssm_scan_dtlr_takes` and `mamba_inner_takes` accept
    without a card) equals the sums the built kernels use
    (`ddg_scan_smem`, `ddg_scan_bwd_smem`, `ddg_front_smem`,
    `ddg_smem_max`): at Species10's shape, the WIDE_SHAPES, the d_state
    and dt_rank at and past each rank tile's width (128 for K17's passes,
    360 for K16's delta kernel) and where the first K17 design stopped
    holding dt_proj's adjoint, at chunks 16, 60, 128 and 1024; the front's
    for both element sizes."""
    import ctypes
    from ddg_tpu_torch.ops import _build
    from ddg_tpu_torch.ops import mamba as M
    i32, ll = _build.i32, ctypes.c_longlong
    fwd = _build.kernel('mamba', 'ddg_scan_smem', (i32,) * 3, ll)
    bwd = _build.kernel('mamba_bwd', 'ddg_scan_bwd_smem', (i32,) * 3, ll)
    front = _build.kernel('mamba', 'ddg_front_smem', (i32,), i32)
    smem_max = _build.kernel('mamba', 'ddg_smem_max', (), i32)()
    check(smem_max == M._SMEM, f'kSmemMax {smem_max} != ops.mamba._SMEM '
          f'{M._SMEM}')
    n = 0
    for chunk in (128, 16, 60, 1024):
        for N in sorted({SN, 17, 24, 64, 96, 97, 112, 113, 128, 144, 145,
                         160, 161, 176, 192, 512}):
            for R in (0, SR, 48, 64, 96, 128, 129, 184, 185, 248, 249, 256,
                      300, 360, 361, 512, 4096):
                py, c = M.scan_smem(chunk, N, R), max(fwd(chunk, N, R),
                                                      bwd(chunk, N, R))
                check(py == c, f'scan_smem(chunk={chunk}, N={N}, R={R}): '
                      f'{py} in ops.mamba, {c} in csrc')
                n += 1
    for esize in (2, 4):
        py, c = M._front_smem(esize), front(esize)
        check(py == c, f'front shared memory ({esize}-byte rows): {py} in '
              f'ops.mamba, {c} in csrc')
        n += 1
    emit({'phase': 'mamba_smem_mirror', 'cases': n, 'smem_max': smem_max})


def _f64_scan(a14, chunk=128):
    """K14's (y, h0s) on its operands in float64 (the plain version's sums
    and order, A's fp32 round trip kept): the yardstick for how far the
    fp32 plain version and the kernel lie from the exact sums."""
    from ddg_tpu_torch.ops import mamba as M
    u, delta, A, Bc, Cc, D, z = (t.double() for t in a14)
    y, h0s = M.scan_chunks(u, delta, M._round_trip(a14[2]).double(), Bc, Cc,
                           chunk)
    return (y + D * u) * (z * torch.sigmoid(z)), h0s


def _f64_gap(outs, got, plain, exact):
    """{output: [max |plain - exact|, max |kernel - exact|, max |exact|]}."""
    return {n: [(p.double() - e).abs().max().item(),
                (g.double() - e).abs().max().item(), e.abs().max().item()]
            for n, g, p, e in zip(outs, got, plain, exact)}


def _wide_scans(results, gen, dtype, label, d, N, R):
    """K14 and K16 against their plain versions at one widened shape (fp32
    rows to 1e-4 of their largest magnitude); in fp32 K14's y from both
    also against float64 (recorded)."""
    from ddg_tpu_torch.ops import mamba as M
    a16, a14 = _scan_inputs(gen, dtype, WIDE_B, WIDE_L, d=d, N=N, R=R)
    for name, fn, plain, a in (
            ('ssm_scan', M.ssm_scan, M.ssm_scan_plain, a14),
            ('ssm_scan_dtlr', M.ssm_scan_dtlr, M.ssm_scan_dtlr_plain, a16)):
        rec = results[name][str(dtype)]
        got, want = fn(*a, return_h0s=True), plain(*a, return_h0s=True)
        rec.setdefault('widened', {})[label] = _fwd_pair(
            rec, f'{name} {label}', dtype, got, want, rel=True)['err']
        if name == 'ssm_scan' and dtype == torch.float32:
            rec.setdefault('widened_vs_f64', {})[label] = _f64_gap(
                ('y',), got, want, _f64_scan(a14))


def check_mamba_wide(results, gen):
    """The C.1 and C.6 shapes (WIDE_SHAPES, C6_SHAPES) on K18, K14 and K16
    against their plain versions, fp32 and bf16, fp32 rows to 1e-4 of
    their largest magnitude (`_close`'s `rel`): K18 at every shape, the
    scans at those whose d_state, d_inner or dt_rank differ from
    Species10's and at the WIDE_SCAN_SHAPES (`_wide_scans`), K14 also at
    C6_SHAPES' chunk 1024."""
    from ddg_tpu_torch.ops import mamba as M
    for dtype in (torch.float32, torch.bfloat16):
        for label, H, d, N, R, K in WIDE_SHAPES:
            w = _mamba_weights(gen, dtype, H=H, d=d, R=R, N=N, K=K)
            h = _rand(gen, WIDE_B, WIDE_L, H, dtype=dtype)
            kw = dict(d_state=N, dt_rank=R, compute_dtype=dtype,
                      return_h0s=True)
            rec = results['mamba_inner'][str(dtype)]
            rec.setdefault('widened', {})[label] = _fwd_pair(
                rec, f'mamba_inner {label}', dtype, M.mamba_inner(h, **w, **kw),
                M.mamba_inner_plain(h, **w, **kw), rel=True)['err']
            if K == 4:
                _wide_scans(results, gen, dtype, label, d, N, R)
        for label, d, N, R in WIDE_SCAN_SHAPES:
            _wide_scans(results, gen, dtype, label, d, N, R)
        for label, Bt, Lm, H, d, N, R, chunk in C6_SHAPES:
            w = _mamba_weights(gen, dtype, H=H, d=d, R=R, N=N)
            h = _rand(gen, Bt, Lm, H, dtype=dtype)
            kw = dict(d_state=N, dt_rank=R, chunk=chunk, compute_dtype=dtype,
                      return_h0s=True)
            rec = results['mamba_inner'][str(dtype)]
            rec.setdefault('widened', {})[label] = _fwd_pair(
                rec, f'mamba_inner {label}', dtype, M.mamba_inner(h, **w, **kw),
                M.mamba_inner_plain(h, **w, **kw), rel=True)['err']
            del w, h
            if d != SD:
                continue
            _, a14 = _scan_inputs(gen, dtype, Bt, Lm, d=d, N=N, R=R)
            rec = results['ssm_scan'][str(dtype)]
            rec.setdefault('widened', {})[label] = _fwd_pair(
                rec, f'ssm_scan {label}', dtype,
                M.ssm_scan(*a14, chunk=chunk, return_h0s=True),
                M.ssm_scan_plain(*a14, chunk=chunk, return_h0s=True),
                rel=True)['err']


# Outputs of the backward kernels: per row (the 1e-4 / 2-ulp bars) or sums
# over rows (`_close_grad`).
K15_OUT = (('du', 'row'), ('ddelta', 'row'), ('dB', 'row'), ('dC', 'row'),
           ('dA_log', 'sum'), ('dz', 'row'), ('dD', 'sum'))
K17_OUT = (('du', 'row'), ('ddt_lr', 'row'), ('dW_dt', 'sum'),
           ('db_dt', 'sum'), ('dB', 'row'), ('dC', 'row'), ('dA_log', 'sum'),
           ('dz', 'row'), ('dD', 'sum'))
K19_OUT = (('dh', 'row'), ('dW_in', 'sum'), ('dconv_w', 'sum'),
           ('dconv_b', 'sum'), ('dW_x', 'sum'), ('dW_dt', 'sum'),
           ('db_dt', 'sum'), ('dA_log', 'sum'), ('dD', 'sum'),
           ('dW_out', 'sum'))


def _close_grad(name, dtype, kind, out, ref, rel=False):
    """A backward output against its plain version: rows at the usual
    bars (`_close`, with `rel`); sums over rows (fp32 whatever the inputs) at 1e-5 of their
    largest magnitude in float32 and 2 ulp of it when the inputs were
    bf16 (a rounding flip of a bf16 operand moves a sum by up to that)."""
    if kind == 'row':
        return _close(name, dtype, out, ref, rel)
    err = (out.float() - ref.float()).abs().max().item()
    tol = (SUM_RTOL * ref.float().abs().max().item()
           if dtype == torch.float32 else bf16_tol(ref))
    check(err <= tol, f'{name} {dtype}: max abs err {err} > {tol}')
    return err, tol


def _bwd_case(rec, label, dtype, names, call, plain, rel=False,
              differs_bar=None):
    """Kernel (twice: every output bit-identical) against plain (rows with
    `rel`, `_close`); the errors go into rec['outputs'][label] and raise
    rec's maxima. With `differs_bar`, the share of each output's elements
    that differ from the plain version's at all must stay at or under it
    (rec['differs_from_plain'][name] keeps the largest)."""
    got, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    errs = {}
    for (name, kind), a, b, c in zip(names, got, again, ref):
        check(torch.equal(a, b), f'{label} {name}: reruns differ')
        check(a.shape == c.shape and a.dtype == c.dtype,
              f'{label} {name}: {a.shape} {a.dtype} vs {c.shape} {c.dtype}')
        err, tol = _close_grad(f'{label} {name}', dtype, kind, a, c, rel)
        errs[name] = [err, tol]
        key = 'err' if kind == 'row' else 'sum_err_of_tol'
        rec[key] = max(rec.get(key, 0.0), err if kind == 'row' else err / tol)
        if differs_bar is not None:
            share = (a != c).float().mean().item()
            seen = rec.setdefault('differs_from_plain', {})
            seen[name] = max(seen.get(name, 0.0), share)
            check(share <= differs_bar, f'{label} {name}: {share:.4f} of the '
                                        f'outputs differ from the plain '
                                        f'version (bar {differs_bar})')
    rec.setdefault('outputs', {})[label] = errs
    return got


def check_mamba_bwd(results):
    """K19 (`mamba_inner_bwd`) and K15 (`ssm_scan_bwd`) against their plain
    versions on the card at the DiMamba's widths, fp32 and bf16, each run
    twice with bit-identical outputs: K19 on the forward direction's
    weights and on another set with flipped rows (as the model runs
    `core_rev`) at B=2, L=2048, and at L=80, chunk 16 (ragged row tiles);
    K15 on u, z, B, C as views of wider projections at L=2048 and L=2000 (a
    padded last chunk). Then in bf16 at the training main path's shape
    (DIMAMBA_TRAIN_MICRO_BATCH x 32768), timed there beside the bound, the
    plain version and (K19) its products through `torch.matmul`."""
    from ddg_tpu_torch.entry import DIMAMBA_TRAIN_MICRO_BATCH as TB
    from ddg_tpu_torch.ops import mamba as M
    gen = torch.Generator(device=DEV).manual_seed(19)
    nx = SR + 2 * SN

    def k19_args(dtype, Bt, Lm, chunk, rev):
        w = _mamba_weights(gen, dtype)
        h = _rand(gen, Bt, Lm, SH, dtype=dtype)
        if rev:
            h = torch.flip(h, (1,))
        kw = dict(d_state=SN, dt_rank=SR, chunk=chunk, compute_dtype=dtype)
        _, h0s = M.mamba_inner(h, **w, **kw, return_h0s=True)
        g = _rand(gen, Bt, Lm, SH, dtype=dtype)
        return (h, *w.values(), h0s, g), kw

    def k15_args(dtype, Bt, Lm, chunk=128):
        xz = _rand(gen, Bt, Lm, 2 * SD, dtype=dtype)
        xd = _rand(gen, Bt, Lm, nx, dtype=dtype)
        w = _mamba_weights(gen, dtype)
        args = (xz[..., :SD], M.softplus(_rand(gen, Bt, Lm, SD) - 3.0),
                w['A'], xd[..., SR:SR + SN], xd[..., SR + SN:], w['D'],
                xz[..., SD:])
        _, h0s = M.ssm_scan(*args, chunk=chunk, return_h0s=True)
        return (*args, h0s, _rand(gen, Bt, Lm, SD, dtype=dtype)), \
            {'chunk': chunk}

    for dtype in (torch.float32, torch.bfloat16):
        rec19, rec15 = {}, {}
        for Bt, Lm, chunk, rows in ((2, 2048, 128, 'fwd'),
                                    (2, 2048, 128, 'rev'),
                                    (2, 80, 16, 'ragged')):
            a, kw = k19_args(dtype, Bt, Lm, chunk, rows == 'rev')
            _bwd_case(rec19, f'mamba_inner_bwd {rows} B={Bt} L={Lm}', dtype,
                      K19_OUT, lambda: M.mamba_inner_bwd(*a, **kw),
                      lambda: M.mamba_inner_bwd_plain(*a, **kw))
        for Bt, Lm in ((2, 2048), (2, 2000)):
            a, kw = k15_args(dtype, Bt, Lm)
            _bwd_case(rec15, f'ssm_scan_bwd B={Bt} L={Lm}', dtype, K15_OUT,
                      lambda: M.ssm_scan_bwd(*a, **kw),
                      lambda: M.ssm_scan_bwd_plain(*a, **kw))
        results['mamba_inner_bwd'][str(dtype)] = rec19
        results['ssm_scan_bwd'][str(dtype)] = rec15

    # The training main path's shape, bf16: held against the plain versions
    # (one call each: they hold many GB), then timed.
    bf = torch.bfloat16
    M_rows = TB * SL
    rec19 = results['mamba_inner_bwd'][str(bf)]
    a, kw = k19_args(bf, TB, SL, 128, False)
    _bwd_case(rec19, f'mamba_inner_bwd B={TB} L={SL}', bf, K19_OUT,
              lambda: M.mamba_inner_bwd(*a, **kw),
              lambda: M.mamba_inner_bwd_plain(*a, **kw))
    rec19['ms'] = time_ms(lambda: M.mamba_inner_bwd(*a, **kw), reps=10)
    rec19['plain_ms'] = time_ms(lambda: M.mamba_inner_bwd_plain(*a, **kw),
                                reps=1, warmup=0)
    # The yardstick: its products through torch.matmul at the same shapes
    # (bf16; dt_proj's three in fp32).
    h2 = a[0].reshape(M_rows, SH)
    w_in, w_x, w_dt, w_out = a[1], a[4], a[5], a[9]
    u = _rand(gen, M_rows, SD, dtype=bf)
    dxz = _rand(gen, M_rows, 2 * SD, dtype=bf)
    dxd = _rand(gen, M_rows, nx, dtype=bf)
    lr, dpre = _rand(gen, M_rows, SR), _rand(gen, M_rows, SD)
    rec19['library_ms'] = time_ms(lambda: (
        h2 @ w_in, u @ w_x, h2 @ w_out.t(), dxd @ w_x.t(), u.t() @ dxd,
        lr @ w_dt, dpre @ w_dt.t(), lr.t() @ dpre, dxz @ w_in.t(),
        h2.t() @ dxz, u.t() @ h2), reps=10)
    # Per token: bf16 products (in_proj and x_proj recomputed, dy, x_proj's
    # adjoint and dW_x, dh and dW_in, dW_out) on the tensor cores; dt_proj
    # forward, its adjoint and dW_dt in fp32; on the SFU exp(delta A) over
    # d x N, softplus's exp and log1p and three sigmoids (xc, z, pre) a
    # channel. Bytes: h, g and dh, the chunk entry states, the weights.
    n_chunks = SL // 128
    wbytes = 2 * (SH * 2 * SD + SD * nx + SD * SH + 5 * SD) \
        + 4 * (SR * SD + 3 * SD + SD * SN)
    rec19['bound_ms'], rec19['bound_by'] = bound_mixed(
        3 * M_rows * SH * 2 + TB * n_chunks * SN * SD * 4 + 2 * wbytes,
        ((2 * M_rows * (3 * SH * 2 * SD + 3 * SD * nx + 2 * SD * SH),
          PEAK_BF16_TENSOR),
         (3 * 2 * M_rows * SR * SD, PEAK_FP32),
         (M_rows * SD * (SN + 5), PEAK_SFU)))
    rec19['shape'] = [TB, SL, SH, SD]
    del a, h2, u, dxz, dxd, lr, dpre

    rec15 = results['ssm_scan_bwd'][str(bf)]
    a, kw = k15_args(bf, TB, SL)
    _bwd_case(rec15, f'ssm_scan_bwd B={TB} L={SL}', bf, K15_OUT,
              lambda: M.ssm_scan_bwd(*a, **kw),
              lambda: M.ssm_scan_bwd_plain(*a, **kw))
    rec15['ms'] = time_ms(lambda: M.ssm_scan_bwd(*a, **kw), reps=10)
    rec15['plain_ms'] = time_ms(lambda: M.ssm_scan_bwd_plain(*a, **kw),
                                reps=1, warmup=0)
    # Bytes: u, z, g (bf16) and delta (fp32) in and du, dz (bf16), ddelta
    # (fp32) out per (row, channel); B, C in and dB, dC out per row; the
    # chunk entry states. Operations: exp(delta A) per state and the gate's
    # sigmoid, on the SFU.
    rec15['bound_ms'], rec15['bound_by'] = bound_mixed(
        M_rows * SD * 18 + M_rows * 4 * SN * 2 + TB * n_chunks * SN * SD * 4
        + 4 * SD * (2 * SN + 2),
        ((M_rows * SD * (SN + 1), PEAK_SFU),))
    rec15['library_ms'] = None
    rec15['shape'] = [TB, SL, SD]
    del a
    check_rows_any_batch_bwd(results, gen)
    check_mamba_dtlr_bwd(results, gen)
    check_mamba_wide_bwd(results, gen)


def check_rows_any_batch_bwd(results, gen, Lm=4096):
    """ROADMAP C.8 through the backwards: the first 4 rows' gradients of
    K19, K15 and K17 (their row outputs; the weight gradients sum over the
    batch) are the same bits at micro-batch 4 and 16, each run on the h0s
    of its own forward (K18, K14, K16), bf16 and fp32, at L=4096 (the
    forward's design follows the batch and d, not L)."""
    from ddg_tpu_torch.ops import mamba as M
    kw = dict(d_state=SN, dt_rank=SR)
    for dtype in (torch.float32, torch.bfloat16):
        w = _mamba_weights(gen, dtype)
        wv = tuple(w.values())
        h, g = (_rand(gen, 16, Lm, SH, dtype=dtype) for _ in range(2))

        def k19(h, g):
            _, h0s = M.mamba_inner(h, *wv, **kw, compute_dtype=dtype,
                                   return_h0s=True)
            return M.mamba_inner_bwd(h, *wv, h0s, g, **kw,
                                     compute_dtype=dtype)
        _, a14 = _scan_inputs(gen, dtype, 16, Lm)
        g14 = _rand(gen, 16, Lm, SD, dtype=dtype)

        def k15(*a):
            _, h0s = M.ssm_scan(*a[:7], return_h0s=True)
            return M.ssm_scan_bwd(*a[:7], h0s, a[7])
        a16, _ = _scan_inputs(gen, dtype, 16, Lm)

        def k17(*a):
            _, h0s = M.ssm_scan_dtlr(*a[:9], return_h0s=True)
            return M.ssm_scan_dtlr_bwd(*a[:9], h0s, a[9])
        rec = results.setdefault('rows_any_batch_bwd', {})
        for name, fn, args, outs in (
                ('mamba_inner_bwd', k19, (h, g), K19_OUT),
                ('ssm_scan_bwd', k15, (*a14, g14), K15_OUT),
                ('ssm_scan_dtlr_bwd', k17, (*a16, g14), K17_OUT)):
            keep = [i for i, (_, kind) in enumerate(outs) if kind == 'row']
            rec[f'{name} {dtype}'] = _rows_any_batch(
                f'{name} {dtype}', fn, *args, batches=(4, 16), keep=keep)
        del h, g, a14, a16, g14


def _k17_args(gen, dtype, Bt, Lm, d=SD, N=SN, R=SR, chunk=128):
    """K17's arguments: K16's inputs, the chunk entry states of K16's
    forward on them and a cotangent."""
    from ddg_tpu_torch.ops import mamba as M
    a16, _ = _scan_inputs(gen, dtype, Bt, Lm, d=d, N=N, R=R)
    _, h0s = M.ssm_scan_dtlr(*a16, chunk=chunk, return_h0s=True)
    return (*a16, h0s, _rand(gen, Bt, Lm, d, dtype=dtype))


def check_mamba_dtlr_bwd(results, gen):
    """K17 (`ssm_scan_dtlr_bwd`) against its plain backward, fp32 and bf16,
    twice each with bit-identical outputs (`_bwd_case`): at B=2, L=2048, at
    d_inner 200 (a ragged channel tile of the adjoint's 64; also at chunk
    60, one sub-chunk of 60 rows with a partial segment), at 16 x 32768
    (the fused route's micro-batch) and at
    the dt-lowrank training path's shape, DIMAMBA_DTLR_TRAIN_MICRO_BATCH x
    32768. Timed in bf16 at the path's shape beside its bound, its plain
    version and the composite (dt_proj and softplus, K15, the dt products
    by torch.matmul)."""
    from ddg_tpu_torch.entry import DIMAMBA_DTLR_TRAIN_MICRO_BATCH as TB
    from ddg_tpu_torch.ops import mamba as M
    for dtype in (torch.float32, torch.bfloat16):
        rec = {}
        for Bt, Lm, d, chunk in ((2, 2048, SD, 128), (2, 1024, 200, 128),
                                 (2, 960, 200, 60), (2 * SB, SL, SD, 128),
                                 (TB, SL, SD, 128)):
            a = _k17_args(gen, dtype, Bt, Lm, d=d, chunk=chunk)
            _bwd_case(rec, f'ssm_scan_dtlr_bwd B={Bt} L={Lm} d={d} '
                      f'chunk={chunk}', dtype, K17_OUT,
                      lambda: M.ssm_scan_dtlr_bwd(*a, chunk=chunk),
                      lambda: M.ssm_scan_dtlr_bwd_plain(*a, chunk=chunk))
            if Bt == TB and dtype == torch.bfloat16:
                rec['ms'] = time_ms(lambda: M.ssm_scan_dtlr_bwd(*a), reps=10)
                rec['plain_ms'] = time_ms(
                    lambda: M.ssm_scan_dtlr_bwd_plain(*a), reps=1, warmup=0)
                u, lr, w_dt, b_dt, A, Bc, Cc, D, z, _, g = a
                pre = lr @ w_dt + b_dt
                _, h0s = M.ssm_scan(u, M.softplus(pre), A, Bc, Cc, D, z,
                                    return_h0s=True)

                def composite():
                    p = lr @ w_dt + b_dt
                    ddt = M.ssm_scan_bwd(u, M.softplus(p), A, Bc, Cc, D, z,
                                         h0s, g)[1]
                    dpre = ddt * torch.sigmoid(p)
                    rows = dpre.reshape(-1, d)
                    return (dpre @ w_dt.t(), lr.reshape(-1, SR).t() @ rows,
                            rows.sum(0))

                rec['composite_ms'] = time_ms(composite, reps=10)
                rec['library_ms'] = None
                # K15 on the same operands (delta the composite's), in the
                # same call: K17's own part is the difference.
                delta = M.softplus(pre)
                rec['k15_ms'] = time_ms(lambda: M.ssm_scan_bwd(
                    u, delta, A, Bc, Cc, D, z, h0s, g), reps=10)
                rec['own_ms'] = rec['ms'] - rec['k15_ms']
                emit({'phase': 'k17_own_part', 'k17_ms': rec['ms'],
                      'k15_ms': rec['k15_ms'], 'own_ms': rec['own_ms']})
                del u, lr, w_dt, b_dt, A, Bc, Cc, D, z, g, pre, h0s, delta
            del a
        results['ssm_scan_dtlr_bwd'][str(dtype)] = rec
    rec = results['ssm_scan_dtlr_bwd'][str(torch.bfloat16)]
    # Bytes: u, z, g in and du, dz out (bf16) per (row, channel); dt_lr in
    # and ddt_lr out (fp32), B, C in and dB, dC out per row; the chunk entry
    # states; the weights and their gradients. Operations: per (row,
    # channel) exp(delta A) per state, softplus's exp and log1p and the
    # sigmoids of z and pre on the SFU; dt_proj, its adjoint and dW_dt in
    # fp32.
    M_rows, n_chunks = TB * SL, SL // 128
    nbytes = (M_rows * SD * 10 + M_rows * (8 * SR + 8 * SN)
              + TB * n_chunks * SN * SD * 4 + 8 * SD * (SR + SN + 2))
    ops = ((M_rows * SD * (SN + 4), PEAK_SFU),
           (3 * 2 * M_rows * SR * SD, PEAK_FP32))
    rec['bound_ms'], rec['bound_by'] = bound_mixed(nbytes, ops)
    rec['shape'] = [TB, SL, SD, SN, SR]
    # K17's workspace past the adjoint's own (K15's at the same shape) holds
    # no (M, d) array: ddelta stays in pass 3's shared memory.
    ws17 = M.workspace_bytes('ddg_ssm_scan_dtlr_bwd', TB, SL, SD, SN, SR, 128)
    ws15 = M.workspace_bytes('ddg_ssm_scan_bwd', TB, SL, SD, SN, 128)
    rec['workspace_bytes'] = ws17
    rec['workspace_own_bytes'] = ws17 - ws15
    check(ws17 - ws15 < M_rows * SD * 4,
          f'K17 workspace {ws17} is {ws17 - ws15} bytes past the adjoint\'s '
          f'{ws15}: not below M x d x 4 = {M_rows * SD * 4}')


def _wide_scan_bwds(results, gen, dtype, label, d, N, R):
    """K15 and K17 against their plain backwards at one widened shape, twice
    each with bit-identical outputs, fp32 rows to 1e-4 of their largest
    magnitude; in fp32 K15's per-row outputs from the plain version and the
    kernel also against float64 (recorded)."""
    from ddg_tpu_torch.ops import mamba as M
    _, a14 = _scan_inputs(gen, dtype, WIDE_B, WIDE_L, d=d, N=N, R=R)
    _, h0s = M.ssm_scan(*a14, return_h0s=True)
    a15 = (*a14, h0s, _rand(gen, WIDE_B, WIDE_L, d, dtype=dtype))
    rec = results['ssm_scan_bwd'][str(dtype)]
    got = _bwd_case(rec, f'ssm_scan_bwd {label}', dtype, K15_OUT,
                    lambda: M.ssm_scan_bwd(*a15),
                    lambda: M.ssm_scan_bwd_plain(*a15), rel=True)
    if dtype == torch.float32:
        # float64 adjoint from the float64 forward's entry states.
        h0s64 = _f64_scan(a14)[1]
        ddt, du, dB, dC, _, dz, _, _ = M.scan_bwd_chunks(
            *(t.double() for t in a14[:2]), M._round_trip(a14[2]).double(),
            *(t.double() for t in a14[3:]), a15[-1].double(), h0s64, 128)
        plain = M.ssm_scan_bwd_plain(*a15)
        rec.setdefault('widened_vs_f64', {})[label] = _f64_gap(
            ('du', 'ddelta', 'dB', 'dC', 'dz'),
            [got[i] for i in (0, 1, 2, 3, 5)],
            [plain[i] for i in (0, 1, 2, 3, 5)], (du, ddt, dB, dC, dz))
    a17 = _k17_args(gen, dtype, WIDE_B, WIDE_L, d=d, N=N, R=R)
    _bwd_case(results['ssm_scan_dtlr_bwd'][str(dtype)],
              f'ssm_scan_dtlr_bwd {label}', dtype, K17_OUT,
              lambda: M.ssm_scan_dtlr_bwd(*a17),
              lambda: M.ssm_scan_dtlr_bwd_plain(*a17), rel=True)


def check_mamba_wide_bwd(results, gen):
    """The C.1 shapes (WIDE_SHAPES) on K19, K15 and K17 against their plain
    backwards, fp32 and bf16, twice each with bit-identical outputs, fp32
    rows to 1e-4 of their largest magnitude: K19 at every shape, the scans
    at those whose d_state, d_inner or dt_rank differ from Species10's and
    at the WIDE_SCAN_SHAPES (`_wide_scan_bwds`)."""
    from ddg_tpu_torch.ops import mamba as M
    for dtype in (torch.float32, torch.bfloat16):
        for label, H, d, N, R, K in WIDE_SHAPES:
            w = _mamba_weights(gen, dtype, H=H, d=d, R=R, N=N, K=K)
            h = _rand(gen, WIDE_B, WIDE_L, H, dtype=dtype)
            kw = dict(d_state=N, dt_rank=R, chunk=128, compute_dtype=dtype)
            _, h0s = M.mamba_inner(h, **w, **kw, return_h0s=True)
            a19 = (h, *w.values(), h0s, _rand(gen, WIDE_B, WIDE_L, H,
                                                dtype=dtype))
            rec = results['mamba_inner_bwd'][str(dtype)]
            _bwd_case(rec, f'mamba_inner_bwd {label}', dtype, K19_OUT,
                      lambda: M.mamba_inner_bwd(*a19, **kw),
                      lambda: M.mamba_inner_bwd_plain(*a19, **kw), rel=True)
            if K == 4:
                _wide_scan_bwds(results, gen, dtype, label, d, N, R)
        for label, d, N, R in WIDE_SCAN_SHAPES:
            _wide_scan_bwds(results, gen, dtype, label, d, N, R)


# ---------------------------------------------------------------------------
# Phases 4 and 5: the model
# ---------------------------------------------------------------------------

def check_tiny_dit(route='fused_rope'):
    """A tiny float32 DiT with the fused flags on the card against the same
    weights on the CPU (where the plain versions run): the BASELINE 1e-3
    logit bar. `route` 'fused_rope' runs K1 at L=32; 'flash' runs the
    library flash attention's K20 at L=256 (two key blocks), which must
    launch on the card."""
    import numpy as np
    from ddg_tpu_torch.convert import make_reference_dit_state_dict
    from ddg_tpu_torch.models import DIT, DITConfig
    from ddg_tpu_torch.ops import flash_attention as FA
    flash = route == 'flash'
    Lt = 256 if flash else 32
    cfg = DITConfig(hidden_size=128, cond_dim=32, length=Lt, n_blocks=2,
                    n_heads=2, vocab_size=101, num_classes=2,
                    compute_dtype=torch.float32, fused_rope_attn=not flash,
                    tpu_flash_attn=flash, fused_adaln=True)
    sd = make_reference_dit_state_dict(
        np.random.RandomState(1), hidden=128, cond_dim=32, n_blocks=2,
        vocab=101, with_cond=True)
    # Larger weights than the 0.02 default, so that the logits vary.
    sd = {k: v * 10 if v.ndim == 2 else v for k, v in sd.items()}
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(0, 101, (4, Lt), generator=gen, dtype=torch.int32)
    sigma = torch.rand((4,), generator=gen)
    cond = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    outs = []
    before = FA.flash_attention_fwd.launches
    for dev in ('cpu', DEV):
        m = DIT(cfg)
        m.load_state_dict(sd, strict=True)
        m = m.to(dev).eval()
        with torch.no_grad():
            outs.append(m(x.to(dev), sigma.to(dev), cond.to(dev)).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    launched = FA.flash_attention_fwd.launches - before
    check(bool(torch.isfinite(outs[1]).all()),
          f'tiny DiT {route}: non-finite logits')
    check(err < 1e-3, f'tiny DiT {route}: card vs CPU logits differ by {err}')
    check(launched == (2 if flash else 0),
          f'tiny DiT {route}: K20 launched {launched} times')
    emit({'phase': 'tiny_dit_card_vs_cpu', 'route': route, 'length': Lt,
          'max_abs_err': err, 'logit_std': outs[0].std().item()})


def _tiny_int8_dit(quant_int8=True):
    """check_tiny_dit's model (fp32, fused flags on, weights x10), with
    `quant_int8`."""
    import numpy as np
    from ddg_tpu_torch.convert import make_reference_dit_state_dict
    from ddg_tpu_torch.models import DITConfig
    cfg = DITConfig(hidden_size=128, cond_dim=32, length=32, n_blocks=2,
                    n_heads=2, vocab_size=101, num_classes=2,
                    compute_dtype=torch.float32, fused_rope_attn=True,
                    fused_adaln=True, quant_int8=quant_int8)
    sd = make_reference_dit_state_dict(
        np.random.RandomState(1), hidden=128, cond_dim=32, n_blocks=2,
        vocab=101, with_cond=True)
    sd = {k: v * 10 if v.ndim == 2 else v for k, v in sd.items()}
    return cfg, sd


def check_tiny_dit_int8():
    """The tiny DiT under `quant_int8`, card against CPU. Each int8 layer
    (the 4 x 2 trunk products and the head), fed on the CPU the input it
    got on the card, must give the card's output bit for bit (an exact s32
    product, then the same fp32 roundings). End to end, an activation
    within fp32 noise of a rounding tie quantizes to the next code on one
    side (tests/test_torch_quant.py finds the same against JAX), and the
    flip moves what follows, so the logits are held to check_tiny_dit's
    1e-3 bar on token rows whose head codes agree and, on a row where n
    head codes differ, to 1e-3 plus n steps of the head, n x x_scale x max
    |W|. Then the unguided `_ddpm_step` with `fused_head` at B=2, K11 (the
    fp32 head) and K12, against the unfused chain (`dit_head_matmul`, then
    K7) under one external Gumbel: tokens equal wherever the top-two gap
    exceeds MARGIN."""
    from ddg_tpu_torch.models import DIT
    from ddg_tpu_torch.models.dit import dit_head_features
    from ddg_tpu_torch.ops import quant
    cfg, sd = _tiny_int8_dit()
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(0, 101, (4, 32), generator=gen, dtype=torch.int32)
    sigma = torch.rand((4,), generator=gen)
    cond = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    outs, layers = {}, {}
    for dev in ('cpu', DEV):
        m = DIT(cfg)
        m.load_state_dict(sd, strict=True)
        m = m.to(dev).eval()
        params = dict(m.named_parameters())
        args = (x.to(dev), sigma.to(dev), cond.to(dev))
        seen = []
        hooks = [mod.register_forward_hook(
            lambda mod, inp, out: seen.append((mod, inp[0], out)))
            for mod in m.modules() if isinstance(mod, quant.QLinear)]
        with torch.no_grad():
            logits = m(*args)
        for hk in hooks:
            hk.remove()
        layers[dev] = seen
        with torch.no_grad():
            h, c = m(*args, skip_head=True)
            feats = dit_head_features(cfg, params, h, c)
        outs[dev] = (logits.cpu(), quant.quantize_rowwise(feats.cpu()),
                     h.cpu())
    check(len(layers[DEV]) == 2 * 4 + 1, 'tiny int8 DiT: expected 9 int8 '
                                         f'layers, ran {len(layers[DEV])}')
    with torch.no_grad():
        for n, ((mod, _, _), (_, inp, out)) in enumerate(
                zip(layers['cpu'], layers[DEV])):
            want = mod(inp.cpu())
            check(torch.equal(want, out.cpu()),
                  f'tiny int8 DiT: int8 layer {n} on the card differs from '
                  'the CPU on the same input by '
                  f'{(want - out.cpu()).abs().max().item()}')
    (l_cpu, (q_cpu, s_cpu), h_cpu), (l_dev, (q_dev, _), h_dev) = (
        outs['cpu'], outs[DEV])
    flips = (q_cpu != q_dev).sum(-1, keepdim=True)
    w_max = sd['output_layer.linear.weight'].abs().max().item()
    bar = 1e-3 + flips * s_cpu * w_max
    err = (l_cpu - l_dev).abs()
    check(bool(torch.isfinite(l_dev).all()), 'tiny int8 DiT: non-finite')
    check(bool((err <= bar).all()),
          f'tiny int8 DiT: card vs CPU logits differ by {err.max().item()} '
          f'(flipped head codes: {int(flips.sum().item())})')
    rec = {'phase': 'tiny_dit_int8_card_vs_cpu',
           'int8_layers_bit_equal_on_same_input': len(layers[DEV]),
           'max_abs_err': err.max().item(),
           'max_abs_err_unflipped_rows': err[(flips == 0).expand_as(err)]
           .max().item(),
           'flipped_head_codes': int(flips.sum().item()),
           'hidden_max_abs_err': (h_cpu - h_dev).abs().max().item(),
           'logit_std': l_cpu.std().item()}
    rec['fused_head_step'] = {
        name: _head_step_vs_chain(name, quant_int8)
        for name, quant_int8 in (('fused_absorbing_head_sample', False),
                                 ('fused_absorbing_head_sample_int8', True))}
    emit(rec)


def _head_step_vs_chain(name, quant_int8):
    """One unguided `_ddpm_step` with `fused_head` on the tiny fp32 DiT at
    B=2 (K11 in fp32, or K12), its kernel handed an external Gumbel,
    against `dit_head_matmul` (fp32 logits) then K7 on the same noise."""
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.diffusion import DiffusionSpec, process_sigma
    from ddg_tpu_torch.models import DIT, make_model_apply
    from ddg_tpu_torch.models.dit import dit_head_features, dit_head_matmul
    from ddg_tpu_torch.ops import fused_sampling as fs
    from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise
    cfg, sd = _tiny_int8_dit(quant_int8)
    Vt, mask, Bt, Lt = cfg.vocab_size, cfg.vocab_size - 1, 2, cfg.length
    m = DIT(cfg)
    m.load_state_dict(sd, strict=True)
    apply = make_model_apply(m.to(DEV).eval())
    params = apply.params
    spec = DiffusionSpec(diffusion='absorbing_state',
                         parameterization='subs', noise=LogLinearNoise(),
                         vocab_size=Vt, mask_index=mask, num_classes=2)
    gen = torch.Generator(device=DEV).manual_seed(4)
    x0 = torch.randint(0, mask, (Bt, Lt), generator=gen, device=DEV,
                       dtype=torch.int32)
    xt = torch.where(torch.rand((Bt, Lt), generator=gen, device=DEV) < 0.8,
                     torch.full_like(x0, mask), x0)
    sigma = torch.full((Bt,), 0.7, device=DEV)
    mct = torch.full((Bt, 1, 1), 0.6, device=DEV)
    mcs = torch.full((Bt, 1, 1), 0.3, device=DEV)
    head = SM._prepare_head(cfg, params)
    g = -torch.log(-torch.log(torch.rand(
        (Bt, head[0].shape[0], Lt), generator=gen, device=DEV)
        .clamp_min(1e-20)))
    kernel = getattr(SM, name)
    setattr(SM, name, lambda *a, **kw: kernel(*a, gumbel_t=g, **kw))
    try:
        xs, _ = SM._ddpm_step(
            spec, SM.SamplerSpec(fused=True, fused_head=True,
                                 use_cache=False),
            apply, params, gen, xt, sigma, mct, mcs, None, None,
            dit_cfg=cfg, head=head)
    finally:
        setattr(SM, name, kernel)
    with torch.no_grad():
        h, c = apply(params, xt, process_sigma(spec, sigma), None, None,
                     train=False, rng=None, skip_head=True)
        z = dit_head_matmul(cfg, params,
                            dit_head_features(cfg, params, h, c)).float()
    gl = g.transpose(1, 2)[..., :Vt].contiguous()
    ref = fs.fused_absorbing_sample(0, xt, z, mct[:, 0, 0], mcs[:, 0, 0],
                                    mask_index=mask, gumbel=gl)
    scores = fs.perturbed_scores(0, z, mct[:, 0, 0], mcs[:, 0, 0],
                                 mask_index=mask, gumbel=gl)
    top2 = scores.topk(2, dim=-1).values
    masked = xt == mask
    decided = ((top2[..., 0] - top2[..., 1]) > MARGIN) & masked
    bad = int(((xs != ref) & decided).sum().item())
    check(bad == 0, f'{name} step: {bad} tokens differ from the unfused '
                    f'chain where the margin > {MARGIN}')
    check(torch.equal(xs[~masked], xt[~masked]),
          f'{name} step: decoded tokens not copied over')
    return {'compared_tokens': int(decided.sum().item()),
            'masked_tokens': int(masked.sum().item())}


def check_int8_tv():
    """scripts/validate_quant_tpu.py's test on the card: a DiT of hidden
    256, 4 blocks of 4 heads, L=32, V=203, bf16 trunk and head, its head
    drawn at 0.02 and its bias at 0.05 (the adaLN projections zero, as
    flax initialises them; the rest the reference's seeded draw), B=4. The
    TV between the analytic posteriors (mct 0.8, mcs 0.3) of its bf16 and
    its int8 logits must be below the binomial floor at N=4000 draws a
    position at every position, and 4000 Gumbel draws through the int8
    posterior within twice that floor of the bf16 one."""
    import numpy as np
    from ddg_tpu_torch.convert import make_reference_dit_state_dict
    from ddg_tpu_torch.models import DIT, DITConfig
    Bq, Lq, Vq, n_eval = 4, 32, 203, 4000
    mask = Vq - 1
    r = np.random.RandomState(0)
    sd = make_reference_dit_state_dict(r, hidden=256, cond_dim=64,
                                       n_blocks=4, vocab=Vq, with_cond=True)
    for k in sd:
        if 'adaLN_modulation' in k:
            sd[k] = torch.zeros_like(sd[k])
    sd['output_layer.linear.weight'] = torch.from_numpy(
        0.02 * r.randn(Vq, 256).astype(np.float32))
    sd['output_layer.linear.bias'] = torch.from_numpy(
        0.05 * r.randn(Vq).astype(np.float32))
    gen = torch.Generator(device=DEV).manual_seed(0)
    x = torch.randint(0, Vq, (Bq, Lq), generator=gen, device=DEV)
    sig = torch.full((Bq,), 0.5, device=DEV)
    cond = torch.zeros((Bq,), dtype=torch.int32, device=DEV)
    logits = {}
    for q8 in (False, True):
        cfg = DITConfig(hidden_size=256, cond_dim=64, length=Lq, n_blocks=4,
                        n_heads=4, dropout=0.0, vocab_size=Vq,
                        num_classes=2, compute_dtype=torch.bfloat16,
                        logits_dtype=torch.bfloat16, quant_int8=q8,
                        fused_rope_attn=True, fused_adaln=True)
        m = DIT(cfg)
        m.load_state_dict(sd, strict=True)
        with torch.no_grad():
            logits[q8] = m.to(DEV).eval()(x, sig, cond).float()

    def posterior(z, mct=0.8, mcs=0.3):
        z = z.clone()
        z[..., mask] = -1e30
        q = torch.softmax(z, -1) * (mct - mcs)
        q[..., mask] = mcs
        return (q / q.sum(-1, keepdim=True)).double()

    q_ref, q_int8 = posterior(logits[False]), posterior(logits[True])
    floor = 0.5 * torch.sqrt(2 * q_ref * (1 - q_ref) / (math.pi * n_eval)
                             ).sum(-1)
    tv = 0.5 * (q_ref - q_int8).abs().sum(-1)
    worst = (tv / floor).max().item()
    logq = torch.log(q_int8.float() + 1e-20)
    g = -torch.log(-torch.log(torch.rand(
        (n_eval, Bq, Lq, Vq), generator=gen, device=DEV).clamp_min(1e-20)))
    draws = (logq[None] + g).argmax(-1)
    emp = torch.nn.functional.one_hot(draws, Vq).double().mean(0)
    ratio_emp = (0.5 * (emp - q_ref).abs().sum(-1) / floor).max().item()
    rel = ((logits[True] - logits[False]).norm()
           / logits[False].norm()).item()
    check(worst < 1.0, f'int8 TV: systematic TV {worst} x the N={n_eval} '
                       'floor')
    check(ratio_emp < 2.0, f'int8 TV: empirical TV {ratio_emp} x the floor')
    emit({'phase': 'int8_tv', 'systematic_tv_max': tv.max().item(),
          'floor_min': floor.min().item(), 'floor_max': floor.max().item(),
          'worst_ratio_to_floor': worst, 'empirical_ratio': ratio_emp,
          'logit_rel_l2': rel, 'draws': n_eval})


def _loss_grads(build, weights, dev, spec, batch):
    """The float32 loss of `build()` loaded with `weights` on `dev`, on one
    batch and one injected (t, x_t) (`batch` = (x0, t, xt, cond)), and the
    gradient of every parameter of `weights`, on the CPU."""
    from ddg_tpu_torch.diffusion import diffusion_loss_given
    from ddg_tpu_torch.models import make_model_apply
    x0, t, xt, cond = batch
    m = build()
    m.load_state_dict(weights, strict=True)
    apply = make_model_apply(m.to(dev))
    nll = diffusion_loss_given(
        spec, apply, apply.params, x0.to(dev), t.to(dev), xt.to(dev),
        None if cond is None else cond.to(dev), torch.Generator(device=dev),
        train=True, label_smoothing=0.0)['loss']
    loss = nll.mean()
    grads = torch.autograd.grad(loss, [apply.params[k] for k in weights])
    return loss.item(), [g.cpu() for g in grads]


def _train_step_card_vs_cpu(name, build, sd, spec, batch, optim, avg,
                            grad_bars=None, zero_grads=None, loss_rtol=1e-5):
    """One float32 train step of `build()` loaded with `sd`, on one batch
    and one injected (t, x_t) (`batch` = (x0, t, xt, cond), cond None for
    a model without classes), card against CPU. Bars, set before the first
    run: the loss to 1e-5 relative (or to `loss_rtol`); every parameter
    gradient to 1e-4 of its
    largest magnitude on the CPU (sums in another order, and the
    embedding's scatter-add in no fixed order on the card), or to the bar
    `grad_bars` gives it; a gradient that is exactly zero but for rounding
    (`zero_grads`: {name: the parameter whose gradient scales it}) to 1e-4
    of that parameter's largest gradient on both sides; and, fed the CPU's
    gradients, the parameters and the EMA shadow after one clip + AdamW +
    EMA update to 1e-6. Returns the errors."""
    from ddg_tpu_torch.runtime import averaging
    from ddg_tpu_torch.runtime.optim import make_optimizer
    names = list(sd)
    grad_bars, zero_grads = grad_bars or {}, zero_grads or {}
    res = {dev: _loss_grads(build, sd, dev, spec, batch)
           for dev in ('cpu', DEV)}
    (l_cpu, g_cpu), (l_dev, g_dev) = res['cpu'], res[DEV]
    loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
    check(math.isfinite(l_dev) and loss_err <= loss_rtol,
          f'{name}: card loss {l_dev} vs CPU {l_cpu}')
    errs = {}
    for k, a, b in zip(names, g_cpu, g_dev):
        if k in zero_grads:
            ref = g_cpu[names.index(zero_grads[k])].abs().max().item()
            check(max(a.abs().max().item(), b.abs().max().item())
                  <= 1e-4 * ref, f'{name}: the zero gradient of {k} is not '
                                 'rounding noise')
            continue
        scale = max(a.abs().max().item(), 1e-30)
        errs[k] = ((a - b).abs().max().item() / scale, grad_bars.get(k, 1e-4))
    over = sorted(errs.items(), key=lambda kv: -kv[1][0] / kv[1][1])
    check(over[0][1][0] <= over[0][1][1],
          f'{name}: gradients past their bars (error, bar of the largest '
          f'magnitude): {[(k, e) for k, e in over[:8] if e[0] > e[1]]}')
    grad_err = max(e for e, _ in errs.values())
    worst = over[0][1][0] / over[0][1][1]
    after = {}
    for dev in ('cpu', DEV):
        masters = {k: sd[k].to(dev, copy=True) for k in names}
        ema = averaging.init(avg, masters)
        make_optimizer(optim, list(masters.values())).step(
            [g.to(dev) for g in g_cpu])
        averaging.update(avg, ema, masters)
        after[dev] = [v.cpu() for v in (*masters.values(),
                                        *ema.shadow_params.values())]
    step_err = max((a - b).abs().max().item()
                   for a, b in zip(after['cpu'], after[DEV]))
    check(step_err <= 1e-6, f'{name}: parameters after the update differ '
                            f'by {step_err}')
    return {'loss': l_cpu, 'loss_rel_err': loss_err,
            'max_grad_err_of_max': grad_err, 'max_grad_err_over_bar': worst,
            'update_max_abs_err': step_err}


def check_tiny_train():
    """A tiny float32 DiT train step, fused flags on, dropout 0, card
    against CPU (`_train_step_card_vs_cpu`)."""
    import numpy as np
    from ddg_tpu_torch.convert import make_reference_dit_state_dict
    from ddg_tpu_torch.diffusion import DiffusionSpec, sample_corruption
    from ddg_tpu_torch.models import DIT, DITConfig
    from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise
    from ddg_tpu_torch.runtime import averaging
    from ddg_tpu_torch.runtime.optim import OptimSpec
    cfg = DITConfig(hidden_size=128, cond_dim=32, length=32, n_blocks=2,
                    n_heads=2, vocab_size=101, num_classes=2, dropout=0.0,
                    compute_dtype=torch.float32, fused_rope_attn=True,
                    fused_adaln=True)
    sd = make_reference_dit_state_dict(
        np.random.RandomState(1), hidden=128, cond_dim=32, n_blocks=2,
        vocab=101, with_cond=True)
    sd = {k: v * 10 if v.ndim == 2 else v for k, v in sd.items()}
    spec = DiffusionSpec(diffusion='absorbing_state',
                         parameterization='subs', noise=LogLinearNoise(),
                         vocab_size=101, mask_index=100, num_classes=2)
    gen = torch.Generator().manual_seed(3)
    x0 = torch.randint(0, 100, (8, 32), generator=gen, dtype=torch.int32)
    cond = torch.tensor([0, 1] * 4, dtype=torch.int32)
    t, xt = sample_corruption(spec, x0, gen)
    rec = _train_step_card_vs_cpu(
        'tiny train', lambda: DIT(cfg), sd, spec, (x0, t, xt, cond),
        OptimSpec(lr=1e-3, weight_decay=0.01, num_warmup_steps=0),
        averaging.AveragingSpec.ema(0.9))
    emit({'phase': 'tiny_train_card_vs_cpu', **rec})


def _launch_check(name, kernels, launches, per_step, steps):
    """Each kernel launched exactly per_step[k] (0 if absent) x steps
    times."""
    for k in kernels:
        want = per_step.get(k, 0) * steps
        check(launches[k] == want, f'{name}: {k} launched {launches[k]} '
                                   f'times, expected {want}')


def _sync_check(name, run, expect=0):
    """Host syncs of `run` under PyTorch's sync debug mode; must be
    `expect` (none, unless the loop is known to sync)."""
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = [str(w.message) for w in syncs
             if 'called a synchronizing' in str(w.message)]
    check(len(syncs) == expect,
          f'{name}: the loop synchronises with the card {len(syncs)} times, '
          f'expected {expect}: {syncs[:3]}')
    return len(syncs)


def run_main_path(kernels):
    """The LM1B D-CFG serving path (gamma 2) at full width: ancestral
    feature-mix at T=1000, B=24 (the JAX bench's line, `bench.py:170-176`
    with its default --steps), the NFE cache (the CFG kernel) at T=128,
    B=24, and first-hitting at B=32; then the head-fused and int8 runs of
    the JAX bench's lines (`bench.py:154, 184, 212, 849-866`): feature-mix
    with `fused_head` (1 K11 a step, no K7), the same on the int8 flagship
    (1 K12 a step), the int8 flagship without the fused head (the default
    suite's `ancestral_int8`: the int8 head through `torch._int_mm`, then 1
    K7 a step) and first-hitting on it (`first_hitting_int8`). Each is
    timed alone, with its peak memory; the new runs also hold K1, K3 and K5
    to exactly 12 a forward. Then short runs at B=2, untimed, under
    PyTorch's sync debug mode: feature-mix (2 steps), the head-fused runs
    (2 steps each) and both first-hitting runs must not wait for the card;
    the NFE cache (8 steps) waits once a step, for the validity flag of its
    cache (`samplers.py`'s `torch.equal`; `ddg_tpu` keeps that flag in its
    scan carry)."""
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import flagship
    models = {}
    for key, int8 in (('bf16', False), ('int8', True)):
        t0 = time.perf_counter()
        spec, cfg, _, apply_fn, params = flagship(device=DEV, int8=int8)
        models[key] = (spec, cfg, apply_fn, params)
        emit({'phase': 'flagship', 'int8': int8,
              'seconds': time.perf_counter() - t0,
              'parameters': sum(p.numel() for p in params.values()),
              'hidden': cfg.hidden_size, 'blocks': cfg.n_blocks,
              'heads': cfg.n_heads, 'length': cfg.length,
              'vocab': cfg.vocab_size})
    guidance = SM.GuidanceSpec(method='cfg', gamma=GAMMA)
    jax_line = 'LM1B D-CFG samples/sec/chip ({}, B={}, DiT-small{})'
    trunk = {'fused_rope_attention': 12, 'ln_modulate': 12,
             'gate_res_ln_modulate': 12}
    fh = dict(use_cache=False, fused=True, fused_head=True)
    # (run, model, batch, sampler, kernels that must run, exact launches a
    # step or None, JAX line)
    runs = [
        ('ancestral_feature_mix', 'bf16', 24,
         SM.SamplerSpec(steps=1000, use_cache=False, fused=True),
         {'fused_absorbing_sample'}, None,
         jax_line.format('T=1000', 24, '')),
        ('ancestral_nfe_cache', 'bf16', 24,
         SM.SamplerSpec(steps=128, use_cache=True, fused=True),
         {'fused_absorbing_cfg_sample'}, None,
         'none: the JAX line with --cache runs T=1000; this run T=128'),
        ('first_hitting', 'bf16', 32, SM.SamplerSpec(first_hitting=True),
         set(), None,
         jax_line.format('first-hitting ~ T=inf exact', 32, '')),
        ('ancestral_feature_mix_fused_head', 'bf16', 24,
         SM.SamplerSpec(steps=1000, **fh), set(),
         {**trunk, 'fused_absorbing_head_sample': 1},
         jax_line.format('T=1000', 24, ', fused-head')),
        ('ancestral_feature_mix_int8_fused_head', 'int8', 24,
         SM.SamplerSpec(steps=1000, **fh), set(),
         {**trunk, 'fused_absorbing_head_sample_int8': 1},
         jax_line.format('T=1000', 24, ', int8, fused-head')),
        ('ancestral_int8', 'int8', 24,
         SM.SamplerSpec(steps=1000, use_cache=False, fused=True), set(),
         {**trunk, 'fused_absorbing_sample': 1},
         jax_line.format('T=1000', 24, ', int8')),
        ('first_hitting_int8', 'int8', 32,
         SM.SamplerSpec(first_hitting=True), set(), trunk,
         jax_line.format('first-hitting ~ T=inf exact', 32, ', int8')),
    ]
    # (run, model, sampler, host syncs expected) for the sync count.
    sync_runs = [
        ('ancestral_feature_mix', 'bf16',
         SM.SamplerSpec(steps=2, use_cache=False, fused=True), 0),
        ('ancestral_nfe_cache', 'bf16',
         SM.SamplerSpec(steps=8, use_cache=True, fused=True), 8),
        ('first_hitting', 'bf16', SM.SamplerSpec(first_hitting=True), 0),
        ('ancestral_feature_mix_fused_head', 'bf16',
         SM.SamplerSpec(steps=2, **fh), 0),
        ('ancestral_feature_mix_int8_fused_head', 'int8',
         SM.SamplerSpec(steps=2, **fh), 0),
        ('first_hitting_int8', 'int8', SM.SamplerSpec(first_hitting=True),
         0),
    ]

    def sample(model, batch, sampler, seed):
        spec, cfg, apply_fn, params = models[model]
        gen = torch.Generator(device=DEV).manual_seed(seed)
        cond = torch.zeros((batch,), dtype=torch.int32, device=DEV)
        return SM.diffusion_sample(spec, sampler, apply_fn, params, gen,
                                   batch_size=batch, length=cfg.length,
                                   guidance=guidance, cond=cond,
                                   dit_cfg=cfg)

    # Warm-up: the trunk's and head's GEMM shapes, outside the counts.
    for model, sampler in (
            ('bf16', SM.SamplerSpec(steps=2, use_cache=False, fused=True)),
            ('bf16', SM.SamplerSpec(steps=2, **fh)),
            ('int8', SM.SamplerSpec(steps=2, **fh)),
            ('int8', SM.SamplerSpec(steps=2, use_cache=False, fused=True))):
        sample(model, 24, sampler, 99)
    torch.cuda.synchronize()
    totals = {name: 0 for name in kernels}
    for i, (name, model, batch, sampler, expect, per_step,
            line) in enumerate(runs):
        cfg = models[model][1]
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x = sample(model, batch, sampler, i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        for k in kernels:
            totals[k] += launches[k]
        n_tok = x.numel()
        n_mask = int((x == MASK).sum().item())
        allowed = math.ceil(5 * n_tok / 8192)
        steps = None if sampler.first_hitting else sampler.steps
        emit({'phase': 'main_path', 'run': name, 'int8': cfg.quant_int8,
              'fused_head': sampler.fused_head, 'batch': batch,
              'steps': steps, 'jax_line': line,
              'seconds': secs, 'samples_per_s': batch / secs,
              'ms_per_step': secs / (steps or cfg.length) * 1e3,
              'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
              'launches': launches, 'mask_tokens_left': n_mask,
              'distinct_tokens': int(torch.unique(x).numel())})
        check(tuple(x.shape) == (batch, cfg.length) and x.dtype == torch.int32,
              f'{name}: output {tuple(x.shape)} {x.dtype}')
        check(bool(((x >= 0) & (x < cfg.vocab_size)).all()),
              f'{name}: token outside [0, V)')
        check(n_mask <= allowed, f'{name}: {n_mask} mask tokens left '
                                 f'(> {allowed})')
        for k in set(trunk) | expect:
            check(launches[k] > 0, f'{name}: kernel {k} never launched')
        if per_step is not None:
            _launch_check(name, kernels, launches, per_step,
                          steps or cfg.length)
        for k in BACKWARD:
            check(launches[k] == 0, f'{name}: backward kernel {k} launched '
                                    'while sampling')
    for name, model, sampler, expect in sync_runs:
        n_syncs = _sync_check(name, lambda: sample(model, 2, sampler, 7),
                              expect)
        emit({'phase': 'main_path_host_syncs', 'run': name, 'batch': 2,
              'steps': None if sampler.first_hitting else sampler.steps,
              'host_syncs': n_syncs, 'expected': expect})
    return totals


BACKWARD = ('fused_rope_attention_bwd', 'ln_modulate_bwd',
            'gate_res_ln_modulate_bwd', 'mamba_inner_bwd', 'ssm_scan_bwd',
            'short_seq_attention_bwd')
# Launches per micro-step of the training path: 12 blocks, and the final
# norm's ln_modulate.
PER_MICRO_STEP = {'fused_rope_attention': 12, 'fused_rope_attention_bwd': 12,
                  'ln_modulate': 13, 'ln_modulate_bwd': 13,
                  'gate_res_ln_modulate': 12, 'gate_res_ln_modulate_bwd': 12,
                  'fused_absorbing_sample': 0,
                  'fused_absorbing_cfg_sample': 0, 'fused_uniform_sample': 0,
                  'fused_uniform_cfg_sample': 0, 'fused_group_norm_act': 0,
                  'mamba_inner': 0, 'ssm_scan': 0, 'mamba_inner_bwd': 0,
                  'ssm_scan_bwd': 0, 'short_seq_attention': 0,
                  'short_seq_attention_bwd': 0,
                  **{name: 0 for name in FLASH}}
# The text8 run's routes: K1 and K1b, K2 and its backward, or K20 with K21
# and K22, 12 a micro-step each; the adaLN kernels as in LM1B training.
TEXT8_PER_MICRO_STEP = {
    'fused_rope': PER_MICRO_STEP,
    'short_seq': dict(PER_MICRO_STEP, fused_rope_attention=0,
                      fused_rope_attention_bwd=0, short_seq_attention=12,
                      short_seq_attention_bwd=12),
    'flash': dict(PER_MICRO_STEP, fused_rope_attention=0,
                  fused_rope_attention_bwd=0,
                  **{name: 12 for name in FLASH})}


def run_train_path(kernels, warmup=2, steps=5):
    """The training flagship at full width: `warmup` steps, then `steps`
    timed ones."""
    from ddg_tpu_torch.entry import train_flagship
    t0 = time.perf_counter()
    run = train_flagship(device=DEV)
    cfg = run.cfg
    emit({'phase': 'train_flagship', 'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in run.apply_fn.params.values()),
          'hidden': cfg.hidden_size, 'blocks': cfg.n_blocks,
          'heads': cfg.n_heads, 'length': cfg.length,
          'vocab': cfg.vocab_size, 'global_batch': run.global_batch,
          'micro_batch': run.micro_batch, 'accum_steps': run.accum_steps})
    batch = run.batch(torch.Generator(device=DEV).manual_seed(1))
    for _ in range(warmup):
        run.step(run.state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = [run.step(run.state, batch)[1] for _ in range(steps)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_micro = steps * run.accum_steps
    _launch_check('training', kernels, launches, PER_MICRO_STEP, n_micro)
    # One more step with PyTorch's sync debugging on: the step must not
    # wait for the card anywhere (its metrics stay on the card).
    n_syncs = _sync_check('training', lambda: run.step(run.state, batch))
    loss = [m['loss'].item() for m in metrics]
    gnorm = [m['grad_norm'].item() for m in metrics]
    emit({'phase': 'train_main_path', 'steps': steps,
          'ms_per_step': secs * 1e3,
          'tokens_per_s': run.global_batch * cfg.length / secs,
          'peak_memory_bytes': peak,
          'loss': loss, 'grad_norm': gnorm,
          'lr': metrics[-1]['lr'].item(),
          'launches_per_micro_step': {k: v / n_micro
                                      for k, v in launches.items()},
          'host_syncs_in_a_step': n_syncs})
    check(all(math.isfinite(v) for v in loss + gnorm),
          'training: non-finite loss or grad norm')
    return launches


def check_learning(micro_steps=30):
    """At full width, one micro-batch of Zipf-distributed tokens repeated,
    lr 3e-4 with no warmup: the mean loss of the last 5 steps at least
    10% below the first 5 (a bar set before the first run)."""
    import dataclasses
    from ddg_tpu_torch.entry import train_flagship
    from ddg_tpu_torch.runtime.train_state import (init_train_state,
                                                   make_train_step)
    run = train_flagship(device=DEV, seed=2)
    optim = dataclasses.replace(run.optim, num_warmup_steps=0)
    state = init_train_state(torch.Generator(device=DEV).manual_seed(3),
                             run.apply_fn.params, optim, run.averaging)
    step = make_train_step(run.spec, run.apply_fn, optim, run.averaging)
    gen = torch.Generator(device=DEV).manual_seed(4)
    zipf = 1.0 / torch.arange(1, run.cfg.vocab_size, device=DEV) ** 1.1
    ids = torch.multinomial(zipf, run.micro_batch * run.cfg.length,
                            replacement=True, generator=gen)
    shape = (run.micro_batch, run.cfg.length)
    batch = {'input_ids': ids.view(shape).int(),
             'attention_mask': torch.ones(shape, device=DEV)}
    t0 = time.perf_counter()
    losses = torch.stack([step(state, batch)[1]['loss']
                          for _ in range(micro_steps)]).tolist()
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    emit({'phase': 'learning_check', 'steps': micro_steps,
          'seconds': time.perf_counter() - t0, 'loss_first5': first,
          'loss_last5': last, 'drop': 1 - last / first, 'losses': losses})
    check(all(math.isfinite(v) for v in losses), 'learning: non-finite loss')
    check(last <= 0.9 * first, f'learning: loss fell from {first} to '
                               f'{last}, less than 10%')


# ---------------------------------------------------------------------------
# The text8 training path: DiT-small MDLM at L=256, on three attention routes
# ---------------------------------------------------------------------------

def _half_ulp_bars(build, sd, spec, batch, seed):
    """Each gradient's bar for a card-against-CPU step: twice how far it
    moves on the CPU, in units of its largest magnitude, when every weight
    matrix is perturbed by half an fp32 ulp (2^-24 relative, seeded), at
    least 1e-4 and capped at 3e-4 so that a wrong kernel still fails.
    Returns (bars, the largest such move)."""
    noise = torch.Generator().manual_seed(seed)
    half_ulp = {k: v * (1 + torch.randn(v.shape, generator=noise) * 2.0 ** -24)
                if v.ndim == 2 else v for k, v in sd.items()}
    _, g_cpu = _loss_grads(build, sd, 'cpu', spec, batch)
    _, g_half = _loss_grads(build, half_ulp, 'cpu', spec, batch)
    spread = {k: ((a - b).abs().max()
                  / a.abs().max().clamp_min(1e-30)).item()
              for k, a, b in zip(sd, g_cpu, g_half)}
    return ({k: max(1e-4, min(3e-4, 2 * v)) for k, v in spread.items()},
            max(spread.values()))


def check_tiny_text8_train():
    """A tiny float32 DiT at text8's L=256 and V=35 (hidden 128, 2 heads of
    64, 2 blocks, dropout 0) with the text8 run's optimizer and EMA, card
    against CPU (`_train_step_card_vs_cpu`), on each attention route: K1
    and K1b, RoPE then K2 and its backward, and RoPE then K20 with K21 and
    K22 (the plain versions on the CPU). At L=256 with the x10 weights a
    gradient can move by ~1e-4 of its largest magnitude under another
    summation order alone, so each gradient's bar is twice its fp32
    sensitivity where that exceeds 1e-4,
    capped at 3e-4 so that a wrong kernel still fails: how far it moves on
    the CPU, in units of its largest magnitude, when every weight matrix
    is perturbed by half an fp32 ulp (2^-24 relative, seeded), which is
    all that another summation order can do to an input."""
    import dataclasses
    import numpy as np
    from ddg_tpu_torch.convert import make_reference_dit_state_dict
    from ddg_tpu_torch.diffusion import sample_corruption
    from ddg_tpu_torch.entry import (TEXT8_ROUTES, text8_train_flagship,
                                     text8_train_setup)
    from ddg_tpu_torch.models import DIT
    run = text8_train_flagship(device='cpu', tiny=True)
    sd = make_reference_dit_state_dict(
        np.random.RandomState(1), hidden=128, cond_dim=32, n_blocks=2,
        vocab=run.cfg.vocab_size)
    sd = {k: v * 10 if v.ndim == 2 else v for k, v in sd.items()}
    gen = torch.Generator().manual_seed(3)
    x0 = run.batch(gen)['input_ids'][0]
    t, xt = sample_corruption(run.spec, x0, gen)
    optim = dataclasses.replace(run.optim, num_warmup_steps=0)
    batch = (x0, t, xt, None)
    rec = {}
    for route in TEXT8_ROUTES:
        cfg = dataclasses.replace(
            text8_train_setup(tiny=True, route=route).cfg, hidden_size=128,
            compute_dtype=torch.float32, dropout=0.0)
        build = lambda: DIT(cfg)          # noqa: E731
        bars, spread = _half_ulp_bars(build, sd, run.spec, batch, 11)
        rec[route] = _train_step_card_vs_cpu(
            f'tiny text8 train {route}', build, sd, run.spec, batch, optim,
            run.averaging, grad_bars=bars)
        rec[route]['max_half_ulp_spread_of_max'] = spread
    emit({'phase': 'tiny_text8_train_card_vs_cpu', 'length': run.cfg.length,
          **rec})


def check_wide_head_dit_train():
    """ROADMAP C.7: a tiny float32 DiT whose heads are 192 wide (hidden 384,
    2 heads, 2 blocks, text8's L=256 and V=35, dropout 0) trains on the card
    through K1 and K1b ('fused_rope') and through RoPE, K2 and K2b
    ('short_seq'): one step card against CPU (`_train_step_card_vs_cpu`,
    with `check_tiny_text8_train`'s half-ulp bars), each backward launched
    on the CUDA cores (16-row query tiles, 32-key tiles) 2 times. The
    weight matrices are scaled x3: at this width x10 (the text8 check's,
    at hidden 128) puts the model where half an fp32 ulp on the weights
    moves the embedding's gradient by 1.5e-3 of its largest magnitude on
    the CPU, past the 3e-4 cap, so no bar could tell a wrong kernel from
    another summation order; at x3 that spread is 7e-7."""
    import dataclasses
    import numpy as np
    from ddg_tpu_torch.convert import make_reference_dit_state_dict
    from ddg_tpu_torch.diffusion import sample_corruption
    from ddg_tpu_torch.entry import text8_train_flagship, text8_train_setup
    from ddg_tpu_torch.models import DIT
    from ddg_tpu_torch.ops import attention as A
    run = text8_train_flagship(device='cpu', tiny=True)
    sd = make_reference_dit_state_dict(
        np.random.RandomState(2), hidden=384, cond_dim=32, n_blocks=2,
        vocab=run.cfg.vocab_size)
    sd = {k: v * 3 if v.ndim == 2 else v for k, v in sd.items()}
    gen = torch.Generator().manual_seed(4)
    x0 = run.batch(gen)['input_ids'][0]
    t, xt = sample_corruption(run.spec, x0, gen)
    optim = dataclasses.replace(run.optim, num_warmup_steps=0)
    batch = (x0, t, xt, None)
    rec = {}
    for route, bwd in (('fused_rope', A.fused_rope_attention_bwd),
                       ('short_seq', A.short_seq_attention_bwd)):
        cfg = dataclasses.replace(
            text8_train_setup(tiny=True, route=route).cfg, hidden_size=384,
            n_heads=2, compute_dtype=torch.float32, dropout=0.0)
        build = lambda: DIT(cfg)          # noqa: E731
        bars, spread = _half_ulp_bars(build, sd, run.spec, batch, 12)
        before = (bwd.launches, bwd.tensor_core_launches)
        rec[route] = _train_step_card_vs_cpu(
            f'head dim 192 DiT train {route}', build, sd, run.spec, batch,
            optim, run.averaging, grad_bars=bars)
        n = bwd.launches - before[0]
        check(n == cfg.n_blocks and bwd.tensor_core_launches == before[1],
              f'head dim 192 {route}: {n} backward launches, '
              f'{bwd.tensor_core_launches - before[1]} on the tensor cores')
        rec[route]['backward_launches'] = n
        rec[route]['max_half_ulp_spread_of_max'] = spread
        rec[route]['plan'] = A.backward_plan(
            x0.shape[0], cfg.length, cfg.n_heads, 192, torch.float32)['q']
    emit({'phase': 'head_dim_192_dit_train_card_vs_cpu', **rec})


def run_text8_train_path(kernels, route, warmup=2, steps=3):
    """The text8 training run at full width and depth on one attention
    route: `warmup` steps, then `steps` timed ones (tokens/s, ms/step, peak
    memory, loss, grad norm), exact launches per micro-step
    (TEXT8_PER_MICRO_STEP), 0 host syncs per step and the card's idle share
    over one profiled step. Returns the launches."""
    from ddg_tpu_torch.entry import text8_train_flagship
    from ddg_tpu_torch.ops import flash_attention as FA
    t0 = time.perf_counter()
    run = text8_train_flagship(device=DEV, route=route)
    cfg = run.cfg
    emit({'phase': 'text8_train_flagship', 'route': route,
          'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in run.apply_fn.params.values()),
          'hidden': cfg.hidden_size, 'blocks': cfg.n_blocks,
          'heads': cfg.n_heads, 'length': cfg.length,
          'vocab': cfg.vocab_size, 'global_batch': run.global_batch,
          'micro_batch': run.micro_batch, 'accum_steps': run.accum_steps})
    batch = run.batch(torch.Generator(device=DEV).manual_seed(1))
    for _ in range(warmup):
        run.step(run.state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    flash = {n: getattr(FA, n) for n in FLASH}
    wgmma = {n: w.wgmma_launches for n, w in flash.items()}
    FA.output_grad_dot.calls = 0
    t0 = time.perf_counter()
    metrics = [run.step(run.state, batch)[1] for _ in range(steps)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_micro = steps * run.accum_steps
    _launch_check(f'text8 training {route}', kernels, launches,
                  TEXT8_PER_MICRO_STEP[route], n_micro)
    # K21 forms di on the card: the plain glue never runs; K20, K21 and
    # K22 take wgmma at the DiT's bf16 D = 64.
    check(FA.output_grad_dot.calls == 0, f'text8 training {route}: '
          f'output_grad_dot ran {FA.output_grad_dot.calls} times')
    for n in FLASH:
        check(flash[n].wgmma_launches - wgmma[n] == launches[n],
              f'text8 training {route}: {n} missed the wgmma kernel')
    n_syncs = _sync_check(f'text8 training {route}',
                          lambda: run.step(run.state, batch))
    busy, span, lead = device_busy_ms(lambda: run.step(run.state, batch))
    loss = [m['loss'].item() for m in metrics]
    gnorm = [m['grad_norm'].item() for m in metrics]
    emit({'phase': 'text8_train_main_path', 'route': route, 'steps': steps,
          'ms_per_step': secs * 1e3,
          'tokens_per_s': run.global_batch * cfg.length / secs,
          'peak_memory_bytes': peak, 'loss': loss, 'grad_norm': gnorm,
          'lr': metrics[-1]['lr'].item(),
          'launches_per_micro_step': {k: v / n_micro
                                      for k, v in launches.items() if v},
          'host_syncs_in_a_step': n_syncs,
          'output_grad_dot_calls': FA.output_grad_dot.calls,
          'profiled_busy_ms': busy, 'profiled_span_ms': span,
          'profiled_lead_ms': lead, 'idle_share': 1.0 - busy / span})
    check(all(math.isfinite(v) for v in loss + gnorm),
          f'text8 training {route}: non-finite loss or grad norm')
    return launches


def check_text8_learning(micro_steps=30, rows=64):
    """The attention routes of the text8 run from the same weights and the
    same generator, lr 3e-4 without warmup, `micro_steps` steps on one
    micro-batch of `rows` sequences (a quarter of TEXT8_TRAIN_MICRO_BATCH)
    of Zipf-distributed tokens (exponent 1.1, as `check_learning`). Bars,
    set before the first run: each route's mean loss over the last 5 steps
    at least 10% below that over the first 5; each other route's last-5
    mean closer to 'fused_rope''s than the pooled std of the two routes'
    last-10 losses."""
    import dataclasses
    from ddg_tpu_torch.entry import TEXT8_ROUTES, text8_train_flagship
    from ddg_tpu_torch.models import DIT
    run = text8_train_flagship(device=DEV, seed=2)
    run.optim = dataclasses.replace(run.optim, num_warmup_steps=0)
    gen = torch.Generator(device=DEV).manual_seed(4)
    zipf = 1.0 / torch.arange(1, run.cfg.vocab_size, device=DEV) ** 1.1
    shape = (rows, run.cfg.length)
    ids = torch.multinomial(zipf, rows * run.cfg.length, replacement=True,
                            generator=gen).view(shape).int()
    batch = {'input_ids': ids, 'attention_mask': torch.ones(shape,
                                                            device=DEV)}
    out, t0 = {}, time.perf_counter()
    for route in TEXT8_ROUTES:
        model = DIT(dataclasses.replace(run.cfg, **TEXT8_ROUTES[route]))
        model.load_state_dict(run.model.state_dict(), strict=True)
        state, step = _micro_step_fn(run, model.to(DEV))
        losses = torch.stack([step(state, batch)[1]['loss']
                              for _ in range(micro_steps)]).tolist()
        check(all(math.isfinite(v) for v in losses),
              f'text8 learning {route}: non-finite loss')
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(last <= 0.9 * first, f'text8 learning {route}: loss fell '
                                   f'from {first} to {last}, less than 10%')
        out[route] = {'loss_first5': first, 'loss_last5': last,
                      'drop': 1 - last / first, 'losses': losses}
    gaps = {}
    for route in out:
        if route == 'fused_rope':
            continue
        tails = [out[r]['losses'][-10:] for r in ('fused_rope', route)]
        pooled = math.sqrt(sum(statistics.variance(t) for t in tails) / 2)
        gaps[route] = {'last5_gap': abs(out['fused_rope']['loss_last5']
                                        - out[route]['loss_last5']),
                       'pooled_tail_std': pooled}
    emit({'phase': 'text8_learning_check', 'steps': micro_steps,
          'rows': rows, 'seconds': time.perf_counter() - t0,
          'gaps_to_fused_rope': gaps, **out})
    for route, g in gaps.items():
        check(g['last5_gap'] < g['pooled_tail_std'],
              f'text8 learning: {route} ends {g["last5_gap"]} from '
              f'fused_rope, over the pooled tail std '
              f'{g["pooled_tail_std"]}')


SMALL_L1024_MICRO_BATCH = 16


def run_dit_small_l1024(kernels, steps=2):
    """The reference DiT-small at its own L=1024 (`configs/model/small.yaml`:
    hidden 768, 12 blocks of 12 heads of 64, cond 128; the LM1B flagship's
    vocabulary) trained through `entry._dit_train_setup` on each attention
    route (TEXT8_ROUTES' flags): global batch 2 x SMALL_L1024_MICRO_BATCH
    as two micro-batches, `steps` steps from seeded random weights. The
    losses and grad norms must be finite, the launches exact (the route's
    attention forward and backward 12 times a micro-step, the other
    route's never, the adaLN kernels as in LM1B training) and every
    attention call on the tensor cores. Returns the launches of all the
    routes."""
    from ddg_tpu_torch.entry import (TEXT8_ROUTES, _dit_train_run,
                                     _dit_train_setup)
    from ddg_tpu_torch.models import DITConfig
    from ddg_tpu_torch.ops import attention as A
    from ddg_tpu_torch.ops import flash_attention as FA
    attn = ('fused_rope_attention', 'fused_rope_attention_bwd',
            'short_seq_attention', 'short_seq_attention_bwd')
    total, out = {k: 0 for k in kernels}, {}
    for route, flags in TEXT8_ROUTES.items():
        cfg = DITConfig(hidden_size=768, cond_dim=128, length=1024,
                        n_blocks=12, n_heads=12, vocab_size=V, **flags)
        run = _dit_train_run(_dit_train_setup(
            cfg, 2 * SMALL_L1024_MICRO_BATCH, SMALL_L1024_MICRO_BATCH),
            DEV, 0)
        batch = run.batch(torch.Generator(device=DEV).manual_seed(1))
        for fn in kernels.values():
            fn.launches = 0
        wrappers = {**{n: getattr(A, n) for n in attn},
                    **{n: getattr(FA, n) for n in FLASH}}
        tc = {n: w.tensor_core_launches for n, w in wrappers.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = [run.step(run.state, batch)[1] for _ in range(steps)]
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / steps
        launches = {k: fn.launches for k, fn in kernels.items()}
        n_micro = steps * run.accum_steps
        _launch_check(f'DiT-small L=1024 {route}', kernels, launches,
                      TEXT8_PER_MICRO_STEP[route], n_micro)
        for n, w in wrappers.items():
            check(w.tensor_core_launches - tc[n] == launches[n],
                  f'DiT-small L=1024 {route}: {n} missed the tensor cores')
        loss = [m['loss'].item() for m in metrics]
        gnorm = [m['grad_norm'].item() for m in metrics]
        check(all(math.isfinite(v) for v in loss + gnorm),
              f'DiT-small L=1024 {route}: non-finite loss or grad norm')
        out[route] = {'ms_per_step': secs * 1e3,
                      'tokens_per_s': run.global_batch * cfg.length / secs,
                      'peak_memory_bytes': torch.cuda.max_memory_allocated(),
                      'loss': loss, 'grad_norm': gnorm,
                      'launches_per_micro_step': {
                          k: v / n_micro for k, v in launches.items() if v}}
        for k, v in launches.items():
            total[k] += v
        del run, batch, metrics
        torch.cuda.empty_cache()
    emit({'phase': 'dit_small_l1024_train', 'length': cfg.length,
          'steps': steps,
          'global_batch': 2 * SMALL_L1024_MICRO_BATCH,
          'micro_batch': SMALL_L1024_MICRO_BATCH, **out})
    return total


# ---------------------------------------------------------------------------
# The UNet serving path: CIFAR10 UDLM with D-CFG
# ---------------------------------------------------------------------------

def expected_norms(cfg):
    """GroupNorms of one UNet forward, counted from the architecture: two
    per ResBlock (num_res_blocks per scale down, one more per scale up, two
    in the middle), one per AttnBlock (at one scale down and up, one in
    the middle) and norm_out."""
    res = cfg.num_scales * (2 * cfg.num_res_blocks + 1) + 2
    attn = 2 * cfg.num_res_blocks + 2
    return 2 * res + attn + 1


def unet_forward_census(model, cfg):
    """What one forward of one image runs, read by hooks during a B=1
    forward: {(H, W, C, act): count} of the GroupNorms (GNorm modules), and
    the multiply-accumulates of the convs (counted in the model's `_conv`),
    the dense and 1x1 projections and the attention products."""
    from ddg_tpu_torch.models import unet as U
    norms, macs = {}, [0]

    def on_norm(mod, args):
        key = (*args[0].shape[1:], mod.act)
        norms[key] = norms.get(key, 0) + 1

    def conv(mod, x, **kw):          # the model's convs go through _conv
        out = plain_conv(mod, x, **kw)
        macs[0] += out.numel() * mod.in_channels * mod.kernel_size[0] \
            * mod.kernel_size[1]
        return out

    def on_dense(mod, args, out):
        macs[0] += out.numel() * args[0].shape[-1]

    def on_attn(mod, args):
        _, Hh, Ww, C = args[0].shape
        macs[0] += 2 * (Hh * Ww) ** 2 * C          # QK^T and PV
    hooks = []
    for m in model.modules():
        if isinstance(m, U.GNorm):
            hooks.append(m.register_forward_pre_hook(on_norm))
        elif isinstance(m, (torch.nn.Linear, U.NiN)):
            hooks.append(m.register_forward_hook(on_dense))
        elif isinstance(m, U.AttnBlock):
            hooks.append(m.register_forward_pre_hook(on_attn))
    L_img = cfg.input_channels * cfg.image_size ** 2
    plain_conv, U._conv = U._conv, conv
    try:
        with torch.no_grad():
            model(torch.zeros((1, L_img), dtype=torch.int32, device=DEV),
                  torch.ones((1,), device=DEV),
                  torch.zeros((1,), dtype=torch.int32, device=DEV))
    finally:
        U._conv = plain_conv
        for h in hooks:
            h.remove()
    return norms, macs[0]


def check_tiny_unet():
    """A tiny float32 UNet (fused GroupNorm on) on the card against the same
    weights on the CPU, and one fused D-CFG step (gamma 2) from the same
    x_t, sigma and Gumbel noise composed as the sampler composes it: the
    trunk's output to 1e-4, the logits to the CPU tests' bar (1e-3 abs +
    5e-3 relative: the logistic head's tail cancels), the tokens identical
    where the CPU's top-two perturbed scores differ by more than MARGIN."""
    import dataclasses
    import numpy as np
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.convert import make_unet_state_dict
    from ddg_tpu_torch.entry import unet_flagship
    from ddg_tpu_torch.models import UNet, make_model_apply
    from ddg_tpu_torch.ops import fused_sampling as fs
    spec, cfg, _, _, _ = unet_flagship(tiny=True, device='cpu')
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(5)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in make_unet_state_dict(
              UNet(cfg), np.random.RandomState(3)).items()}
    Bt, Lt, Vt = 2, 3 * cfg.image_size ** 2, cfg.vocab_size
    xt = torch.randint(0, Vt, (Bt, Lt), generator=gen, dtype=torch.int32)
    sigma = 0.1 + 2 * torch.rand((Bt,), generator=gen)
    cond = torch.tensor([3, 8], dtype=torch.int32)
    null = torch.full_like(cond, cfg.num_classes)
    mct = 1 - torch.exp(-sigma)
    mcs = 0.6 * mct
    g = -torch.log(-torch.log(torch.rand((Bt, Lt, Vt), generator=gen)
                              .clamp_min(1e-20)))
    outs = {}
    for dev in ('cpu', DEV):
        m = UNet(cfg)
        m.load_state_dict(sd, strict=True)
        apply = make_model_apply(m.to(dev).eval())
        args = [t.to(dev) for t in (xt, sigma, cond)]
        logits, hidden = apply(apply.params, *args, return_hidden_states=True)
        x2, s2, c2 = (torch.cat([a, b]).to(dev) for a, b in (
            (xt, xt), (sigma, sigma), (cond, null)))
        raw = SM._raw_logits(spec, apply, apply.params, x2, s2, c2)
        tok = fs.fused_uniform_cfg_sample(
            7, x2[:Bt], raw[:Bt], raw[Bt:], GAMMA, (1 - mct).to(dev),
            (1 - mcs).to(dev), vocab_size=Vt, gumbel=g.to(dev))
        outs[dev] = [t.cpu() for t in (logits, hidden, raw, tok)]
    (l_c, h_c, raw_c, tok_c), (l_d, h_d, _, tok_d) = outs['cpu'], outs[DEV]
    check(bool(torch.isfinite(l_d).all()), 'tiny UNet: non-finite logits')
    h_err = (h_c - h_d).abs().max().item()
    check(h_err <= 1e-4, f'tiny UNet: trunk output differs by {h_err}')
    excess = ((l_c - l_d).abs() - 5e-3 * l_c.abs()).max().item()
    check(excess <= 1e-3, f'tiny UNet: logits beyond the bar by {excess}')
    scores = fs.uniform_perturbed_scores(
        7, fs.uniform_cfg_log_num(raw_c[:Bt], raw_c[Bt:], GAMMA, xt, 1 - mct,
                                  1 - mcs, vocab_size=Vt),
        vocab_size=Vt, gumbel=g)
    _, n_cmp = _uniform_token_check('tiny UNet fused D-CFG step', tok_d,
                                    tok_c, scores, Vt)
    emit({'phase': 'tiny_unet_card_vs_cpu', 'trunk_max_abs_err': h_err,
          'logits_max_abs_err': (l_c - l_d).abs().max().item(),
          'logit_std': l_c.std().item(), 'step_tokens_compared': n_cmp,
          'step_tokens_equal': int((tok_c == tok_d).sum().item()),
          'step_tokens': tok_c.numel()})


# The DiMamba routes the tiny card-vs-CPU checks take: the fused block
# (K18, K19), the unfused chain around the scan (K14, K15) and around the
# dt-lowrank scan (K16, K17).
TINY_DIMAMBA_ROUTES = (
    ('fused_block', dict(fused_block=True)),
    ('scan_kernel', dict(fused_block=False, pallas_scan=True)),
    ('scan_kernel_dtlr', dict(fused_block=False, pallas_scan=True,
                              dt_inkernel=True)))


def check_tiny_dimamba():
    """`dimamba_flagship(tiny=True)`'s model in float32 (its matrices x4, as
    the CPU tests scale them, so the mixer moves the logits) on the card
    against the same weights on the CPU, through the fused block (K18 on
    the card, its plain version on the CPU), the unfused chain around K14
    and that around K16 (TINY_DIMAMBA_ROUTES): logits to the 1e-3 bar; and
    one fused D-CFG step (gamma 2,
    K10) from the same x_t, sigma and Gumbel noise: tokens identical where
    the CPU's top-two perturbed scores differ by more than MARGIN."""
    import dataclasses
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import dimamba_flagship
    from ddg_tpu_torch.models import DiMamba, make_model_apply
    from ddg_tpu_torch.ops import fused_sampling as fs
    spec, cfg, model, _, _ = dimamba_flagship(tiny=True, device='cpu')
    sd = {k: v.float() * (4 if v.ndim >= 2 and 'A_log' not in k else 1)
          for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(6)
    Bt, Lt, Vt = 2, cfg.length, cfg.vocab_size
    xt = torch.randint(0, Vt, (Bt, Lt), generator=gen, dtype=torch.int32)
    sigma = 0.1 + 2 * torch.rand((Bt,), generator=gen)
    cond = torch.tensor([3, 8], dtype=torch.int32)
    null = torch.full_like(cond, cfg.num_classes)
    mct = 1 - torch.exp(-sigma)
    mcs = 0.6 * mct
    g = -torch.log(-torch.log(torch.rand((Bt, Lt, Vt), generator=gen)
                              .clamp_min(1e-20)))
    rec = {}
    for route, kw in TINY_DIMAMBA_ROUTES:
        outs = {}
        for dev in ('cpu', DEV):
            m = DiMamba(dataclasses.replace(cfg, compute_dtype=torch.float32,
                                            dropout=0.0, **kw))
            m.load_state_dict(sd, strict=True)
            apply = make_model_apply(m.to(dev).eval())
            logits = apply(apply.params, *(t.to(dev) for t in
                                           (xt, sigma, cond)))
            x2, s2, c2 = (torch.cat([a, b]).to(dev) for a, b in (
                (xt, xt), (sigma, sigma), (cond, null)))
            raw = SM._raw_logits(spec, apply, apply.params, x2, s2, c2)
            tok = fs.fused_uniform_cfg_sample(
                7, x2[:Bt], raw[:Bt], raw[Bt:], GAMMA, (1 - mct).to(dev),
                (1 - mcs).to(dev), vocab_size=Vt, gumbel=g.to(dev))
            outs[dev] = [t.cpu() for t in (logits, raw, tok)]
        (l_c, raw_c, tok_c), (l_d, _, tok_d) = outs['cpu'], outs[DEV]
        check(bool(torch.isfinite(l_d).all()),
              f'tiny DiMamba {route}: non-finite logits')
        err = (l_c - l_d).abs().max().item()
        check(err <= 1e-3, f'tiny DiMamba {route}: card vs CPU logits '
                           f'differ by {err}')
        scores = fs.uniform_perturbed_scores(
            7, fs.uniform_cfg_log_num(raw_c[:Bt], raw_c[Bt:], GAMMA, xt,
                                      1 - mct, 1 - mcs, vocab_size=Vt),
            vocab_size=Vt, gumbel=g)
        _, n_cmp = _uniform_token_check(f'tiny DiMamba {route} fused D-CFG '
                                        'step', tok_d, tok_c, scores, Vt)
        rec[route] = {'logits_max_abs_err': err,
                      'logit_std': l_c.std().item(),
                      'step_tokens_compared': n_cmp,
                      'step_tokens_equal': int((tok_c == tok_d).sum()),
                      'step_tokens': tok_c.numel()}
    emit({'phase': 'tiny_dimamba_card_vs_cpu', **rec})


def device_trace(run):
    """The events of one torch.profiler trace of `run` (host and card)."""
    import os
    import tempfile
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)['traceEvents']


def device_busy_ms(run):
    """(busy, span, lead) ms of `run` from one torch.profiler trace
    (`trace_busy_ms`)."""
    return trace_busy_ms(device_trace(run))


def trace_busy_ms(events):
    """(busy, span, lead) ms of a trace's events: busy sums the device time
    of its kernels, copies and fills (one stream, so they do not overlap);
    span runs on the card's clock from the first of them to the end of the
    last, so its gaps are the card's idle time; lead is the host's time
    from its first operation to the first of them."""
    dev = [e for e in events
           if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
    check(dev, 'the profiler recorded no kernel on the card')
    host = [e['ts'] for e in events
            if e.get('cat') in ('cpu_op', 'cuda_runtime', 'cuda_driver')]
    t_first = min(e['ts'] for e in dev)
    t_end = max(e['ts'] + e['dur'] for e in dev)
    lead = t_first - min(host + [t_first])
    return (sum(e['dur'] for e in dev) / 1e3, (t_end - t_first) / 1e3,
            lead / 1e3)


def run_dimamba_path(kernels, steps=128, budget_s=8.0, unfused_steps=4):
    """The Species10 serving path at full width and depth:
    `dimamba_flagship()` sampling D-CFG (gamma 2) and unguided, T=128,
    B=8 of one class, with exact launches per step (16 K18 calls a forward,
    K10 or K9 once), 0 host syncs per step, and the card's idle share (the
    gaps between the kernels of two profiled steps). A run whose T=128
    would take over `budget_s` (estimated from its warm-up) runs fewer
    steps and says so: 8 s keeps the script near its time with the text8
    phases (about 42 D-CFG and 82 unguided steps; ms/step is the metric,
    and samples/s is given at T=128 from it). Then `unfused_steps`
    D-CFG steps of the same weights in a model built with
    `fused_block=False`: the unfused chain around K14, 16 calls a forward.
    Returns the launches of each path."""
    import dataclasses
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import dimamba_flagship
    from ddg_tpu_torch.models import DiMamba, make_model_apply
    t0 = time.perf_counter()
    flag = dimamba_flagship(device=DEV)
    spec, cfg, _, apply_fn, params = flag
    emit({'phase': 'dimamba_flagship', 'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in params.values()),
          'hidden': cfg.hidden_size, 'd_inner': cfg.d_inner,
          'd_state': cfg.d_state, 'dt_rank': cfg.dt_rank,
          'blocks': cfg.n_blocks, 'length': cfg.length,
          'vocab': cfg.vocab_size, 'classes': cfg.num_classes})
    cond = torch.zeros((SB,), dtype=torch.int32, device=DEV)
    per_fwd = 2 * cfg.n_blocks
    dcfg = SM.GuidanceSpec(method='cfg', gamma=GAMMA)
    runs = [('dcfg', dcfg, {'mamba_inner': per_fwd,
                            'fused_uniform_cfg_sample': 1}),
            ('unguided', None, {'mamba_inner': per_fwd,
                                'fused_uniform_sample': 1})]

    def sample(flag_, guidance, n_steps, seed):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        kw = {} if guidance is None else {'guidance': guidance, 'cond': cond}
        return SM.diffusion_sample(
            flag_[0], SM.SamplerSpec(steps=n_steps, use_cache=False,
                                     fused=True),
            flag_[3], flag_[4], gen, batch_size=SB, length=cfg.length, **kw)

    out = {'species10_serving': {k: 0 for k in kernels}}
    for i, (name, guidance, per_step) in enumerate(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(flag, guidance, 2, 99)           # warm-up, outside the counts
        torch.cuda.synchronize()
        est = (time.perf_counter() - t0) / 2 * steps
        n_steps = steps if est <= budget_s else max(
            2, int(steps * budget_s / est))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        x = sample(flag, guidance, n_steps, i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        for k in kernels:
            out['species10_serving'][k] += launches[k]
        _launch_check(f'species10 {name}', kernels, launches, per_step,
                      n_steps)
        n_syncs = _sync_check(f'species10 {name}',
                              lambda: sample(flag, guidance, 2, 98))
        busy, span, lead = device_busy_ms(
            lambda: sample(flag, guidance, 2, 97))
        ms_step = secs / n_steps * 1e3
        hist = torch.bincount(x.flatten().long(), minlength=cfg.vocab_size)
        emit({'phase': 'species10_main_path', 'run': name, 'batch': SB,
              'steps': n_steps,
              'steps_note': (None if n_steps == steps else
                             f'cut from {steps}: T={steps} estimated at '
                             f'{est:.1f} s > {budget_s} s'),
              'seconds': secs, 'ms_per_step': ms_step,
              f'samples_per_s_at_T{steps}': SB / (ms_step * steps / 1e3),
              'profiled_busy_ms_per_step': busy / 2,
              'profiled_span_ms_per_step': span / 2,
              'profiled_lead_ms': lead,
              'idle_share': 1.0 - busy / span,
              'peak_memory_bytes': peak,
              'launches_per_step': {k: v / n_steps
                                    for k, v in launches.items() if v},
              'host_syncs_per_step': n_syncs / 2,
              'token_histogram': hist.tolist()})
        check(tuple(x.shape) == (SB, cfg.length) and x.dtype == torch.int32,
              f'species10 {name}: output {tuple(x.shape)} {x.dtype}')
        check(bool(((x >= 0) & (x < cfg.vocab_size)).all()),
              f'species10 {name}: token outside [0, {cfg.vocab_size})')

    model = DiMamba(dataclasses.replace(cfg, fused_block=False))
    model.load_state_dict(flag[2].state_dict(), strict=True)
    apply = make_model_apply(model.to(DEV).eval())
    unfused = (spec, cfg, model, apply, apply.params)
    sample(unfused, dcfg, 1, 96)                 # warm-up
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    x = sample(unfused, dcfg, unfused_steps, 5)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    out['species10_unfused'] = launches
    _launch_check('species10 unfused', kernels, launches,
                  {'ssm_scan': per_fwd, 'fused_uniform_cfg_sample': 1},
                  unfused_steps)
    check(bool(((x >= 0) & (x < cfg.vocab_size)).all()),
          'species10 unfused: token outside the vocabulary')
    ms_dense = secs / unfused_steps * 1e3
    emit({'phase': 'species10_unfused_path', 'run': 'dcfg', 'batch': SB,
          'steps': unfused_steps, 'ms_per_step': ms_dense,
          'launches_per_step': {k: v / unfused_steps
                                for k, v in launches.items() if v}})

    # The dt-lowrank route: the same weights through the entry point's
    # 'dt_lowrank' mixer, the unfused chain around K16.
    del model, apply, unfused
    flag_lr = dimamba_flagship(device=DEV, route='dt_lowrank')
    sample(flag_lr, dcfg, 1, 95)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    x = sample(flag_lr, dcfg, unfused_steps, 5)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    out['species10_dtlr'] = launches
    _launch_check('species10 dt-lowrank', kernels, launches,
                  {'ssm_scan_dtlr': per_fwd, 'fused_uniform_cfg_sample': 1},
                  unfused_steps)
    n_syncs = _sync_check('species10 dt-lowrank',
                          lambda: sample(flag_lr, dcfg, 2, 94))
    check(bool(((x >= 0) & (x < cfg.vocab_size)).all()),
          'species10 dt-lowrank: token outside the vocabulary')
    ms_lr = secs / unfused_steps * 1e3
    emit({'phase': 'species10_dtlr_path', 'run': 'dcfg', 'batch': SB,
          'steps': unfused_steps, 'ms_per_step': ms_lr,
          'dense_unfused_ms_per_step': ms_dense,
          'dtlr_over_dense': ms_lr / ms_dense,
          'samples_per_s_at_T128': SB / (ms_lr * steps / 1e3),
          'peak_memory_bytes': peak,
          'launches_per_step': {k: v / unfused_steps
                                for k, v in launches.items() if v},
          'host_syncs_per_step': n_syncs / 2})
    return out


def check_tiny_dimamba_train():
    """`dimamba_flagship(tiny=True)`'s model in float32 (matrices x4, dropout
    0) with the training run's optimizer and EMA, card against CPU
    (`_train_step_card_vs_cpu`), on the three kernel routes: the fused
    block (K18 and K19 on the card, their plain versions on the CPU), the
    unfused chain around the scan (K14, K15) and around the dt-lowrank scan
    (K16, K17)."""
    import dataclasses
    from ddg_tpu_torch.diffusion import sample_corruption
    from ddg_tpu_torch.entry import dimamba_train_flagship
    from ddg_tpu_torch.models import DiMamba
    run = dimamba_train_flagship(device='cpu', tiny=True)
    sd = {k: v.float() * (4 if v.ndim >= 2 and 'A_log' not in k else 1)
          for k, v in run.model.state_dict().items()}
    gen = torch.Generator().manual_seed(8)
    data = run.batch(gen)
    x0, cond = data['input_ids'][0], data['cond'][0]
    t, xt = sample_corruption(run.spec, x0, gen)
    optim = dataclasses.replace(run.optim, num_warmup_steps=0)
    rec = {}
    for route, kw in TINY_DIMAMBA_ROUTES:
        cfg = dataclasses.replace(run.cfg, compute_dtype=torch.float32,
                                  dropout=0.0, **kw)
        rec[route] = _train_step_card_vs_cpu(
            f'tiny DiMamba train {route}', lambda: DiMamba(cfg), sd,
            run.spec, (x0, t, xt, cond), optim, run.averaging)
    emit({'phase': 'tiny_dimamba_train_card_vs_cpu', **rec})


def _micro_step_fn(run, model, accum_steps=1):
    """A train step of `accum_steps` micro-batches for `model` (the run's
    optimizer and averaging), with its own train state."""
    from ddg_tpu_torch.models import make_model_apply
    from ddg_tpu_torch.runtime.train_state import (init_train_state,
                                                   make_train_step)
    apply = make_model_apply(model)
    state = init_train_state(torch.Generator(device=DEV).manual_seed(3),
                             apply.params, run.optim, run.averaging)
    return state, make_train_step(run.spec, apply, run.optim, run.averaging,
                                  accum_steps=accum_steps)


def run_dimamba_train_path(kernels, warmup=1, steps=3):
    """The Species10 training run at full width and depth: warm-up steps,
    then `steps` timed ones (tokens/s, ms/step, peak memory, loss, grad
    norm), exact launches per micro-step (16 K18 and 16 K19: accumulating,
    the step skips the t=0 forward that `zero_recon_loss` keeps only as a
    metric), 0 host syncs per step and the card's idle share over one
    profiled step. Then a step of the same weights built with
    `fused_block=False`, two micro-batches of a quarter of the rows each:
    exactly 16 K14 and 16 K15 per micro-step.
    Returns the launches of each path."""
    import dataclasses
    from ddg_tpu_torch.entry import dimamba_train_flagship
    from ddg_tpu_torch.models import DiMamba
    t0 = time.perf_counter()
    run = dimamba_train_flagship(device=DEV)
    cfg = run.cfg
    emit({'phase': 'dimamba_train_flagship',
          'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in run.apply_fn.params.values()),
          'hidden': cfg.hidden_size, 'd_inner': cfg.d_inner,
          'blocks': cfg.n_blocks, 'length': cfg.length,
          'global_batch': run.global_batch, 'micro_batch': run.micro_batch,
          'accum_steps': run.accum_steps})
    batch = run.batch(torch.Generator(device=DEV).manual_seed(1))
    for _ in range(warmup):
        run.step(run.state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = [run.step(run.state, batch)[1] for _ in range(steps)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_micro = steps * run.accum_steps
    per_fwd = 2 * cfg.n_blocks
    _launch_check('species10 training', kernels, launches,
                  {'mamba_inner': per_fwd, 'mamba_inner_bwd': per_fwd},
                  n_micro)
    n_syncs = _sync_check('species10 training',
                          lambda: run.step(run.state, batch))
    busy, span, lead = device_busy_ms(lambda: run.step(run.state, batch))
    loss = [m['loss'].item() for m in metrics]
    gnorm = [m['grad_norm'].item() for m in metrics]
    ms_micro = secs * 1e3 / run.accum_steps
    emit({'phase': 'species10_train_main_path', 'steps': steps,
          'ms_per_step': secs * 1e3,
          'tokens_per_s': run.global_batch * cfg.length / secs,
          'ms_per_micro_step': ms_micro,
          'peak_memory_bytes': peak, 'loss': loss, 'grad_norm': gnorm,
          'lr': metrics[-1]['lr'].item(),
          'launches_per_micro_step': {k: v / n_micro
                                      for k, v in launches.items() if v},
          'host_syncs_in_a_step': n_syncs,
          'profiled_busy_ms': busy, 'profiled_span_ms': span,
          'profiled_lead_ms': lead, 'idle_share': 1.0 - busy / span})
    check(all(math.isfinite(v) for v in loss + gnorm),
          'species10 training: non-finite loss or grad norm')

    # The unfused route: a step of the same weights, two micro-batches of a
    # quarter of the rows each (PyTorch's autograd keeps the unfused chain's
    # intermediates, about 4x the fused route's activations).
    rows = max(1, run.micro_batch // 4)
    del metrics
    torch.cuda.empty_cache()
    model = DiMamba(dataclasses.replace(cfg, fused_block=False))
    model.load_state_dict(run.model.state_dict(), strict=True)
    state, step = _micro_step_fn(run, model.to(DEV), accum_steps=2)
    micro = {k: v[:, :rows] for k, v in batch.items()}
    step(state, micro)                            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    unfused_loss = step(state, micro)[1]['loss'].item()
    torch.cuda.synchronize()
    ms_unfused = (time.perf_counter() - t0) * 1e3 / 2
    unfused = {k: fn.launches for k, fn in kernels.items()}
    _launch_check('species10 training unfused', kernels, unfused,
                  {'ssm_scan': per_fwd, 'ssm_scan_bwd': per_fwd}, 2)
    emit({'phase': 'species10_train_unfused_route', 'rows': rows,
          'accum_steps': 2,
          'ms_per_micro_step': ms_unfused,
          'ms_per_row': ms_unfused / rows,
          'fused_ms_per_row': ms_micro / run.micro_batch,
          'unfused_over_fused_per_row': (ms_unfused / rows)
          / (ms_micro / run.micro_batch),
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'loss': unfused_loss,
          'launches': {k: v for k, v in unfused.items() if v}})
    check(math.isfinite(unfused_loss), 'species10 unfused: non-finite loss')
    return {'species10_training': launches,
            'species10_training_unfused': unfused}


def run_dimamba_dtlr_train_path(kernels, warmup=1, steps=2):
    """The Species10 training run on the 'dt_lowrank' route at full width
    and depth (`dimamba_train_flagship(route='dt_lowrank')`: the unfused
    chain around K16 and K17, global batch 32 x 32768 as micro-batches of
    DIMAMBA_DTLR_TRAIN_MICRO_BATCH): warm-up, then `steps` timed steps
    (tokens/s, ms/step, peak memory, loss, grad norm), exact launches per
    micro-step (16 K16 and 16 K17, none of K14, K15, K18, K19) and 0 host
    syncs per step. Returns its launches."""
    from ddg_tpu_torch.entry import dimamba_train_flagship
    torch.cuda.empty_cache()
    run = dimamba_train_flagship(device=DEV, route='dt_lowrank')
    batch = run.batch(torch.Generator(device=DEV).manual_seed(1))
    for _ in range(warmup):
        run.step(run.state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = [run.step(run.state, batch)[1] for _ in range(steps)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_micro = steps * run.accum_steps
    per_fwd = 2 * run.cfg.n_blocks
    _launch_check('species10 training dt-lowrank', kernels, launches,
                  {'ssm_scan_dtlr': per_fwd, 'ssm_scan_dtlr_bwd': per_fwd},
                  n_micro)
    n_syncs = _sync_check('species10 training dt-lowrank',
                          lambda: run.step(run.state, batch))
    loss = [m['loss'].item() for m in metrics]
    gnorm = [m['grad_norm'].item() for m in metrics]
    emit({'phase': 'species10_train_dtlr_path', 'steps': steps,
          'micro_batch': run.micro_batch, 'accum_steps': run.accum_steps,
          'ms_per_step': secs * 1e3,
          'tokens_per_s': run.global_batch * run.cfg.length / secs,
          'ms_per_micro_step': secs * 1e3 / run.accum_steps,
          'peak_memory_bytes': peak, 'loss': loss, 'grad_norm': gnorm,
          'launches_per_micro_step': {k: v / n_micro
                                      for k, v in launches.items() if v},
          'host_syncs_in_a_step': n_syncs})
    check(all(math.isfinite(v) for v in loss + gnorm),
          'species10 training dt-lowrank: non-finite loss or grad norm')
    return {'species10_training_dtlr': launches}


def check_dimamba_learning(micro_steps=30, rows=4):
    """The three kernel routes of the Species10 DiMamba (the fused block,
    the unfused chain around K14/K15 and around K16/K17) from the same
    weights and the same generator, lr 2e-3 without warmup, `micro_steps`
    steps on one micro-batch of `rows` sequences whose bases depend on the
    class. Bars, set before the first run: each route's mean loss over the
    last 5 steps at least 10% below that over the first 5; each unfused
    route's last-5 mean closer to the fused route's than the pooled std of
    the two routes' last-10 losses (the criterion of the TPU's
    fused-vs-unfused convergence check,
    artifacts/round5/megakernel_parity.json)."""
    import dataclasses
    from ddg_tpu_torch.entry import DNA_BASES, dimamba_train_flagship
    from ddg_tpu_torch.models import DiMamba
    run = dimamba_train_flagship(device=DEV, seed=2)
    run.optim = dataclasses.replace(run.optim, num_warmup_steps=0)
    gen = torch.Generator(device=DEV).manual_seed(4)
    cond = torch.arange(rows, device=DEV, dtype=torch.int32) \
        % run.cfg.num_classes
    n_bases = DNA_BASES[1] - DNA_BASES[0]
    # Class c draws base c mod 5 with probability 0.7, the others evenly.
    probs = torch.full((rows, n_bases), 0.3 / (n_bases - 1), device=DEV)
    probs[torch.arange(rows), cond.long() % n_bases] = 0.7
    ids = torch.multinomial(probs, run.cfg.length, replacement=True,
                            generator=gen) + DNA_BASES[0]
    batch = {'input_ids': ids.int(), 'cond': cond,
             'attention_mask': torch.ones_like(ids, dtype=torch.float32)}
    out, t0 = {}, time.perf_counter()
    for route, kw in (('fused_block', dict(fused_block=True)),
                      ('scan_kernel', dict(fused_block=False)),
                      ('scan_kernel_dtlr', dict(fused_block=False,
                                                dt_inkernel=True))):
        model = DiMamba(dataclasses.replace(run.cfg, **kw))
        model.load_state_dict(run.model.state_dict(), strict=True)
        state, step = _micro_step_fn(run, model.to(DEV))
        losses = torch.stack([step(state, batch)[1]['loss']
                              for _ in range(micro_steps)]).tolist()
        check(all(math.isfinite(v) for v in losses),
              f'learning {route}: non-finite loss')
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        check(last <= 0.9 * first, f'learning {route}: loss fell from '
                                   f'{first} to {last}, less than 10%')
        out[route] = {'loss_first5': first, 'loss_last5': last,
                      'drop': 1 - last / first, 'losses': losses}
    gaps = {}
    for route in ('scan_kernel', 'scan_kernel_dtlr'):
        tails = [out[r]['losses'][-10:] for r in ('fused_block', route)]
        pooled = math.sqrt(sum(statistics.variance(t) for t in tails) / 2)
        gap = abs(out['fused_block']['loss_last5'] - out[route]['loss_last5'])
        gaps[route] = {'last5_gap': gap, 'pooled_tail_std': pooled}
    emit({'phase': 'species10_learning_check', 'steps': micro_steps,
          'rows': rows, 'seconds': time.perf_counter() - t0,
          'gaps_to_fused': gaps, **out})
    for route, g in gaps.items():
        check(g['last5_gap'] < g['pooled_tail_std'],
              f'learning: the fused and {route} routes end {g["last5_gap"]} '
              f'apart, over the pooled tail std {g["pooled_tail_std"]}')


def run_unet_path(kernels, flag, flag8, n_norms, steps=128):
    """The UNet main path at full width and depth: D-CFG (gamma 2) and
    unguided ancestral sampling on the bf16 flagship `flag`, and D-CFG on
    the int8 one `flag8` (`unet_flagship(int8=True)`, the JAX suite's
    `unet_int8` line: 51 int8 convs and 37 int8 NiNs on the eager
    quantization of `ops.quant`, K13 writing bf16), T=128, B=32, each with
    exact launches per step (K10 or K9 once, K13 once per GroupNorm),
    host syncs per step counted under PyTorch's sync debug mode, and the
    card's busy and idle share and all kernel launches a step from one
    2-step trace. Returns the launches of each flagship's lines
    ('unet_serving', 'unet_int8_serving')."""
    from ddg_tpu_torch import samplers as SM
    L_img = flag[1].length
    cond = torch.zeros((UB,), dtype=torch.int32, device=DEV)
    dcfg = SM.GuidanceSpec(method='cfg', gamma=GAMMA)
    flags = {'bf16': flag, 'int8': flag8}
    # (run, flagship, guidance, exact launches a step, JAX line)
    runs = [
        ('dcfg', 'bf16', dcfg,
         {'fused_uniform_cfg_sample': 1, 'fused_group_norm_act': n_norms},
         'unet'),
        ('unguided', 'bf16', None,
         {'fused_uniform_sample': 1, 'fused_group_norm_act': n_norms},
         None),
        ('int8_dcfg', 'int8', dcfg,
         {'fused_uniform_cfg_sample': 1, 'fused_group_norm_act': n_norms},
         'unet_int8'),
    ]

    def sample(model, guidance, n_steps, seed):
        spec, _, _, apply_fn, params = flags[model]
        gen = torch.Generator(device=DEV).manual_seed(seed)
        kw = {} if guidance is None else {'guidance': guidance, 'cond': cond}
        return SM.diffusion_sample(
            spec, SM.SamplerSpec(steps=n_steps, use_cache=False, fused=True),
            apply_fn, params, gen, batch_size=UB, length=L_img, **kw)

    for _, model, guidance, _, _ in runs:   # cuDNN's and cuBLASLt's choices,
        sample(model, guidance, 2, 99)      # outside the counts
    totals = {'unet_serving': {name: 0 for name in kernels},
              'unet_int8_serving': {name: 0 for name in kernels}}
    for i, (name, model, guidance, per_step, line) in enumerate(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        x = sample(model, guidance, steps, i)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        path = 'unet_int8_serving' if model == 'int8' else 'unet_serving'
        for k in kernels:
            totals[path][k] += launches[k]
        _launch_check(f'unet {name}', kernels, launches, per_step, steps)
        n_syncs = _sync_check(f'unet {name}',
                              lambda: sample(model, guidance, 2, 98))
        events = device_trace(lambda: sample(model, guidance, 2, 97))
        busy, span, lead = trace_busy_ms(events)
        n_kernels = sum(e.get('cat') == 'kernel' for e in events)
        hist = torch.bincount(x.flatten().long(), minlength=flag[1].vocab_size)
        emit({'phase': 'unet_main_path', 'run': name, 'int8': model == 'int8',
              'jax_line': line, 'batch': UB, 'steps': steps, 'seconds': secs,
              'samples_per_s': UB / secs, 'ms_per_step': secs / steps * 1e3,
              'peak_memory_bytes': peak,
              'profiled_busy_ms_per_step': busy / 2,
              'profiled_span_ms_per_step': span / 2,
              'profiled_lead_ms': lead, 'idle_share': 1.0 - busy / span,
              'kernel_launches_per_step_all': n_kernels / 2,
              'launches': launches,
              'launches_per_step': {k: v / steps for k, v in launches.items()
                                    if v},
              'host_syncs_per_step': n_syncs / 2,
              'distinct_tokens': int((hist > 0).sum().item()),
              'top_token_share': (hist.max() / x.numel()).item()})
        check(tuple(x.shape) == (UB, L_img) and x.dtype == torch.int32,
              f'unet {name}: output {tuple(x.shape)} {x.dtype}')
        check(bool(((x >= 0) & (x < flag[1].vocab_size)).all()),
              f'unet {name}: token outside [0, {flag[1].vocab_size})')
    return totals


def _int8_layers(model):
    """(name, module) of the UNet's int8 layers: its QConvs and int8
    NiNs."""
    from ddg_tpu_torch.models import unet as U
    from ddg_tpu_torch.ops import quant
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, quant.QConv)
            or (isinstance(m, U.NiN) and m.int8)]


def _int8_codes(mod, x):
    """The activation codes and scales an int8 layer forms from x: per
    sample for a QConv, per row for a NiN."""
    from ddg_tpu_torch.ops import quant
    if isinstance(mod, quant.QConv):
        return quant.quantize_per_sample(x)
    return quant.quantize_rowwise(x)


def check_tiny_unet_int8():
    """The tiny UNet under `quant_int8` (float32 compute and GroupNorm
    outputs, the fused GroupNorm on: K13 on the card), card against CPU.
    Each int8 layer (19 convs, 20 NiNs), fed on the CPU the input it got
    on the card, must give the card's activation codes and scales, int32
    sums (the convs') and output bit for bit (an exact s32 product, then
    the same fp32 roundings). End to end, an activation within fp32 noise
    of a rounding tie quantizes to the next code on one side (K13 and
    cuDNN sum in other orders than the CPU), and the flip grows: each
    later layer quantizes inputs that now differ, so a sample's codes
    drift apart layer by layer (on the card, 7512 of one sample's 22992
    codes). So a sample is held to check_tiny_unet's bars (trunk
    output 1e-4, logits 1e-3 abs + 5e-3 relative) only where none of its
    codes flips (the count a sample is printed), and at least 2 of the 8
    samples must be free of flips (5 were on the card); over all samples, the
    mean TV between the card's and the CPU's posteriors (softmax of the
    logits) must stay within twice the int8 scheme's own shift, the mean
    TV between the CPU's int8 and float32 models: the two int8 runs are
    then no further apart than two independent quantizations of the float
    model."""
    import dataclasses
    import numpy as np
    from ddg_tpu_torch.convert import make_unet_state_dict
    from ddg_tpu_torch.entry import unet_flagship
    from ddg_tpu_torch.models import UNet
    from ddg_tpu_torch.ops import quant
    _, cfg, _, _, _ = unet_flagship(tiny=True, device='cpu', int8=True)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32,
                              norm_dtype=torch.float32)
    gen = torch.Generator().manual_seed(6)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in make_unet_state_dict(
              UNet(cfg), np.random.RandomState(3)).items()}
    Bt, Lt = 8, cfg.length
    xt = torch.randint(0, cfg.vocab_size, (Bt, Lt), generator=gen,
                       dtype=torch.int32)
    sigma = 0.1 + 2 * torch.rand((Bt,), generator=gen)
    cond = torch.tensor([3, 8, cfg.num_classes, 0, 1, 2, 5, 9],
                        dtype=torch.int32)
    layers, outs = {}, {}
    for dev in ('cpu', DEV):
        m = UNet(cfg)
        m.load_state_dict(sd, strict=True)
        m = m.to(dev).eval()
        seen = []
        hooks = [mod.register_forward_hook(
            lambda mod, inp, out: seen.append((mod, inp[0], out)))
            for _, mod in _int8_layers(m)]
        with torch.no_grad():
            logits, hidden = m(xt.to(dev), sigma.to(dev), cond.to(dev),
                               return_hidden_states=True)
        for hk in hooks:
            hk.remove()
        layers[dev], outs[dev] = seen, (logits.cpu(), hidden.cpu())
    check(len(layers[DEV]) == 39, 'tiny int8 UNet: expected 39 int8 layers, '
                                  f'ran {len(layers[DEV])}')
    flips, codes = torch.zeros(Bt, dtype=torch.int64), 0
    with torch.no_grad():
        for n, ((mod_c, x_c, _), (mod_d, x_d, out_d)) in enumerate(
                zip(layers['cpu'], layers[DEV])):
            (q_d, s_d), (q_c, s_c) = (_int8_codes(mod_d, x_d),
                                      _int8_codes(mod_c, x_d.cpu()))
            check(torch.equal(q_d.cpu(), q_c) and torch.equal(s_d.cpu(), s_c),
                  f'tiny int8 UNet: layer {n}: codes or scales differ on the '
                  'same input')
            if isinstance(mod_d, quant.QConv):
                kw = dict(stride=mod_d.stride[0], padding=mod_d.padding[0])
                kh, kw_ = mod_d.kernel_size
                acc_d, acc_c = (quant.int8_conv_acc(
                    q, quant.quantized_weight(mod.weight, 'conv')[0], kh, kw_,
                    mod.out_channels, **kw) for q, mod in ((q_d, mod_d),
                                                           (q_c, mod_c)))
                check(torch.equal(acc_d.cpu(), acc_c),
                      f'tiny int8 UNet: conv {n}: int32 sums differ')
            want = mod_c(x_d.cpu())
            check(torch.equal(want, out_d.cpu()),
                  f'tiny int8 UNet: layer {n} on the card differs from the '
                  'CPU on the same input by '
                  f'{(want - out_d.cpu()).abs().max().item()}')
            own = _int8_codes(mod_c, x_c)[0]
            flips += (own != q_d.cpu()).reshape(Bt, -1).sum(-1)
            codes += own.numel()
        f32 = UNet(dataclasses.replace(cfg, quant_int8=False))
        f32.load_state_dict(sd, strict=True)
        l_f32 = f32.eval()(xt, sigma, cond)
    (l_c, h_c), (l_d, h_d) = outs['cpu'], outs[DEV]
    check(bool(torch.isfinite(l_d).all()), 'tiny int8 UNet: non-finite')

    def tv(a, b):
        return (0.5 * (a.softmax(-1) - b.softmax(-1)).abs().sum(-1)).mean()

    tv_card, tv_scheme = tv(l_d, l_c).item(), tv(l_c, l_f32).item()
    same = flips == 0
    rec = {'phase': 'tiny_unet_int8_card_vs_cpu',
           'int8_layers_bit_equal_on_same_input': len(layers[DEV]),
           'flipped_codes_per_sample': flips.tolist(),
           'codes_per_sample': codes // Bt,
           'samples_without_flips': int(same.sum()),
           'tv_card_vs_cpu_mean': tv_card, 'tv_int8_vs_f32_mean': tv_scheme,
           'logit_std': l_c.std().item()}
    if same.any():
        rec['trunk_max_abs_err'] = (h_c[same] - h_d[same]).abs().max().item()
        rec['logits_max_abs_err'] = (l_c[same] - l_d[same]).abs().max().item()
        excess = ((l_c[same] - l_d[same]).abs()
                  - 5e-3 * l_c[same].abs()).max().item()
    emit(rec)
    check(int(same.sum()) >= 2,
          f'tiny int8 UNet: only {int(same.sum())} of {Bt} samples without '
          'flipped codes; the trunk and logit bars need at least 2')
    check(tv_card <= 2 * tv_scheme,
          f'tiny int8 UNet: card and CPU posteriors {tv_card} apart in mean '
          f'TV, past twice the int8 scheme\'s own {tv_scheme}')
    check(rec['trunk_max_abs_err'] <= 1e-4,
          f'tiny int8 UNet: trunk output differs by '
          f'{rec["trunk_max_abs_err"]} on a sample without flips')
    check(excess <= 1e-3,
          f'tiny int8 UNet: logits beyond the bar by {excess}')


def check_unet_int8_tv(flag, flag8, n_eval=4000, batch=4):
    """`scripts/validate_quant_tpu.py`'s test on the full-width UNet
    flagships (the same weights): the D-CFG step's posterior (gamma 2,
    alpha_t 0.4, alpha_s 0.7: what K10 draws from) of the bf16 and of the
    int8 flagship on the same x_t (uniform pixel tokens), sigma 0.9 and
    classes, in float64; the TV between them a position, and that of
    n_eval draws from the int8 posterior, against the binomial floor at
    n_eval draws (printed). The int8 scheme itself moves these posteriors
    far past that floor (per-sample activation scales make each conv's
    codes coarse): the float32 int8 model's TV from the float32 model, on
    the int8 line's own weights (`flag8`'s, float32 where they are
    quantized) and inputs, is printed beside it with its own floor ratios.
    Its layers are the ones `tests/test_torch_unet_int8.py` holds to JAX's
    int8 UNet (and `test_int8_posterior_shift_matches_jax` its shift to
    JAX's). So the check holds the int8 line to the scheme's own shift: the
    mean and 95th percentile of its TV from the bf16 line at most 1.25 x
    those of the float32 int8 model's TV from the float32 model."""
    import dataclasses
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.models import UNet, make_model_apply
    from ddg_tpu_torch.ops import fused_sampling as fs
    spec, cfg = flag[0], flag[1]
    Vu, Lu = cfg.vocab_size, cfg.length
    gen = torch.Generator(device=DEV).manual_seed(11)
    xt = torch.randint(0, Vu, (batch, Lu), generator=gen, device=DEV,
                       dtype=torch.int32)
    sigma = torch.full((batch,), 0.9, device=DEV)
    cond = torch.arange(batch, dtype=torch.int32, device=DEV)
    x2, s2 = torch.cat([xt, xt]), torch.cat([sigma, sigma])
    c2 = torch.cat([cond, torch.full_like(cond, cfg.num_classes)])
    a_t = torch.full((batch,), 0.4, device=DEV, dtype=torch.float64)
    a_s = torch.full((batch,), 0.7, device=DEV, dtype=torch.float64)
    weights = {k: v.float() for k, v in flag8[2].state_dict().items()}

    def f32_model(int8):
        m = UNet(dataclasses.replace(cfg, compute_dtype=torch.float32,
                                     norm_dtype=torch.float32,
                                     quant_int8=int8))
        m.load_state_dict(weights, strict=True)
        apply = make_model_apply(m.to(DEV).eval())
        return apply, apply.params

    q = {}
    for key, (apply_fn, params) in (
            ('bf16', flag[3:5]), ('int8', flag8[3:5]),
            ('f32', f32_model(False)), ('int8_f32', f32_model(True))):
        raw = SM._raw_logits(spec, apply_fn, params, x2, s2, c2).double()
        q[key] = torch.softmax(fs.uniform_cfg_log_num(
            raw[:batch], raw[batch:], GAMMA, xt, a_t, a_s,
            vocab_size=Vu), -1).reshape(batch * Lu, Vu)
    floor = 0.5 * torch.sqrt(2 * q['bf16'] * (1 - q['bf16'])
                             / (math.pi * n_eval)).sum(-1)
    tv = 0.5 * (q['bf16'] - q['int8']).abs().sum(-1)
    tv_scheme = 0.5 * (q['f32'] - q['int8_f32']).abs().sum(-1)
    tv_bf16 = 0.5 * (q['f32'] - q['bf16']).abs().sum(-1)
    draws = torch.multinomial(q['int8'].float(), n_eval, replacement=True,
                              generator=gen)
    rows = torch.arange(draws.shape[0], device=DEV)[:, None] * Vu
    emp = torch.bincount((draws + rows).flatten(),
                         minlength=batch * Lu * Vu).reshape(-1, Vu) / n_eval
    tv_emp = 0.5 * (emp.double() - q['bf16']).abs().sum(-1)

    def stats(t):
        return {'mean': t.mean().item(), 'p95': torch.quantile(t, 0.95)
                .item(), 'max': t.max().item()}

    rec = {'phase': 'unet_int8_tv', 'positions': batch * Lu, 'draws': n_eval,
           'tv_int8_vs_bf16': stats(tv),
           'tv_int8_f32_vs_f32': stats(tv_scheme),
           'tv_bf16_vs_f32': stats(tv_bf16),
           'floor_min': floor.min().item(), 'floor_max': floor.max().item(),
           'worst_ratio_to_floor': (tv / floor).max().item(),
           'empirical_worst_ratio_to_floor': (tv_emp / floor).max().item(),
           'share_under_2_floors': (tv < 2 * floor).double().mean().item(),
           'scheme_worst_ratio_to_floor': (tv_scheme / floor).max().item(),
           'scheme_share_under_2_floors':
               (tv_scheme < 2 * floor).double().mean().item()}
    emit(rec)
    got, ref = rec['tv_int8_vs_bf16'], rec['tv_int8_f32_vs_f32']
    for key in ('mean', 'p95'):
        check(got[key] <= 1.25 * ref[key],
              f'unet int8 TV: the int8 line is {got[key]} ({key}) from the '
              f'bf16 line, past 1.25 x the scheme\'s own {ref[key]}')


# ---------------------------------------------------------------------------
# The UNet training path: CIFAR10 UDLM with cond dropout
# ---------------------------------------------------------------------------

def check_tiny_unet_train():
    """`unet_train_flagship(tiny=True)`'s model in float32 (weights + 0.05
    seeded noise, dropout 0) with the training run's optimizer and EMA,
    card against CPU (`_train_step_card_vs_cpu`): the plain GroupNorms
    under autograd and cuDNN's convolutions on the card, their CPU
    counterparts. Bars: each gradient to 1e-3 of its largest magnitude,
    the attention key biases' gradients, zero but for rounding, against
    their key matrices' gradients, and the loss to 1e-4 relative (8x the
    card's measured 1.2e-5). The UNet's loss and gradients pass through many more
    transcendental outputs than the DiT's (the sinusoidal time embedding at
    arguments up to ~1e3, the GroupNorms' rsqrt and SiLU, the logistic
    head's cancelling tail log1p(-exp(b - a) + 1e-6), b ~ a), where the
    card's and the CPU's math libraries differ by ulps; on the CPU an ulp
    of jitter in those outputs moves the gradients by up to 2.4e-3 of
    their largest magnitude and the loss by up to 1.2e-4 relative, against
    under 1e-4 for half an ulp in the weights (`_half_ulp_bars`). Runs on
    the card measured card-against-CPU gradients up to 3.0e-4 of their
    largest magnitude (GroupNorm scales, conv weights) and the loss 1.2e-5
    relative apart; with the logistic head evaluated in float64 on both
    sides, 1.3e-5 and 4e-7 (cuDNN off, or the time embedding in float64,
    changed nothing): the head's float32 transcendentals are the cause. A
    wrong gradient moves by O(1)."""
    import dataclasses
    from ddg_tpu_torch.diffusion import sample_corruption
    from ddg_tpu_torch.entry import unet_train_flagship
    from ddg_tpu_torch.models import UNet
    run = unet_train_flagship(device='cpu', tiny=True)
    cfg = dataclasses.replace(run.cfg, compute_dtype=torch.float32,
                              dropout=0.0)
    gen = torch.Generator().manual_seed(9)
    sd = {k: v.float() + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in run.model.state_dict().items()}
    data = run.batch(gen)
    x0, cond = data['input_ids'][0], data['cond'][0]
    t, xt = sample_corruption(run.spec, x0, gen)
    optim = dataclasses.replace(run.optim, num_warmup_steps=0)
    # The attention key biases' gradients are zero but for rounding (the
    # softmax over keys ignores q . b_k).
    zero = {k: k[:-1] + 'W' for k in sd if k.endswith('.k.b')}
    rec = _train_step_card_vs_cpu('tiny UNet train', lambda: UNet(cfg), sd,
                                  run.spec, (x0, t, xt, cond), optim,
                                  run.averaging,
                                  grad_bars={k: 1e-3 for k in sd},
                                  zero_grads=zero, loss_rtol=1e-4)
    emit({'phase': 'tiny_unet_train_card_vs_cpu', **rec})


def run_unet_train_path(kernels, warmup=1, steps=2):
    """The CIFAR10 UNet training run at full width and depth
    (`unet_train_flagship()`: global batch 512 images as micro-batches):
    `warmup` steps, then `steps` timed ones (ms/step, images/s, tokens/s,
    peak memory, loss, grad norm); no kernel of the port on this path (the
    GroupNorms run their plain version under autograd: 0 K13), 0 host
    syncs in a step, and the card's busy and idle share over one profiled
    step. Returns the launches."""
    from ddg_tpu_torch.entry import unet_train_flagship
    t0 = time.perf_counter()
    run = unet_train_flagship(device=DEV)
    cfg = run.cfg
    emit({'phase': 'unet_train_flagship', 'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in run.apply_fn.params.values()),
          'ch': cfg.ch, 'ch_mult': list(cfg.ch_mult),
          'num_res_blocks': cfg.num_res_blocks, 'dropout': cfg.dropout,
          'image_size': cfg.image_size, 'global_batch': run.global_batch,
          'micro_batch': run.micro_batch, 'accum_steps': run.accum_steps})
    batch = run.batch(torch.Generator(device=DEV).manual_seed(1))
    for _ in range(warmup):
        run.step(run.state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = [run.step(run.state, batch)[1] for _ in range(steps)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    _launch_check('unet training', kernels, launches, {},
                  steps * run.accum_steps)
    n_syncs = _sync_check('unet training', lambda: run.step(run.state, batch))
    busy, span, lead = device_busy_ms(lambda: run.step(run.state, batch))
    loss = [m['loss'].item() for m in metrics]
    gnorm = [m['grad_norm'].item() for m in metrics]
    emit({'phase': 'unet_train_main_path', 'steps': steps,
          'ms_per_step': secs * 1e3,
          'images_per_s': run.global_batch / secs,
          'tokens_per_s': run.global_batch * cfg.length / secs,
          'peak_memory_bytes': peak, 'loss': loss, 'grad_norm': gnorm,
          'lr': metrics[-1]['lr'].item(),
          'profiled_busy_ms': busy, 'profiled_span_ms': span,
          'profiled_lead_ms': lead, 'idle_share': 1.0 - busy / span,
          'k13_launches': launches['fused_group_norm_act'],
          'host_syncs_in_a_step': n_syncs})
    check(all(math.isfinite(v) for v in loss + gnorm),
          'unet training: non-finite loss or grad norm')
    return launches


def check_unet_learning(micro_steps=30):
    """At full width, one micro-batch of class-pattern images
    (`entry.class_pattern_images`) repeated, the run's lr 2e-4 with no
    warmup: the mean loss of the last 5 steps at least 10% below the first
    5 (check_learning's bar)."""
    import dataclasses
    from ddg_tpu_torch.entry import class_pattern_images, unet_train_flagship
    from ddg_tpu_torch.runtime.train_state import (init_train_state,
                                                   make_train_step)
    run = unet_train_flagship(device=DEV, seed=2)
    optim = dataclasses.replace(run.optim, num_warmup_steps=0)
    state = init_train_state(torch.Generator(device=DEV).manual_seed(3),
                             run.apply_fn.params, optim, run.averaging)
    step = make_train_step(run.spec, run.apply_fn, optim, run.averaging)
    gen = torch.Generator(device=DEV).manual_seed(4)
    cond = torch.randint(0, run.cfg.num_classes, (run.micro_batch,),
                         generator=gen, device=DEV, dtype=torch.int32)
    ids = class_pattern_images(cond, gen, image_size=run.cfg.image_size)
    batch = {'input_ids': ids, 'cond': cond,
             'attention_mask': torch.ones(ids.shape, device=DEV)}
    t0 = time.perf_counter()
    losses = torch.stack([step(state, batch)[1]['loss']
                          for _ in range(micro_steps)]).tolist()
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    emit({'phase': 'unet_learning_check', 'steps': micro_steps,
          'micro_batch': run.micro_batch,
          'seconds': time.perf_counter() - t0, 'loss_first5': first,
          'loss_last5': last, 'drop': 1 - last / first, 'losses': losses})
    check(all(math.isfinite(v) for v in losses),
          'unet learning: non-finite loss')
    check(last <= 0.9 * first, f'unet learning: loss fell from {first} to '
                               f'{last}, less than 10%')


# ---------------------------------------------------------------------------
# Classifier-based guidance: QM9 D-CBG (exact and first-order), LM1B NOS
# and the classifier's training
# ---------------------------------------------------------------------------

# The JAX default suite's guided lines (`bench.py:270-390, 906-908`): B and
# T of `cbg` / `cbg_approx` (QM9, chunk 128) and of `nos` (LM1B, one
# Adagrad step).
QM9_B, QM9_STEPS, QM9_CHUNK = 16, 32, 128
NOS_B, NOS_STEPS, NOS_INNER = 16, 128, 1
CLF_TRAIN_B, CLF_TRAIN_STEPS, CLF_TRAIN_LR = 256, 40, 3e-3


def check_tiny_classifier():
    """A tiny float32 DiT classifier (fused flags, 2 blocks of 2 heads of 64,
    L=32, V=36) on the card against the same weights on the CPU, where the
    plain versions run: logits over indices, one-hots and `x_emb` to the
    BASELINE 1e-3 bar, and one CBG first-order term (`samplers.
    _cbg_first_order`: the gradient in the one-hot, through K1b, K4 and K6)
    to 1e-3 of its largest magnitude."""
    import numpy as np
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.convert import make_reference_dit_classifier_state_dict
    from ddg_tpu_torch.models import (DITClassifier, DITConfig,
                                      make_classifier_apply)
    Vt, Lt = 36, 32
    cfg = DITConfig(hidden_size=128, cond_dim=32, length=Lt, n_blocks=2,
                    n_heads=2, vocab_size=Vt, dropout=0.0,
                    compute_dtype=torch.float32, fused_rope_attn=True,
                    fused_adaln=True)
    sd = make_reference_dit_classifier_state_dict(
        np.random.RandomState(5), hidden=128, cond_dim=32, n_blocks=2,
        vocab=Vt)
    sd = {k: v * 10 if v.ndim == 2 else v for k, v in sd.items()}
    gen = torch.Generator().manual_seed(6)
    x = torch.randint(0, Vt, (4, Lt), generator=gen, dtype=torch.int32)
    sigma = torch.rand((4,), generator=gen)
    emb = torch.randn((4, Lt, 128), generator=gen)
    outs = {}
    for dev in ('cpu', DEV):
        m = DITClassifier(cfg)
        m.load_state_dict(sd, strict=True)
        apply = make_classifier_apply(m.to(dev).eval())
        xd, sd_ = x.to(dev), sigma.to(dev)
        outs[dev] = [apply(apply.params, xd, sd_).cpu(),
                     apply(apply.params, torch.nn.functional.one_hot(
                         xd.long(), Vt).float(), sd_).cpu(),
                     apply(apply.params, xd, sd_, emb.to(dev)).cpu(),
                     SM._cbg_first_order(apply, apply.params, xd, sd_, 1,
                                         Vt).cpu()]
    errs = [(a - b).abs().max().item() for a, b in zip(outs['cpu'],
                                                       outs[DEV])]
    grad_scale = outs['cpu'][3].abs().max().item()
    emit({'phase': 'tiny_classifier_card_vs_cpu', 'length': Lt,
          'logits_max_abs_err': errs[:3], 'first_order_max_abs_err': errs[3],
          'first_order_scale': grad_scale,
          'logit_std': outs['cpu'][0].std().item()})
    for name, err in zip(('indices', 'one-hots', 'x_emb'), errs):
        check(err < 1e-3, f'tiny classifier {name}: card vs CPU logits '
                          f'differ by {err}')
    check(errs[3] <= 1e-3 * grad_scale,
          f'tiny classifier: the first-order CBG term differs by {errs[3]} '
          f'(scale {grad_scale})')
    check(all(bool(torch.isfinite(o).all()) for o in outs[DEV]),
          'tiny classifier: non-finite outputs on the card')


def _guided_run(name, kernels, sample, batch, steps, per_step, vocab, mask,
                line, extra=None):
    """One timed run of `sample(batch, steps, seed)` after a two-step
    warm-up: samples/s, ms/step, peak memory and the launches, which must
    be exactly `per_step` a step (every other kernel none); then a two-step
    run under PyTorch's sync debug mode, which must not wait for the card.
    Returns the launches and the tokens."""
    sample(batch, 2, 99)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x = sample(batch, steps, 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_syncs = _sync_check(name, lambda: sample(batch, 2, 7))
    n_mask = int((x == mask).sum().item())
    emit({'phase': 'guided_path', 'run': name, 'batch': batch,
          'steps': steps, 'jax_line': line, 'seconds': secs,
          'samples_per_s': batch / secs, 'ms_per_step': secs / steps * 1e3,
          'peak_memory_gb': peak / 1e9,
          'launches_per_step': {k: v / steps for k, v in launches.items()
                                if v},
          'host_syncs_in_2_steps': n_syncs, 'mask_tokens_left': n_mask,
          'distinct_tokens': int(torch.unique(x).numel()), **(extra or {})})
    check(tuple(x.shape) == (batch, x.shape[1]) and x.dtype == torch.int32,
          f'{name}: output {tuple(x.shape)} {x.dtype}')
    check(bool(((x >= 0) & (x < vocab)).all()), f'{name}: token outside '
                                                 '[0, V)')
    check(n_mask <= math.ceil(5 * x.numel() / 8192),
          f'{name}: {n_mask} mask tokens left')
    _launch_check(name, kernels, launches, per_step, steps)
    return launches, x


def _qm9_models(approx, clf_weights=None):
    """The QM9 flagship, its classifier's weights replaced by
    `clf_weights` (float32, by name) when given."""
    from ddg_tpu_torch.entry import qm9_cbg_flagship
    t0 = time.perf_counter()
    out = qm9_cbg_flagship(device=DEV, approx=approx)
    spec, cfg, clf_cfg, _, params, _, clf_params = out
    if clf_weights is not None:
        with torch.no_grad():
            for k, v in clf_params.items():
                v.copy_(clf_weights[k])
    emit({'phase': 'qm9_cbg_flagship', 'approx': approx,
          'seconds': time.perf_counter() - t0,
          'denoiser_parameters': sum(p.numel() for p in params.values()),
          'classifier_parameters': sum(p.numel()
                                       for p in clf_params.values()),
          'length': cfg.length, 'vocab': cfg.vocab_size,
          'denoiser': [cfg.hidden_size, cfg.n_blocks, cfg.n_heads],
          'classifier': [clf_cfg.hidden_size, clf_cfg.n_blocks,
                         clf_cfg.n_heads]})
    return out


def _class1_share(x, vocab):
    """The share of tokens in class 1's half of `_class_batch`'s vocabulary
    (the upper half of [0, V-1))."""
    return ((x >= (vocab - 1) // 2) & (x < vocab - 1)).float().mean().item()


def run_cbg_path(kernels, clf_weights=None, approx=False, steps=QM9_STEPS):
    """The JAX suite's `cbg` line (`approx=False`: every one of the L V
    single-token edits scored a step, in chunks of QM9_CHUNK, each one
    classifier forward of B QM9_CHUNK rows) or `cbg_approx` (one classifier
    forward and backward to the one-hot a step): D-CBG gamma 2, condition 1,
    on the QM9 flagship at B=16, T=32, `use_cache=False`. Exact launches a
    step: the denoiser's 12 K1, 13 K3, 12 K5 and the classifier's 8 of each
    per forward (9 forwards exact), plus 8 K1b, K4, K6 first-order; 0 host
    syncs. The exact run then takes 4 steps with the NFE cache, which waits
    for the card once a step (its validity flag). With `clf_weights`, the
    classifier trained by `run_classifier_train_path` (class 1: tokens of
    the upper half of the vocabulary), the guidance must show: the share
    of class 1's tokens in the samples must rise above that of unguided
    samples of the same seed (the same noise: without guidance, the same
    tokens) by at least 0.03 (the full-width first-order run on the CPU,
    float32, went 0.523 -> 0.588)."""
    from ddg_tpu_torch import samplers as SM
    (spec, cfg, clf_cfg, apply_fn, params, clf_apply,
     clf_params) = _qm9_models(approx, clf_weights)
    guidance = SM.GuidanceSpec(method='cbg', gamma=GAMMA, condition=1,
                               use_approx=approx, cbg_chunk=QM9_CHUNK)

    def sample(batch, n_steps, seed, use_cache=False, guide=guidance):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return SM.diffusion_sample(
            spec, SM.SamplerSpec(steps=n_steps, use_cache=use_cache),
            apply_fn, params, gen, batch_size=batch, length=cfg.length,
            guidance=guide, classifier_apply=clf_apply,
            classifier_params=clf_params)

    den, blk = cfg.n_blocks, clf_cfg.n_blocks
    if approx:
        per_step = {'fused_rope_attention': den + blk,
                    'ln_modulate': den + 1 + blk,
                    'gate_res_ln_modulate': den + blk,
                    'fused_rope_attention_bwd': blk,
                    'ln_modulate_bwd': blk, 'gate_res_ln_modulate_bwd': blk}
        check(list(per_step.values()) == [20, 21, 20, 8, 8, 8],
              f'cbg_approx: {per_step} a step')
    else:
        chunks = -(-cfg.length * cfg.vocab_size // QM9_CHUNK)
        per_step = {'fused_rope_attention': den + blk * chunks,
                    'ln_modulate': den + 1 + blk * chunks,
                    'gate_res_ln_modulate': den + blk * chunks}
        check(chunks == 9 and list(per_step.values()) == [84, 85, 84],
              f'cbg: {chunks} chunks, {per_step} a step')
    name = 'cbg_approx' if approx else 'cbg'
    mode = 'approx' if approx else f'exact, chunk={QM9_CHUNK}'
    launches, x = _guided_run(
        name, kernels, sample, QM9_B, steps, per_step, cfg.vocab_size,
        spec.mask_index, f'QM9 D-CBG samples/sec/chip ({mode}, T={steps}, '
        f'B={QM9_B}, DiT-small + tiny-classifier)')
    if clf_weights is not None:
        share = {'guided': _class1_share(x, cfg.vocab_size),
                 'unguided': _class1_share(sample(QM9_B, steps, 1,
                                                  guide=None),
                                           cfg.vocab_size)}
        emit({'phase': 'guided_path_class1_share', 'run': name, **share})
        check(share['guided'] >= share['unguided'] + 0.03,
              f'{name}: the guidance moved the share of class 1 tokens '
              f'from {share["unguided"]} to {share["guided"]} only')
    if not approx:
        n = 4
        n_syncs = _sync_check('cbg_nfe_cache', lambda: sample(
            QM9_B, n, 5, use_cache=True), expect=n)
        emit({'phase': 'guided_path_host_syncs', 'run': 'cbg_nfe_cache',
              'batch': QM9_B, 'steps': n, 'host_syncs': n_syncs,
              'expected': n})
    return launches


def run_nos_path(kernels, steps=NOS_STEPS):
    """The JAX suite's `nos` line: the LM1B flagship with the head-only
    mean-pooling classifier (`entry.nos_flagship`), NOS with one Adagrad
    step (size 0.1, stability 0.01), condition 1, B=16, T=128. Exact
    launches a step: 12 K1 and 12 K5 (the trunk once), K3 13 + n + 1 and
    K4 n (the head forward in the trunk's pass, each inner step's head
    forward and backward, the guided head) at n = 1; 0 host syncs."""
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.entry import nos_flagship
    t0 = time.perf_counter()
    spec, cfg, apply_fn, params, clf_apply, clf_params = nos_flagship(
        device=DEV)
    emit({'phase': 'nos_flagship', 'seconds': time.perf_counter() - t0,
          'classifier_parameters': sorted(clf_params)})
    guidance = SM.GuidanceSpec(method='nos', condition=1,
                               num_nos_steps=NOS_INNER, nos_step_size=0.1,
                               nos_stability_coef=0.01)

    def sample(batch, n_steps, seed, guide=guidance):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        return SM.diffusion_sample(
            spec, SM.SamplerSpec(steps=n_steps, use_cache=False), apply_fn,
            params, gen, batch_size=batch, length=cfg.length,
            guidance=guide, classifier_apply=clf_apply,
            classifier_params=clf_params)

    n = NOS_INNER
    per_step = {'fused_rope_attention': cfg.n_blocks,
                'gate_res_ln_modulate': cfg.n_blocks,
                'ln_modulate': cfg.n_blocks + 1 + n + 1,
                'ln_modulate_bwd': n}
    check(list(per_step.values()) == [12, 12, 15, 1],
          f'nos: {per_step} a step')
    launches, _ = _guided_run(
        'nos', kernels, sample, NOS_B, steps, per_step, cfg.vocab_size,
        spec.mask_index, f'LM1B NOS samples/sec/chip (T={steps}, B={NOS_B}, '
        f'nos_steps={n}, DiT-small)')
    return launches


def _class_batch(gen, batch, length, vocab):
    """A class-structured batch (no dataset): rows of class 0 with tokens
    uniform over the lower half of [0, V-1), rows of class 1 over the
    upper half, alternating (the loss's antithetic t rises with the row,
    so the classes must not follow the row order)."""
    split = (vocab - 1) // 2
    label = torch.arange(batch, device=DEV) % 2
    lo = torch.randint(0, split, (batch, length), generator=gen, device=DEV)
    hi = torch.randint(split, vocab - 1, (batch, length), generator=gen,
                       device=DEV)
    return {'input_ids': torch.where(label[:, None] == 1, hi, lo).int(),
            'attention_mask': torch.ones((batch, length), device=DEV),
            'label': label.int()}


def run_classifier_train_path(kernels, steps=CLF_TRAIN_STEPS, timed_from=2):
    """`classifier.make_classifier_train_step` on the QM9 flagship's tiny
    classifier (hidden 512, 8 blocks, L=32, V=36) with the tiny-classifier
    config's dropout 0.1, noisy inputs under the flagship's absorbing
    schedule with time conditioning, AdamW lr 3e-3 without warmup, EMA
    0.9999, on one seeded class-structured batch of 256 (`_class_batch`):
    `steps` steps, exact launches (8 each of K1, K3, K5, K1b, K4, K6 a
    step), ms a step over the steps from `timed_from`, then one step under
    the sync debug mode (0 host syncs). The learning check of
    `tests/test_classifier.py:62-73`: the mean loss of the last 5 steps at
    least 10% below the first 5's, and the last step's accuracy above
    0.9. Returns the launches and the trained weights (float32, by
    name)."""
    import dataclasses
    from ddg_tpu_torch.classifier import (ClassifierSpec,
                                          make_classifier_train_step)
    from ddg_tpu_torch.entry import qm9_cbg_flagship
    from ddg_tpu_torch.models import DITClassifier, make_classifier_apply
    from ddg_tpu_torch.runtime.averaging import AveragingSpec
    from ddg_tpu_torch.runtime.optim import OptimSpec
    from ddg_tpu_torch.runtime.train_state import init_train_state
    spec, _, clf_cfg, _, _, _, clf_params = qm9_cbg_flagship(device=DEV)
    clf_cfg = dataclasses.replace(clf_cfg, dropout=0.1)
    clf = DITClassifier(clf_cfg)
    clf.load_state_dict(clf_params, strict=True)
    apply = make_classifier_apply(clf.to(DEV).train())
    cspec = ClassifierSpec(diffusion=spec.diffusion,
                           parameterization=spec.parameterization,
                           noise=spec.noise, vocab_size=spec.vocab_size,
                           mask_index=spec.mask_index, num_classes=2,
                           time_conditioning=True)
    optim = OptimSpec(lr=CLF_TRAIN_LR, num_warmup_steps=0)
    avg = AveragingSpec.ema(0.9999)
    state = init_train_state(torch.Generator(device=DEV).manual_seed(8),
                             apply.params, optim, avg)
    step = make_classifier_train_step(cspec, apply, optim, avg)
    batch = _class_batch(torch.Generator(device=DEV).manual_seed(9),
                         CLF_TRAIN_B, clf_cfg.length, clf_cfg.vocab_size)
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    for i in range(steps):
        if i == timed_from:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        metrics.append(step(state, batch)[1])
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / (steps - timed_from)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_syncs = _sync_check('classifier_training', lambda: step(state, batch))
    losses = torch.stack([m['loss'] for m in metrics]).tolist()
    acc = torch.stack([m['accuracy'] for m in metrics]).tolist()
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    blk = clf_cfg.n_blocks
    emit({'phase': 'classifier_train_path', 'steps': steps,
          'batch': CLF_TRAIN_B, 'length': clf_cfg.length,
          'ms_per_step': secs * 1e3,
          'tokens_per_s': CLF_TRAIN_B * clf_cfg.length / secs,
          'peak_memory_gb': peak / 1e9,
          'launches_per_step': {k: v / steps for k, v in launches.items()
                                if v},
          'host_syncs_in_a_step': n_syncs, 'loss_first5': first,
          'loss_last5': last, 'drop': 1 - last / first,
          'accuracy_last': acc[-1], 'losses': losses, 'accuracy': acc})
    _launch_check('classifier_training', kernels, launches,
                  {k: blk for k in ('fused_rope_attention', 'ln_modulate',
                                    'gate_res_ln_modulate',
                                    'fused_rope_attention_bwd',
                                    'ln_modulate_bwd',
                                    'gate_res_ln_modulate_bwd')}, steps)
    check(all(math.isfinite(v) for v in losses),
          'classifier training: non-finite loss')
    check(last <= 0.9 * first, f'classifier training: loss fell from '
                               f'{first} to {last}, less than 10%')
    check(acc[-1] > 0.9, f'classifier training: accuracy {acc[-1]} after '
                         f'{steps} steps')
    return launches, state.params


# AR decoding: K1 and K1b, causal, at the AR paths' shapes: the QM9
# AR denoiser's 12 heads of 64 at B=16, L=32 (FUDGE's and PPLM's trunk), the
# FUDGE classifier over B x topk = 320 candidate rows, and its training
# batch of 256 (forward and backward). (label: (shape, kernels)); the
# records go under each label, timed causal.
AR_ATTENTION = {
    'ar_qm9_denoiser': ((16, 32, 12, 64), ('fused_rope_attention',)),
    'ar_fudge_classifier': ((320, 32, 12, 64), ('fused_rope_attention',)),
    'ar_fudge_classifier_training': ((256, 32, 12, 64), (
        'fused_rope_attention', 'fused_rope_attention_bwd'))}
AR_LABELS = tuple(AR_ATTENTION)


def _causal_attention_bound(name, shape, es):
    """`_attention_bound` for causal attention: the products over the
    L (L + 1) / 2 query-key pairs a head that the mask keeps."""
    nb, Lq, Hq, Dq = shape
    tensors, products = (7, 5) if name.endswith('_bwd') else (4, 2)
    tables = 2 * Lq * (Dq // 2) * 4
    return bound(tensors * nb * Lq * Hq * Dq * es + tables,
                 2 * products * nb * Hq * (Lq * (Lq + 1) // 2) * Dq,
                 PEAK_BF16_TENSOR)


def check_ar_attention(results):
    """K1 and K1b, causal, at AR_ATTENTION's shapes against their plain
    versions in fp32 and bf16 (the backward twice, bit-identical), the bf16
    forward rerun bit-identical; in bf16 timed beside the plain version and
    causal SDPA (its backward: autograd through causal SDPA minus its
    forward), with the bound of the pairs the mask keeps."""
    from ddg_tpu_torch.ops import attention as A
    gen = torch.Generator(device=DEV).manual_seed(14)
    for label, (shape, names) in AR_ATTENTION.items():
        for dtype in (torch.float32, torch.bfloat16):
            es = torch.tensor([], dtype=dtype).element_size()
            cases, sdpa, do = _attention_cases(shape, dtype, gen)
            for name in names:
                call, plain = cases[name]
                rec = {'shape': list(shape), 'causal': True, 'err': 0.0}
                wrapper = getattr(A, name)
                before = (wrapper.launches, wrapper.tensor_core_launches)
                bwd = name.endswith('_bwd')
                if bwd:
                    _bwd_case(rec, f'{name} {label}', dtype,
                              (('dq', 'row'), ('dk', 'row'), ('dv', 'row')),
                              lambda: call(True), lambda: plain(True),
                              differs_bar=(BWD_DIFFERS_BAR
                                           if dtype == torch.bfloat16
                                           else None))
                else:
                    out, ref = call(True), plain(True)
                    rec['err'], rec['tol'] = _close(f'{name} {label}', dtype,
                                                    out, ref)
                    check(torch.equal(out, call(True)),
                          f'{name} {label}: a rerun differs')
                calls = wrapper.launches - before[0]
                rec['tensor_cores'] = (wrapper.tensor_core_launches
                                       - before[1] == calls)
                if dtype == torch.bfloat16:
                    check(rec['tensor_cores'], f'{name} {label}: bf16 at '
                                               'D=64 missed the tensor cores')
                    rec['ms'] = time_ms(lambda: call(True))
                    rec['plain_ms'] = time_ms(lambda: plain(True), reps=10)
                    rec['library_ms'] = _sdpa_ms(sdpa, do, bwd, causal=True)
                    rec['library'] = ('causal SDPA backward (autograd '
                                      'through SDPA minus its forward)'
                                      if bwd else 'causal SDPA')
                    rec['bound_ms'], rec['bound_by'] = \
                        _causal_attention_bound(name, shape, es)
                results[name].setdefault(label, {})[str(dtype)] = rec


def _decode_logits(decode, cfg, params, cache, tokens, cond=None):
    """Teacher-forced decode of `tokens` (B, n): float32 logits (B, n, V)
    of every step."""
    out = []
    for pos in range(tokens.shape[1]):
        out.append(decode(cfg, params, cache, tokens[:, pos], pos,
                          cond=cond)[0])
    return torch.stack(out, 1)


def check_tiny_ar():
    """Tiny float32 AR models on the card against the same weights on the
    CPU, where the plain versions run:
    - a causal DiT (hidden 128, 2 blocks of 2 heads of 64, L=24, V=40, 2
      classes, matrices x5): the KV-cache decode's logits of every step
      with a class, on the float and the int8 cache, card against CPU to
      1e-4 of their largest magnitude (float) and 2% of it (int8, whose
      codes may flip where x / scale lies within float error of a half:
      at most 0.1% of them, by one code); the card's decode against the
      card's full causal forward (K1, K3, K5) at `tests/test_dit_decode.py`'s
      bar; `ar_sample` on the card gives the same tokens through the KV
      cache and the full forward from one generator (D-CFG gamma 2, B=4);
    - the unidirectional DiMamba (hidden 32, 2 blocks, d_state 16, L=256,
      matrices x4): the decode's logits over 64 steps card against CPU to
      1e-4 of their largest magnitude, and against the card's full
      unidirectional forward (K18) at every one of the 256 positions at
      `tests/test_dimamba_decode.py`'s bar; the gap of the same weights
      held in bf16 (the port's mixer dtype at the flagship) against float32,
      recorded."""
    import dataclasses
    import numpy as np
    from ddg_tpu_torch import samplers as SM
    from ddg_tpu_torch.convert import (dimamba_params_from_reference,
                                       dimamba_state_dict_from_jax,
                                       make_reference_dimamba_state_dict,
                                       make_reference_dit_state_dict)
    from ddg_tpu_torch.diffusion import DiffusionSpec
    from ddg_tpu_torch.models import (DIT, DiMamba, DiMambaConfig,
                                      DITConfig, make_model_apply)
    from ddg_tpu_torch.models import dimamba_decode, dit_decode
    from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise
    Lt, Vt, Bt = 24, 40, 4
    cfg = DITConfig(hidden_size=128, cond_dim=32, length=Lt, n_blocks=2,
                    n_heads=2, vocab_size=Vt, dropout=0.0, causal=True,
                    num_classes=2, compute_dtype=torch.float32,
                    fused_rope_attn=True, fused_adaln=True)
    sd = make_reference_dit_state_dict(
        np.random.RandomState(21), hidden=128, cond_dim=32, n_blocks=2,
        vocab=Vt, with_cond=True, causal=True)
    sd = {k: v * 5 if v.ndim == 2 else v for k, v in sd.items()}
    gen = torch.Generator().manual_seed(22)
    x = torch.randint(0, Vt, (Bt, Lt), generator=gen, dtype=torch.int32)
    cond = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    rec, outs, applies = {}, {}, {}
    for dev in ('cpu', DEV):
        m = DIT(cfg)
        m.load_state_dict(sd, strict=True)
        applies[dev] = make_model_apply(m.to(dev).eval())
        for kv_int8 in (False, True):
            cache = dit_decode.init_cache(cfg, Bt, kv_int8=kv_int8,
                                          device=dev)
            with torch.no_grad():
                logits = _decode_logits(dit_decode.decode_step, cfg,
                                        applies[dev].params, cache,
                                        x.to(dev), cond.to(dev))
            outs[dev, kv_int8] = (logits.cpu(),
                                  {k: v.cpu() for k, v in cache.items()})
    ref = outs['cpu', False][0]
    scale = ref.abs().max().item()
    rec['dit_decode_err'] = (outs[DEV, False][0] - ref).abs().max().item()
    check(rec['dit_decode_err'] <= FP32_TOL * max(1.0, scale),
          f'tiny AR DiT: the decode differs card against CPU by '
          f'{rec["dit_decode_err"]} (scale {scale})')
    codes = 0.0
    for name in ('k', 'v'):
        d = (outs[DEV, True][1][name].int()
             - outs['cpu', True][1][name].int()).abs()
        check(d.max().item() <= 1, f'tiny AR DiT: int8 {name} codes differ '
                                   f'by {d.max().item()}')
        codes = max(codes, (d > 0).float().mean().item())
    rec['int8_codes_differing'] = codes
    check(codes <= 1e-3, f'tiny AR DiT: {codes} of the int8 codes differ '
                         'card against CPU')
    rec['dit_decode_int8_err'] = (outs[DEV, True][0]
                                  - outs['cpu', True][0]).abs().max().item()
    check(rec['dit_decode_int8_err'] <= 0.02 * scale,
          f'tiny AR DiT: the int8 decode differs card against CPU by '
          f'{rec["dit_decode_int8_err"]}')
    with torch.no_grad():
        full = applies[DEV](applies[DEV].params, x.to(DEV), None,
                            cond.to(DEV)).float().cpu()
    dec = outs[DEV, False][0]
    excess = ((dec - full).abs() - (2e-4 + 1e-3 * full.abs())).max().item()
    rec['dit_decode_vs_full_err'] = (dec - full).abs().max().item()
    check(excess <= 0, f'tiny AR DiT: the card\'s decode differs from its '
                       f'full forward by {rec["dit_decode_vs_full_err"]}')
    spec = DiffusionSpec(diffusion='absorbing_state', parameterization='ar',
                         noise=LogLinearNoise(), vocab_size=Vt,
                         mask_index=Vt - 1, num_classes=2)
    tokens = [SM.ar_sample(
        spec, SM.SamplerSpec(), applies[DEV], applies[DEV].params,
        torch.Generator(device=DEV).manual_seed(23), batch_size=Bt,
        length=Lt, bos_token_id=0,
        guidance=SM.GuidanceSpec(method='cfg', gamma=GAMMA),
        cond=torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=DEV),
        decode_cfg=c) for c in (cfg, None)]
    check(torch.equal(tokens[0], tokens[1]),
          'tiny AR DiT: KV-cache tokens differ from full-forward tokens on '
          'the card')
    rec['kv_tokens_equal_full_forward'] = True

    mcfg = DiMambaConfig(hidden_size=32, cond_dim=16, length=256, n_blocks=2,
                         vocab_size=12, d_state=16, d_conv=4, expand=2,
                         bidirectional=False, dropout=0.0,
                         compute_dtype=torch.float32)
    ref_sd = make_reference_dimamba_state_dict(
        np.random.RandomState(24), hidden=32, cond_dim=16, n_blocks=2,
        vocab=12, bidirectional=False)
    msd = dimamba_state_dict_from_jax(dimamba_params_from_reference(
        ref_sd, n_blocks=2, bidirectional=False), n_blocks=2)
    msd = {k: v * 4 if v.ndim == 2 else v for k, v in msd.items()}
    xm = torch.randint(7, 12, (Bt, 256), generator=gen, dtype=torch.int32)

    def mamba_decode(c, dev, n):
        m = DiMamba(c)
        m.load_state_dict(msd, strict=True)
        apply = make_model_apply(m.to(dev).eval())
        cache = dimamba_decode.init_cache(c, Bt, device=dev)
        with torch.no_grad():
            out = _decode_logits(
                lambda cf, p, ca, t, pos, cond: dimamba_decode.decode_step(
                    cf, p, ca, t, cond=cond),
                c, dimamba_decode.precast(apply.params), cache,
                xm[:, :n].to(dev))
        return out.cpu(), apply

    on_cpu, _ = mamba_decode(mcfg, 'cpu', 64)
    on_card, apply = mamba_decode(mcfg, DEV, 256)
    mscale = on_cpu.abs().max().item()
    rec['dimamba_decode_err'] = (on_card[:, :64] - on_cpu).abs().max().item()
    check(rec['dimamba_decode_err'] <= FP32_TOL * max(1.0, mscale),
          f'tiny AR DiMamba: the decode differs card against CPU by '
          f'{rec["dimamba_decode_err"]}')
    with torch.no_grad():
        full = apply(apply.params, xm.to(DEV), None).float().cpu()
    excess = ((on_card - full).abs() - (2e-3 + 1e-2 * full.abs())).max()
    rec['dimamba_decode_vs_full_err'] = (on_card - full).abs().max().item()
    check(excess.item() <= 0, f'tiny AR DiMamba: the card\'s decode differs '
                              f'from its full forward (K18) by '
                              f'{rec["dimamba_decode_vs_full_err"]}')
    bf16, _ = mamba_decode(dataclasses.replace(
        mcfg, compute_dtype=torch.bfloat16), DEV, 256)
    rec['dimamba_bf16_weights_gap'] = (bf16 - on_card).abs().max().item()
    rec['dimamba_bf16_weights_gap_of_span'] = (
        rec['dimamba_bf16_weights_gap'] / on_card.abs().max().item())
    emit({'phase': 'tiny_ar_card_vs_cpu', 'logit_scale': scale,
          'dimamba_logit_scale': mscale, **rec})


def _ar_run(name, kernels, sample, per_step, steps, vocab, line,
            sync_sample=None, extra=None):
    """One timed AR run, `sample(batch, seed)` at the run's batch (None)
    after a warm-up: samples/s, ms a token step (`steps` of them), peak
    memory and the launches, which must be exactly `per_step` a step
    (every other kernel none); then `sync_sample()` (by default a 2-row
    run) under PyTorch's sync debug mode, which must not wait for the
    card. Returns (launches, tokens, seconds)."""
    sample(2, 99)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x = sample(None, 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    n_syncs = _sync_check(name, sync_sample or (lambda: sample(2, 7)))
    batch = x.shape[0]
    emit({'phase': 'ar_path', 'run': name, 'batch': batch,
          'length': x.shape[1], 'token_steps': steps, 'jax_line': line,
          'seconds': secs, 'samples_per_s': batch / secs,
          'ms_per_token_step': secs / steps * 1e3,
          'peak_memory_gb': peak / 1e9,
          'launches_per_step': {k: v / steps for k, v in launches.items()
                                if v},
          'host_syncs': n_syncs,
          'distinct_tokens': int(torch.unique(x).numel()), **(extra or {})})
    check(x.dtype == torch.int32 and x.shape[1] == steps + 1,
          f'{name}: output {tuple(x.shape)} {x.dtype}')
    check(bool(((x >= 0) & (x < vocab)).all()), f'{name}: token outside '
                                                '[0, V)')
    check(bool((x[:, 0] == 0).all()), f'{name}: position 0 is not bos')
    _launch_check(name, kernels, launches, per_step, steps)
    return launches, x, secs


def _ar_profile(name, run, length):
    """Busy ms, span ms and idle share a token step of `run.sample` over
    length - 1 steps at the run's batch, from one torch.profiler trace (the
    call's noise draw included), emitted."""
    busy, span, _ = device_busy_ms(lambda: run.sample(
        torch.Generator(device=DEV).manual_seed(3), length=length))
    n = length - 1
    emit({'phase': 'ar_path_profile', 'run': name, 'traced_steps': n,
          'busy_ms_per_step': busy / n, 'span_ms_per_step': span / n,
          'idle_share': 1 - busy / span})


def _score_precision_gap(run, x, rows=8):
    """The bf16 decode's logits against the float32 decode of the same
    weights (every parameter as float32, float32 compute and head), teacher
    forced on `rows` of the samples `x` with condition 0: max and mean
    absolute gap and the largest float32 logit."""
    import dataclasses
    from ddg_tpu_torch.models import dit_decode
    cfg32 = dataclasses.replace(run.cfg, compute_dtype=torch.float32,
                                logits_dtype=torch.float32)
    rows = min(rows, x.shape[0])
    cond = torch.zeros((rows,), dtype=torch.int32, device=DEV)
    out = []
    for cfg, params in ((run.cfg, dit_decode.precast(run.cfg, run.params)),
                        (cfg32, {k: v.float()
                                 for k, v in run.params.items()})):
        cache = dit_decode.init_cache(cfg, rows, device=DEV)
        with torch.no_grad():
            out.append(_decode_logits(dit_decode.decode_step, cfg, params,
                                      cache, x[:rows, :-1], cond))
    gap = (out[0] - out[1]).abs()
    return {'max_abs': gap.max().item(), 'mean_abs': gap.mean().item(),
            'logit_scale': out[1].abs().max().item(),
            'top1_agreement': (out[0].argmax(-1) == out[1].argmax(-1))
            .float().mean().item()}


def run_ar_path(kernels, int8_kv=False):
    """The JAX suite's `ar` line (`int8_kv`: `ar_int8`) at full width and
    length: `entry.ar_flagship()`, LM1B DiT-small as a causal AR model,
    D-CFG gamma 2 at B=256 through the KV-cache decode, 2B = 512 decode
    rows, 127 token steps in 4 length buckets: samples/s, ms a token step,
    peak memory, no launch of any K kernel (the decode is plain PyTorch,
    as `ddg_tpu`'s runs no Pallas kernel), 0 host syncs in a whole 2-row
    run, and the busy ms, span and idle share a step of a 16-step traced
    run at B=256. The bf16 run then records the decode's logit gap against
    the float32 decode of the same weights, and runs the same line through
    the full causal forward each step (`decode_cfg=None`: exactly 12 K1,
    13 K3 and 12 K5 a step at 2B rows), with the share of its tokens equal
    to the KV path's from the same seed (bf16 near-ties may differ).
    Returns {path: launches}."""
    import dataclasses
    from ddg_tpu_torch.entry import ar_flagship
    name = 'ar_int8' if int8_kv else 'ar'
    t0 = time.perf_counter()
    run = ar_flagship(device=DEV, int8_kv=int8_kv)
    emit({'phase': 'ar_flagship', 'int8_kv': int8_kv,
          'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in run.params.values()),
          'batch': run.batch_size, 'decode_rows': 2 * run.batch_size,
          'length': run.length, 'vocab': run.cfg.vocab_size,
          'buckets': run.sampler.ar_buckets})

    def sample(batch, seed, r=run):
        return r.sample(torch.Generator(device=DEV).manual_seed(seed),
                        batch_size=batch)

    steps = run.length - 1
    launches, x, _ = _ar_run(
        name, kernels, sample, {}, steps, run.cfg.vocab_size,
        'LM1B AR-CFG samples/sec/chip (KV-cache decode, B=256, DiT-small'
        + (', int8-kv)' if int8_kv else ')'))
    _ar_profile(name, run, 17)
    out = {name: launches}
    if int8_kv:
        return out
    emit({'phase': 'ar_score_precision', 'run': name,
          **_score_precision_gap(run, x)})
    full = dataclasses.replace(run, decode_cfg=None)
    trunk = {'fused_rope_attention': 12, 'ln_modulate': 13,
             'gate_res_ln_modulate': 12}
    out['ar_full_forward'], xf, _ = _ar_run(
        'ar_full_forward', kernels, lambda b, s: sample(b, s, full), trunk,
        steps, run.cfg.vocab_size,
        'none: the JAX line decodes through the KV cache')
    emit({'phase': 'ar_full_forward_vs_kv', 'tokens_equal_share':
          (xf == x).float().mean().item(),
          'rows_equal_share': (xf == x).all(1).float().mean().item(),
          'first_step_equal_share': (xf[:, 1] == x[:, 1]).float().mean()
          .item()})
    return out


# The FUDGE classifier's training before its guidance is checked: the
# reference's clean-prefix per-position protocol
# (`scripts/train_qm9_fudge_classifier.sh`) on a class-structured batch.
FUDGE_TRAIN_B, FUDGE_TRAIN_STEPS, FUDGE_TRAIN_LR = 256, 20, 1e-4
# Species10 AR decode positions run: the state is O(1) in L, so a step
# costs the same at any position; the run stops short of 32767.
DIMAMBA_AR_STEPS = 512


def _train_fudge_classifier(kernels, run, steps=FUDGE_TRAIN_STEPS):
    """`classifier.make_classifier_train_step` in FUDGE mode (clean
    prefixes, CE at every position against the sequence label) on the
    FUDGE flagship's classifier with the config's dropout 0.1, AdamW lr
    FUDGE_TRAIN_LR without warmup, on one seeded class-structured batch
    of 256 (`_class_batch`: class 0's tokens from the lower half of the
    vocabulary, class 1's from the upper): exactly 12 K1 and 12 K1b a step,
    0 host syncs, the mean loss of the last 5 steps at least 10% below the
    first 5's. Copies the trained weights into the run's classifier and
    returns the launches."""
    from ddg_tpu_torch.classifier import (ClassifierSpec,
                                          make_classifier_train_step)
    from ddg_tpu_torch.models import DITClassifier, make_classifier_apply
    from ddg_tpu_torch.runtime.averaging import AveragingSpec
    from ddg_tpu_torch.runtime.optim import OptimSpec
    from ddg_tpu_torch.runtime.train_state import init_train_state
    spec, cfg = run.spec, run.classifier_cfg
    clf = DITClassifier(cfg, num_classes=2, pooling='no_pooling')
    clf.load_state_dict(run.classifier_params, strict=True)
    apply = make_classifier_apply(clf.to(DEV).train())
    cspec = ClassifierSpec(diffusion=spec.diffusion,
                           parameterization=spec.parameterization,
                           noise=spec.noise, vocab_size=spec.vocab_size,
                           mask_index=spec.mask_index, num_classes=2,
                           is_fudge_classifier=True)
    optim = OptimSpec(lr=FUDGE_TRAIN_LR, num_warmup_steps=0)
    avg = AveragingSpec.ema(0.9999)
    state = init_train_state(torch.Generator(device=DEV).manual_seed(18),
                             apply.params, optim, avg)
    step = make_classifier_train_step(cspec, apply, optim, avg)
    batch = _class_batch(torch.Generator(device=DEV).manual_seed(19),
                         FUDGE_TRAIN_B, cfg.length, cfg.vocab_size)
    step(state, batch)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [step(state, batch)[1]['loss'] for _ in range(steps)]
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = {k: fn.launches for k, fn in kernels.items()}
    n_syncs = _sync_check('fudge_classifier_training',
                          lambda: step(state, batch))
    losses = torch.stack(losses).tolist()
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    emit({'phase': 'fudge_classifier_train_path', 'steps': steps,
          'batch': FUDGE_TRAIN_B, 'length': cfg.length,
          'ms_per_step': secs * 1e3,
          'tokens_per_s': FUDGE_TRAIN_B * cfg.length / secs,
          'launches_per_step': {k: v / steps for k, v in launches.items()
                                if v},
          'host_syncs_in_a_step': n_syncs, 'loss_first5': first,
          'loss_last5': last, 'losses': losses})
    _launch_check('fudge_classifier_training', kernels, launches,
                  {'fused_rope_attention': cfg.n_blocks,
                   'fused_rope_attention_bwd': cfg.n_blocks}, steps)
    check(all(math.isfinite(v) for v in losses),
          'FUDGE classifier training: non-finite loss')
    check(last <= 0.9 * first, f'FUDGE classifier training: loss fell from '
                               f'{first} to {last}, less than 10%')
    with torch.no_grad():
        for k, v in run.classifier_params.items():
            v.copy_(state.params[k])
    return launches


def _class_log_prob(run, x, condition):
    """The FUDGE classifier's mean log-probability of `condition` over the
    generated positions 1..L-1 of x (each position's prefix)."""
    with torch.no_grad():
        lp = torch.log_softmax(run.classifier_apply(
            run.classifier_params, x, None).float(), dim=-1)
    return lp[:, 1:, condition].mean().item()


def run_ar_fudge_path(kernels):
    """FUDGE at full width (`entry.ar_fudge_flagship()`: the QM9 AR DiT-small
    at L=32, V=36 and the causal `small-classifier` in `no_pooling`, topk 20,
    gamma 1, condition 0, B=16): first the classifier's training
    (`_train_fudge_classifier`), then 31 token steps of one denoiser forward
    and one classifier forward over the B x 20 candidates each, exactly 24
    K1 a step (12 + 12) and nothing else, 0 host syncs; the trained
    classifier's mean log-probability of the condition on the guided
    samples must exceed that on unguided samples from the same seed, and
    the share of the condition's tokens must rise. Returns {path:
    launches}."""
    from ddg_tpu_torch.entry import ar_fudge_flagship
    t0 = time.perf_counter()
    run = ar_fudge_flagship(device=DEV)
    clf_cfg = run.classifier_cfg
    emit({'phase': 'ar_fudge_flagship', 'seconds': time.perf_counter() - t0,
          'denoiser_parameters': sum(p.numel() for p in run.params.values()),
          'classifier_parameters': sum(
              p.numel() for p in run.classifier_params.values()),
          'length': run.length, 'vocab': run.cfg.vocab_size,
          'batch': run.batch_size, 'topk': run.guidance.topk,
          'classifier': [clf_cfg.hidden_size, clf_cfg.n_blocks,
                         clf_cfg.n_heads]})
    out = {'qm9_fudge_classifier_training': _train_fudge_classifier(
        kernels, run)}

    def sample(batch, seed, guided=True):
        return run.sample(torch.Generator(device=DEV).manual_seed(seed),
                          batch_size=batch, guided=guided)

    nb = run.cfg.n_blocks + clf_cfg.n_blocks
    out['ar_fudge'], x, _ = _ar_run(
        'ar_fudge', kernels, sample, {'fused_rope_attention': nb},
        run.length - 1, run.cfg.vocab_size,
        'none: the JAX suite has no FUDGE line (QM9 FUDGE, topk 20, '
        'B=16, DiT-small + small-classifier)')
    plain = sample(None, 1, guided=False)
    cond = run.guidance.condition
    split = (run.cfg.vocab_size - 1) // 2
    share = {'guided': ((x[:, 1:] < split).float().mean().item()),
             'unguided': ((plain[:, 1:] < split).float().mean().item())}
    score = {'guided': _class_log_prob(run, x, cond),
             'unguided': _class_log_prob(run, plain, cond)}
    emit({'phase': 'ar_fudge_guidance', 'condition': cond,
          'class_token_share': share, 'classifier_log_prob': score})
    check(score['guided'] > score['unguided'],
          f'FUDGE: the classifier\'s log-probability of class {cond} went '
          f'from {score["unguided"]} (unguided) to {score["guided"]}')
    check(share['guided'] >= share['unguided'] + 0.03,
          f'FUDGE: the share of class {cond} tokens went from '
          f'{share["unguided"]} to {share["guided"]} only')
    return out


def run_ar_pplm_path(kernels):
    """PPLM at full width (`entry.ar_pplm_flagship()`: the QM9 AR DiT-small
    and the causal `small-classifier` in mean pooling over the denoiser's
    hidden state, one Adagrad step, condition 0, B=16): 31 token steps of
    the trunk once (12 K1; the classifier and the head read the hidden
    state, so neither runs a trunk), exactly that and nothing else, 0 host
    syncs; the guided tokens must differ from unguided ones from the same
    seed. Returns {path: launches}."""
    from ddg_tpu_torch.entry import ar_pplm_flagship
    t0 = time.perf_counter()
    run = ar_pplm_flagship(device=DEV)
    emit({'phase': 'ar_pplm_flagship', 'seconds': time.perf_counter() - t0,
          'length': run.length, 'batch': run.batch_size,
          'pplm_steps': run.guidance.num_pplm_steps})

    def sample(batch, seed, guided=True):
        return run.sample(torch.Generator(device=DEV).manual_seed(seed),
                          batch_size=batch, guided=guided)

    launches, x, _ = _ar_run(
        'ar_pplm', kernels, sample,
        {'fused_rope_attention': run.cfg.n_blocks}, run.length - 1,
        run.cfg.vocab_size,
        'none: the JAX suite has no PPLM line (QM9 PPLM, B=16, DiT-small '
        '+ small-classifier)')
    plain = sample(None, 1, guided=False)
    moved = (x != plain).float().mean().item()
    emit({'phase': 'ar_pplm_guidance', 'tokens_moved_share': moved})
    check(moved > 0, 'PPLM: the guided tokens equal the unguided ones')
    return {'ar_pplm': launches}


def run_dimamba_ar_path(kernels, steps=DIMAMBA_AR_STEPS):
    """The Species10 AR baseline at full width (`entry.dimamba_ar_flagship()`:
    the unidirectional DiMamba, hidden 256, 8 blocks, d_state 16, V=12,
    B=8) through its conv and SSM state decode, `steps` token steps of the
    model's 32767 (the state is O(1) in L: every step costs the same):
    samples/s of the cut run, ms a token step, peak memory, no launch of
    any K kernel, 0 host syncs in a 64-step 2-row run, and the busy ms and
    idle share a step of a 64-step traced run. Returns {path: launches}."""
    from ddg_tpu_torch.entry import dimamba_ar_flagship
    t0 = time.perf_counter()
    run = dimamba_ar_flagship(device=DEV)
    emit({'phase': 'dimamba_ar_flagship',
          'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in run.params.values()),
          'model_length': run.length, 'token_steps_run': steps,
          'batch': run.batch_size, 'hidden': run.cfg.hidden_size,
          'blocks': run.cfg.n_blocks, 'd_state': run.cfg.d_state})

    def sample(batch, seed, length=steps + 1):
        return run.sample(torch.Generator(device=DEV).manual_seed(seed),
                          batch_size=batch, length=length)

    launches, _, secs = _ar_run(
        'dimamba_ar', kernels, sample, {}, steps, run.cfg.vocab_size,
        'none: the JAX suite has no DiMamba AR line',
        sync_sample=lambda: sample(2, 7, 65),
        extra={'cut': f'{steps} of the model\'s {run.length - 1} token '
                      'steps (state O(1) in L)'})
    emit({'phase': 'dimamba_ar_full_length', 'seconds_at_steps_rate':
          secs / steps * (run.length - 1), 'token_steps': run.length - 1})
    _ar_profile('dimamba_ar', run, 65)
    return {'dimamba_ar': launches}


SOURCES = {
    'fused_rope_attention': ('ddg_tpu_torch/csrc/rope_attention.cu',
                             'ddg_tpu/ops/attention_pallas.py:215'),
    'ln_modulate': ('ddg_tpu_torch/csrc/adaln.cu',
                    'ddg_tpu/ops/adaln_pallas.py:132'),
    'gate_res_ln_modulate': ('ddg_tpu_torch/csrc/adaln.cu',
                             'ddg_tpu/ops/adaln_pallas.py:215'),
    'fused_absorbing_sample': ('ddg_tpu_torch/csrc/absorbing_sample.cu',
                               'ddg_tpu/ops/fused_sampling.py:226'),
    'fused_absorbing_cfg_sample': ('ddg_tpu_torch/csrc/absorbing_sample.cu',
                                   'ddg_tpu/ops/fused_sampling.py:281'),
    # K1's backward on the TPU is a plain-jnp recompute (_rope_flash_bwd).
    'fused_rope_attention_bwd': ('ddg_tpu_torch/csrc/rope_attention_bwd.cu',
                                 'ddg_tpu/ops/attention_pallas.py:233'),
    'ln_modulate_bwd': ('ddg_tpu_torch/csrc/adaln.cu',
                        'ddg_tpu/ops/adaln_pallas.py:149'),
    'gate_res_ln_modulate_bwd': ('ddg_tpu_torch/csrc/adaln.cu',
                                 'ddg_tpu/ops/adaln_pallas.py:234'),
    # K9 and K10 reach pl.pallas_call through _uniform_call.
    'fused_uniform_sample': ('ddg_tpu_torch/csrc/uniform_sample.cu',
                             'ddg_tpu/ops/fused_sampling.py:398'),
    'fused_uniform_cfg_sample': ('ddg_tpu_torch/csrc/uniform_sample.cu',
                                 'ddg_tpu/ops/fused_sampling.py:398'),
    'fused_group_norm_act': ('ddg_tpu_torch/csrc/groupnorm.cu',
                             'ddg_tpu/ops/groupnorm_pallas.py:89'),
    # K18 and K14 reach pl.pallas_call through _mk_fwd_call and _fwd_call.
    'mamba_inner': ('ddg_tpu_torch/csrc/mamba.cu',
                    'ddg_tpu/ops/mamba_block_pallas.py:511'),
    'ssm_scan': ('ddg_tpu_torch/csrc/mamba.cu',
                 'ddg_tpu/ops/selective_scan_pallas.py:618'),
    # K19 and K15 reach pl.pallas_call through _mk_bwd_call and _bwd_call.
    'mamba_inner_bwd': ('ddg_tpu_torch/csrc/mamba_bwd.cu',
                        'ddg_tpu/ops/mamba_block_pallas.py:553'),
    'ssm_scan_bwd': ('ddg_tpu_torch/csrc/mamba_bwd.cu',
                     'ddg_tpu/ops/selective_scan_pallas.py:653'),
    'short_seq_attention': ('ddg_tpu_torch/csrc/rope_attention.cu',
                            'ddg_tpu/ops/attention_pallas.py:85'),
    # K2's backward on the TPU is a plain-jnp recompute (_flash_bwd).
    'short_seq_attention_bwd': ('ddg_tpu_torch/csrc/rope_attention_bwd.cu',
                                'ddg_tpu/ops/attention_pallas.py:101'),
    # K16 and K17 reach pl.pallas_call through _fwd_call_lr and _bwd_call_lr.
    'ssm_scan_dtlr': ('ddg_tpu_torch/csrc/mamba.cu',
                      'ddg_tpu/ops/selective_scan_pallas.py:945'),
    'ssm_scan_dtlr_bwd': ('ddg_tpu_torch/csrc/mamba_bwd.cu',
                          'ddg_tpu/ops/selective_scan_pallas.py:994'),
    # K11 and K12 share the body _head_kernel (:464).
    'fused_absorbing_head_sample': ('ddg_tpu_torch/csrc/head_sample.cu',
                                    'ddg_tpu/ops/fused_sampling.py:617'),
    'fused_absorbing_head_sample_int8': (
        'ddg_tpu_torch/csrc/head_sample.cu',
        'ddg_tpu/ops/fused_sampling.py:705'),
    # K20-K22: the library flash attention that ddg_tpu/models/dit.py:361-370
    # calls (jax 0.9.0's module; its three pl.pallas_call sites).
    'flash_attention_fwd': ('ddg_tpu_torch/csrc/flash_attention.cu',
                            'jax/experimental/pallas/ops/tpu/'
                            'flash_attention.py:758'),
    'flash_attention_bwd_dkv': ('ddg_tpu_torch/csrc/flash_attention.cu',
                                'jax/experimental/pallas/ops/tpu/'
                                'flash_attention.py:1121'),
    'flash_attention_bwd_dq': ('ddg_tpu_torch/csrc/flash_attention.cu',
                               'jax/experimental/pallas/ops/tpu/'
                               'flash_attention.py:1456'),
}


def kernel_wrappers():
    """{name: wrapper} of every kernel (each wrapper counts its launches in
    `.launches`)."""
    from ddg_tpu_torch.ops import (adaln, attention, flash_attention,
                                   groupnorm, mamba)
    from ddg_tpu_torch.ops import fused_sampling as fs
    return {
        'fused_rope_attention': attention.fused_rope_attention,
        'ln_modulate': adaln.ln_modulate,
        'gate_res_ln_modulate': adaln.gate_res_ln_modulate,
        'fused_absorbing_sample': fs.fused_absorbing_sample,
        'fused_absorbing_cfg_sample': fs.fused_absorbing_cfg_sample,
        'fused_rope_attention_bwd': attention.fused_rope_attention_bwd,
        'ln_modulate_bwd': adaln.ln_modulate_bwd,
        'gate_res_ln_modulate_bwd': adaln.gate_res_ln_modulate_bwd,
        'fused_uniform_sample': fs.fused_uniform_sample,
        'fused_uniform_cfg_sample': fs.fused_uniform_cfg_sample,
        'fused_group_norm_act': groupnorm.fused_group_norm_act,
        'mamba_inner': mamba.mamba_inner,
        'ssm_scan': mamba.ssm_scan,
        'mamba_inner_bwd': mamba.mamba_inner_bwd,
        'ssm_scan_bwd': mamba.ssm_scan_bwd,
        'short_seq_attention': attention.short_seq_attention,
        'short_seq_attention_bwd': attention.short_seq_attention_bwd,
        'ssm_scan_dtlr': mamba.ssm_scan_dtlr,
        'ssm_scan_dtlr_bwd': mamba.ssm_scan_dtlr_bwd,
        'fused_absorbing_head_sample': fs.fused_absorbing_head_sample,
        'fused_absorbing_head_sample_int8':
            fs.fused_absorbing_head_sample_int8,
        **{name: getattr(flash_attention, name) for name in FLASH},
    }


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddg_tpu_torch.entry import unet_flagship
    kernels = kernel_wrappers()

    _step('phase_environment', phase_environment)
    _step('phase_build', phase_build)

    t0 = time.perf_counter()
    unet = unet_flagship(device=DEV)
    unet8 = unet_flagship(device=DEV, int8=True)
    unet_cfg = unet[1]
    norms, macs = unet_forward_census(unet[2], unet_cfg)
    n_norms = sum(norms.values())
    STEP_SECONDS['unet_flagship'] = time.perf_counter() - t0
    emit({'phase': 'unet_flagship', 'seconds': time.perf_counter() - t0,
          'parameters': sum(p.numel() for p in unet[4].values()),
          'ch': unet_cfg.ch, 'ch_mult': list(unet_cfg.ch_mult),
          'num_res_blocks': unet_cfg.num_res_blocks,
          'image_size': unet_cfg.image_size, 'vocab': unet_cfg.vocab_size,
          'macs_per_image': macs, 'norms_per_forward': n_norms,
          'norm_shapes': [[*k, v] for k, v in sorted(norms.items())]})
    check(n_norms == expected_norms(unet_cfg),
          f'the UNet runs {n_norms} GroupNorms a forward, the architecture '
          f'{expected_norms(unet_cfg)}')

    results = {name: {} for name in kernels}
    _step('check_adaln', check_adaln, results)
    _step('check_attention', lambda: check_attention_plan(
        check_attention(results)))
    _step('check_flash_attention', lambda: check_flash_plan(
        check_flash_attention(results)))
    tv = _step('check_sampling', check_sampling, results)
    _step('check_head_sample', check_head_sample, results)
    tv.update(_step('check_uniform', check_uniform, results))
    _step('check_groupnorm', check_groupnorm, results, norms)
    _step('check_adaln_bwd', check_adaln_bwd, results)
    _step('check_uniform_species', check_uniform_species, results, tv)
    _step('check_mamba', check_mamba, results)
    _step('check_mamba_bwd', check_mamba_bwd, results)
    _step('check_ar_attention', check_ar_attention, results)
    emit({'phase': 'kernels_vs_plain', 'results': results,
          'internal_rng': tv})
    _step('check_tiny_dit', check_tiny_dit)
    _step('check_tiny_dit_flash', check_tiny_dit, 'flash')
    _step('check_tiny_dit_int8', check_tiny_dit_int8)
    _step('check_int8_tv', check_int8_tv)
    _step('check_tiny_train', check_tiny_train)
    _step('check_tiny_unet', check_tiny_unet)
    _step('check_tiny_unet_int8', check_tiny_unet_int8)
    _step('check_unet_int8_tv', check_unet_int8_tv, unet, unet8)
    _step('check_tiny_unet_train', check_tiny_unet_train)
    _step('check_tiny_dimamba', check_tiny_dimamba)
    _step('check_tiny_dimamba_train', check_tiny_dimamba_train)
    _step('check_tiny_text8_train', check_tiny_text8_train)
    _step('check_wide_head_dit_train', check_wide_head_dit_train)
    _step('check_tiny_classifier', check_tiny_classifier)
    _step('check_tiny_ar', check_tiny_ar)
    by_path = {
        'serving': _step('run_main_path', run_main_path, kernels),
        'training': _step('run_train_path', run_train_path, kernels)}
    by_path.update(_step('run_unet_path', run_unet_path, kernels, unet, unet8,
                         n_norms))
    del unet8
    by_path['unet_training'] = _step('run_unet_train_path',
                                     run_unet_train_path, kernels)
    by_path.update(_step('run_dimamba_path', run_dimamba_path, kernels))
    by_path.update(_step('run_dimamba_train_path', run_dimamba_train_path,
                         kernels))
    by_path.update(_step('run_dimamba_dtlr_train_path',
                         run_dimamba_dtlr_train_path, kernels))
    by_path['text8_training'] = _step(
        'run_text8_train_path', run_text8_train_path, kernels, 'fused_rope')
    by_path['text8_training_short_seq'] = _step(
        'run_text8_train_path_short_seq', run_text8_train_path, kernels,
        'short_seq', warmup=1, steps=2)
    by_path['text8_training_flash'] = _step(
        'run_text8_train_path_flash', run_text8_train_path, kernels, 'flash',
        warmup=1, steps=2)
    by_path['dit_small_l1024_training'] = _step(
        'run_dit_small_l1024', run_dit_small_l1024, kernels)
    by_path['qm9_classifier_training'], trained = _step(
        'run_classifier_train_path', run_classifier_train_path, kernels)
    by_path['qm9_cbg'] = _step('run_cbg_path', run_cbg_path, kernels,
                               trained)
    by_path['qm9_cbg_approx'] = _step('run_cbg_approx_path', run_cbg_path,
                                      kernels, trained, approx=True)
    by_path['lm1b_nos'] = _step('run_nos_path', run_nos_path, kernels)
    by_path.update(_step('run_ar_path', run_ar_path, kernels))
    by_path.update(_step('run_ar_int8_path', run_ar_path, kernels,
                         int8_kv=True))
    by_path.update(_step('run_ar_fudge_path', run_ar_fudge_path, kernels))
    by_path.update(_step('run_ar_pplm_path', run_ar_pplm_path, kernels))
    by_path.update(_step('run_dimamba_ar_path', run_dimamba_ar_path,
                         kernels))
    _step('check_learning', check_learning)
    _step('check_dimamba_learning', check_dimamba_learning)
    _step('check_text8_learning', check_text8_learning)
    _step('check_unet_learning', check_unet_learning)

    rows = []
    for name in kernels:
        # K12's record is its int8 one.
        r = (results[name].get(str(torch.bfloat16))
             or results[name][str(torch.int8)])
        src, replaces = SOURCES[name]
        launches = {path: n[name] for path, n in by_path.items()
                    if n[name]}
        rows.append({'name': name, 'route': 'cuda', 'source': src,
                     'replaces': replaces,
                     'launches': sum(launches.values()),
                     'launches_by_path': launches,
                     'max_abs_err': r['err'], 'ms': r['ms'],
                     'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                     'bound_by': r['bound_by'],
                     'library_ms': r.get('library_ms')})
        for key in ('ms_covers', 'products_matmul_ms', 'composite_ms',
                    'composite', 'split_ms', 'rng_near_ties_vs_k7',
                    'ms_half_masked', 'bound_ms_half_masked',
                    'half_masked_share', 'bound_issue_ms',
                    'bound_ms_full_noise',
                    'logits_bit_equal_int8_dense',
                    'shape', 'sum_err_of_tol', 'widened',
                    'differs_from_plain',
                    'ms_train_shape', 'k15_ms', 'own_ms',
                    'workspace_bytes', 'workspace_own_bytes',
                    'equals_ssm_scan_on_composite'):
            if key in r:
                rows[-1][key] = r[key]
        for label in ('lm1b_sampling', 'lm1b_training', 'text8_training',
                      'long', *QM9_LABELS, *AR_LABELS):
            other = results[name].get(label, {}).get(str(torch.bfloat16))
            if other and 'ms' in other:
                rows[-1][label] = {
                    k: other[k] for k in ('shape', 'err', 'ms', 'plain_ms',
                                          'library_ms', 'bound_ms',
                                          'bound_by', 'composite_ms',
                                          'split_ms') if k in other}
        f32 = results[name].get(str(torch.float32), {})
        if name.startswith('fused_absorbing_head') and 'ms' in f32:
            rows[-1]['float32'] = {
                k: f32[k] for k in ('err', 'ms', 'plain_ms', 'composite_ms',
                                    'bound_ms', 'bound_by')}
        if 'species10' in results[name]:
            rows[-1]['species10'] = {
                k: results[name]['species10'][k]
                for k in ('shape', 'err', 'ms', 'plain_ms', 'bound_ms',
                          'bound_by', 'bound_ms_full_noise',
                          'bound_issue_ms')
                if k in results[name]['species10']}
    emit({'phase': 'step_seconds', 'seconds': STEP_SECONDS,
          'unaccounted': time.perf_counter() - T_START
          - sum(STEP_SECONDS.values())})
    emit({'phase': 'done', 'seconds': time.perf_counter() - T_START,
          'trace_retakes': TRACE_RETAKES})
    emit({'kernels': rows})
    print(nvidia_smi(), flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
