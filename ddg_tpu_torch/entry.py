"""Entry points of the port (counterpart of `__graft_entry__.py:19-57`).

`flagship()` builds the serving flagship: the LM1B-class DiT-small MDLM
denoiser (hidden 768, cond_dim 128, 12 blocks of 12 heads, L=128,
V=30523 = bert-base + mask, 2 classes + the null class) in bf16 with a
bf16 vocab head, running its attention and adaLN chains through the
Hopper kernels (`fused_rope_attn=True`, `fused_adaln=True`). The weights
are seeded random ones in the reference layout
(`convert.make_reference_dit_state_dict`) until a published checkpoint
is in the repository. `int8=True` gives the JAX bench's
`_lm1b_setup(int8=True)` configuration (`bench.py:140-162`): the same
model and weights with `quant_int8`, the trunk's four big products and
the vocab head on int8 dynamic quantization (`ops.quant.QLinear`), the
attention and adaLN kernels unchanged.

`entry()` returns one denoiser forward to log-probs with example inputs.

`train_flagship()` builds the training flagship, the reference's LM1B
MDLM run (`scripts/train_lm1b.sh` with `configs/model/small.yaml`,
`configs/config.yaml:77-107`, `configs/lr_scheduler/constant_warmup.yaml`
and `configs/weights_averaging/ema.yaml`): the same DiT-small without
classes, dropout 0.1, bf16 trunk with a float32 vocab head, absorbing
SUBS with the log-linear schedule and antithetic t, AdamW (lr 3e-4, no
weight decay, clip 1.0) with 2500 warmup steps, EMA 0.9999, and a global
batch of 512 x 128 tokens as micro-batches of TRAIN_MICRO_BATCH. Until the LM1B data is in the repository, batches are
synthetic tokens drawn uniformly over [0, V-1) (`TrainRun.batch`).

`text8_train_flagship()` builds the reference's text8 MDLM run
(`scripts/train_text8.sh`: `model=small`, `model.length=256`, global batch
512, lr 3e-4; the JAX bench's training line, `bench.py:433-543`): the
DiT-small at L=256 over text8's V=35 (mask 34) without classes, dropout
0.1, bf16 trunk with a float32 vocab head, and the rest as
`train_flagship()`, as micro-batches of TEXT8_TRAIN_MICRO_BATCH. Its
attention takes one of three routes through the Hopper kernels: 'fused_rope'
(K1 and K1b, `fused_rope_attn=True`), 'short_seq' (RoPE in PyTorch, then
K2 and its backward, `pallas_attention=True`) or 'flash' (RoPE in PyTorch,
then the library flash attention's K20 and K21/K22, `tpu_flash_attn=True`:
the JAX bench's `--train --flash-attn` line). Batches are synthetic
tokens over [0, 34), as `bench.py` draws them: no text8 data is in the
repository.

`unet_flagship()` builds the image serving configuration, the JAX bench's
CIFAR10 UDLM cell (`bench.py:626-683`, trained by
`scripts/train_cifar10_unet_guidance.sh`): the UNet with ch 128, 2 res
blocks a scale, 4 scales of `ch_mult` (1, 2, 2, 2), attention at 16 x 16,
32 x 32 x 3 images as 3072 tokens over V=256 pixel values, 10 classes + the
null class, dropout 0, a bf16 trunk with fp32 GroupNorm outputs through
the Hopper GroupNorm kernel (`fused_norm=True`); uniform-state D3PM with the
log-linear schedule, no mask token. Sigma conditions the model
(`time_conditioning=True`, as the reference CIFAR run trains it;
`bench.py` leaves the spec's default, which zeroes sigma, for the same
compute). The weights are seeded random ones drawn as the JAX module
initialises them (`convert.make_unet_state_dict`) until a CIFAR10
checkpoint is in the repository.

`dimamba_flagship()` builds the genomics serving configuration, the
paper's Species10 UDLM workload (`scripts/train_ten_species_guidance.sh`
with `configs/model/dimamba.yaml`, built as `ddg_tpu/main.py:173-209`
builds it): DiMamba with hidden 256, cond_dim 128, L=32768, 8 blocks,
d_state 16, d_conv 4, expand 2, bidirectional 'add' with tied in/out
projections, an untied fp32 `lm_head`, 10 classes + the null class, bf16
compute, scan chunk 128; uniform-state D3PM with the log-linear schedule
over the DNA tokenizer's V=12 (`mask_index` 3 as `effective_vocab` sets
it), sigma conditioning on. The weights are seeded random ones in the
reference layout (`convert.make_reference_dimamba_state_dict`, non-zero
adaLN projections) through the port's converter. `route='dt_lowrank'` builds the same weights
into the unfused chain around the dt-lowrank scan, K16 (`fused_block=False,
dt_inkernel=True`).

`dimamba_train_flagship()` builds the genomics training run, the same
script's (`scripts/train_ten_species_guidance.sh`, `ddg_tpu/main.py:173-209`):
that DiMamba at full width and depth with dropout 0.1 on the gated branch;
uniform-state D3PM in continuous time with the log-linear schedule,
antithetic t (eps 1e-3), sigma conditioning, `zero_recon_loss` and CFG
cond dropout 0.1; AdamW (lr 2e-3, betas 0.9/0.999, eps 1e-8, no weight
decay, clip 1.0) with 2500 warmup steps, EMA 0.9999; a global batch of
32 x 32768 tokens as micro-batches of DIMAMBA_TRAIN_MICRO_BATCH (on the
'dt_lowrank' route, K16 and K17, of DIMAMBA_DTLR_TRAIN_MICRO_BATCH). Until the
Species10 data is in the repository, batches are synthetic bases (A C G T
N, ids 7-11) with a class label per row (`TrainRun.batch`).

`qm9_cbg_flagship()` builds the JAX bench's D-CBG cell
(`bench._qm9_cbg_setup`, `bench.py:221-268`, the QM9 eval protocol of
`scripts/eval_qm9_guidance.sh`): the DiT-small denoiser (768, 12 blocks of
12 heads, cond 128) at L=32 over the QM9 SMILES vocabulary (35 tokens +
the mask, index 35), no classes, a float32 vocab head; the tiny classifier
(`configs/classifier_model/tiny-classifier.yaml`: hidden 512, 8 blocks of
8 heads, head width 64) with 2 classes and mean pooling; absorbing SUBS
with the log-linear schedule; dropout 0, bf16 trunks, both models through
the Hopper kernels (`fused_rope_attn=True`, `fused_adaln=True`). Seeded
random weights in the reference layout (`convert.
make_reference_dit_state_dict`, `make_reference_dit_classifier_state_dict`)
until QM9 checkpoints are in the repository.

`nos_flagship()` is the JAX bench's NOS cell (`bench.py:334-390`): the
LM1B `flagship()` denoiser with the head-only mean-pooling classifier over
its hidden states (`bench.py:350-359`), 2 classes.

The AR entry points return an `ARRun`, whose `sample(generator)` draws one
batch through `samplers.ar_sample`:
  * `ar_flagship()` is the JAX bench's `ar` line (`bench.py:391-432`,
    `_lm1b_setup(causal=True)`): the LM1B DiT-small as a causal AR model
    (no sigma map, adaLN on the 2 classes + null, a bf16 head), D-CFG at
    gamma 2 on condition 0 from bos 0 at B=256 through the KV-cache decode
    (2B = 512 decode rows, 4 length buckets); `int8_kv=True` is the
    `ar_int8` line, the same with the int8 KV cache;
  * `ar_fudge_flagship()` is FUDGE on QM9 (`configs/guidance/fudge.yaml`,
    topk 20, gamma 1): the AR DiT-small at L=32, V=36
    (`scripts/train_qm9_guidance.sh` with MODEL=ar: 2 classes from its
    cond dropout, sampled without a class as FUDGE and PPLM sample) and
    the causal `small-classifier` (768, 12 blocks of 12 heads) in
    `no_pooling` (`scripts/train_qm9_fudge_classifier.sh`), B=16
    (`scripts/eval_qm9_guidance.sh`), full forwards through K1;
  * `ar_pplm_flagship()` is PPLM (`configs/guidance/pplm.yaml`) on the same
    denoiser with the causal `small-classifier` in mean pooling, built as
    `ddg_tpu/main.py:234-260` builds it for an AR spec; it reads the
    denoiser's hidden state (`x_emb`), so its trunk does not run;
  * `dimamba_ar_flagship()` is the Species10 AR baseline
    (`scripts/train_ten_species_no-guidance.sh` with MODEL=ar,
    `configs/model/dimamba.yaml` with `bidirectional=False`): the DiMamba
    at hidden 256, 8 blocks, d_state 16, unconditional, over the DNA
    vocabulary, B=8, through its conv and SSM state decode.

All run on the card unless the caller passes `device='cpu'`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ddg_tpu_torch.convert import (dimamba_params_from_reference,
                                   dimamba_state_dict_from_jax,
                                   make_reference_dimamba_state_dict,
                                   make_reference_dit_classifier_state_dict,
                                   make_reference_dit_state_dict,
                                   make_unet_state_dict)
from ddg_tpu_torch.diffusion import DiffusionSpec, log_x_theta
from ddg_tpu_torch.models import (DIT, DiMamba, DiMambaConfig,
                                  DITClassifier, DITConfig, UNet, UNetConfig,
                                  make_classifier_apply, make_model_apply)
from ddg_tpu_torch.ops.noise_schedules import LogLinearNoise
from ddg_tpu_torch.runtime.averaging import AveragingSpec
from ddg_tpu_torch.runtime.optim import OptimSpec
from ddg_tpu_torch.runtime.train_state import (TrainState, init_train_state,
                                               make_train_step)
from ddg_tpu_torch.samplers import GuidanceSpec, SamplerSpec, ar_sample

TRAIN_GLOBAL_BATCH = 512
# The largest power of two whose train step peaks under half of an 80 GB
# card (PERF.md, training section).
TRAIN_MICRO_BATCH = 256
TEXT8_TRAIN_GLOBAL_BATCH = 512
# The fastest micro-batch of the card's sweep whose step peaks under half of
# an 80 GB card (PERF.md, text8 training; scripts/profile_torch_train.py
# --model text8 --sweep).
TEXT8_TRAIN_MICRO_BATCH = 256
TEXT8_VOCAB = 35                 # text8's characters and specials; mask 34
# The attention routes of the text8 run: the DITConfig flags of each.
TEXT8_ROUTES = {'fused_rope': dict(fused_rope_attn=True,
                                   pallas_attention=False,
                                   tpu_flash_attn=False),
                'short_seq': dict(fused_rope_attn=False,
                                  pallas_attention=True,
                                  tpu_flash_attn=False),
                'flash': dict(fused_rope_attn=False, pallas_attention=False,
                              tpu_flash_attn=True)}
DIMAMBA_TRAIN_GLOBAL_BATCH = 32
# The largest power of two dividing 32 whose train step peaks under half of
# an 80 GB card (PERF.md, Species10 training).
DIMAMBA_TRAIN_MICRO_BATCH = 16
# The same rule on the 'dt_lowrank' route, whose unfused chain keeps its
# intermediates for PyTorch's autograd (PERF.md §4, the card's sweep by
# scripts/profile_torch_train.py --model dimamba --route dt_lowrank --sweep).
DIMAMBA_DTLR_TRAIN_MICRO_BATCH = 4
# The mixer routes of the Species10 runs: the DiMambaConfig flags of each.
# 'fused_block' is K18/K19 (the JAX module's default choice); 'dt_lowrank'
# is the unfused chain around K16/K17 (`dt_inkernel`), taken on the CPU
# too (the kernels' plain versions there).
DIMAMBA_ROUTES = {'fused_block': {},
                  'dt_lowrank': dict(fused_block=False, dt_inkernel=True,
                                     pallas_scan=True)}


def resolve_device(device=None) -> torch.device:
    """`device`, defaulting to the current CUDA card; raises when a CUDA
    device is asked for and none is visible."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is visible; pass device="cpu" '
                           'to run on the CPU')
    return device


def flagship(tiny: bool = False, device=None, *, seed: int = 0,
             int8: bool = False):
    """Returns (spec, cfg, model, model_apply, params) on `device`;
    `int8` turns on `quant_int8` (inference only)."""
    device = resolve_device(device)
    if tiny:
        cfg = DITConfig(hidden_size=64, cond_dim=32, length=32, n_blocks=2,
                        n_heads=2, vocab_size=258)
    else:
        cfg = DITConfig(hidden_size=768, cond_dim=128, length=128,
                        n_blocks=12, n_heads=12, vocab_size=30523)
    cfg = dataclasses.replace(cfg, num_classes=2,
                              logits_dtype=torch.bfloat16,
                              fused_rope_attn=True, fused_adaln=True,
                              quant_int8=int8)
    spec = DiffusionSpec(diffusion='absorbing_state',
                         parameterization='subs', noise=LogLinearNoise(),
                         vocab_size=cfg.vocab_size,
                         mask_index=cfg.vocab_size - 1, num_classes=2)
    model = DIT(cfg)
    model.load_state_dict(make_reference_dit_state_dict(
        np.random.RandomState(seed), hidden=cfg.hidden_size,
        cond_dim=cfg.cond_dim, n_blocks=cfg.n_blocks,
        vocab=cfg.vocab_size, with_cond=True), strict=True)
    model = model.to(device).eval()
    apply_fn = make_model_apply(model)
    return spec, cfg, model, apply_fn, apply_fn.params


QM9_VOCAB = 36                   # 35 SMILES tokens + the mask (35)
CLASSIFIER_CLASSES = 2


def qm9_cbg_flagship(tiny: bool = False, device=None, *, seed: int = 0,
                     approx: bool = False):
    """Returns (spec, cfg, clf_cfg, model_apply, params, classifier_apply,
    classifier_params) on `device`, as `bench._qm9_cbg_setup` does. The
    denoiser's weights come from `seed`, the classifier's from `seed + 1`.
    `approx` names the first-order run, as in JAX, whose classifier is
    initialised through the one-hot signature; the weights here do not
    depend on it. `tiny` is `bench.py --quick`'s pair: the denoiser hidden
    64, cond 32, 2 blocks of 2 heads at L=16; the classifier hidden 32, one
    block of one head."""
    del approx
    device = resolve_device(device)
    if tiny:
        cfg = DITConfig(hidden_size=64, cond_dim=32, length=16, n_blocks=2,
                        n_heads=2)
        clf_cfg = dataclasses.replace(cfg, hidden_size=32, n_blocks=1,
                                      n_heads=1)
    else:
        cfg = DITConfig(hidden_size=768, cond_dim=128, length=32,
                        n_blocks=12, n_heads=12)
        clf_cfg = dataclasses.replace(cfg, hidden_size=512, n_blocks=8,
                                      n_heads=8)
    kw = dict(dropout=0.0, vocab_size=QM9_VOCAB, fused_rope_attn=True,
              fused_adaln=True)
    cfg = dataclasses.replace(cfg, **kw)
    clf_cfg = dataclasses.replace(clf_cfg, **kw)
    spec = DiffusionSpec(diffusion='absorbing_state',
                         parameterization='subs', noise=LogLinearNoise(),
                         vocab_size=QM9_VOCAB, mask_index=QM9_VOCAB - 1)
    model = DIT(cfg)
    model.load_state_dict(make_reference_dit_state_dict(
        np.random.RandomState(seed), hidden=cfg.hidden_size,
        cond_dim=cfg.cond_dim, n_blocks=cfg.n_blocks,
        vocab=cfg.vocab_size), strict=True)
    clf = DITClassifier(clf_cfg, num_classes=CLASSIFIER_CLASSES,
                        pooling='mean')
    clf.load_state_dict(make_reference_dit_classifier_state_dict(
        np.random.RandomState(seed + 1), hidden=clf_cfg.hidden_size,
        cond_dim=clf_cfg.cond_dim, n_blocks=clf_cfg.n_blocks,
        vocab=clf_cfg.vocab_size, num_classes=CLASSIFIER_CLASSES),
        strict=True)
    apply_fn = make_model_apply(model.to(device).eval())
    clf_apply = make_classifier_apply(clf.to(device).eval())
    return (spec, cfg, clf_cfg, apply_fn, apply_fn.params, clf_apply,
            clf_apply.params)


def nos_flagship(tiny: bool = False, device=None, *, seed: int = 0):
    """Returns (spec, cfg, model_apply, params, classifier_apply,
    classifier_params) on `device`: `flagship(tiny, device, seed=seed)`'s
    denoiser and a head-only mean-pooling classifier over its hidden
    states (`DITClassifier(cfg, head_only=True)`: `output_layer` alone,
    no trunk), its weights from `seed + 1`."""
    spec, cfg, _, apply_fn, params = flagship(tiny, device, seed=seed)
    clf = DITClassifier(cfg, num_classes=CLASSIFIER_CLASSES, pooling='mean',
                        head_only=True)
    clf.load_state_dict(make_reference_dit_classifier_state_dict(
        np.random.RandomState(seed + 1), hidden=cfg.hidden_size,
        num_classes=CLASSIFIER_CLASSES, head_only=True), strict=True)
    clf_apply = make_classifier_apply(clf.to(resolve_device(device)).eval())
    return spec, cfg, apply_fn, params, clf_apply, clf_apply.params


def _unet_cfg(tiny: bool) -> UNetConfig:
    """The CIFAR10 UNet (configs/model/unet.yaml) with 10 classes, or
    `bench.py --unet --quick`'s cut of it: ch 16, one res block, 2 scales,
    8 x 8 images (L=192)."""
    if tiny:
        cfg = UNetConfig(ch=16, num_res_blocks=1, num_scales=2,
                         ch_mult=(1, 1), image_size=8)
    else:
        cfg = UNetConfig(ch=128, num_res_blocks=2, num_scales=4,
                         ch_mult=(1, 2, 2, 2), image_size=32)
    return dataclasses.replace(cfg, num_classes=10)


def _unet_spec(cfg: UNetConfig, **kw) -> DiffusionSpec:
    """Uniform-state D3PM over the pixel values with the log-linear
    schedule, no mask token, sigma conditioning."""
    return DiffusionSpec(diffusion='uniform', parameterization='d3pm',
                         noise=LogLinearNoise(), vocab_size=cfg.vocab_size,
                         mask_index=-1, num_classes=cfg.num_classes,
                         time_conditioning=True, **kw)


def _unet_model(cfg: UNetConfig, seed: int) -> UNet:
    model = UNet(cfg)
    model.load_state_dict(make_unet_state_dict(
        model, np.random.RandomState(seed)), strict=True)
    return model


def unet_flagship(tiny: bool = False, device=None, *, seed: int = 0,
                  int8: bool = False):
    """Returns (spec, cfg, model, model_apply, params) on `device`. `tiny`
    is `bench.py --unet --quick`'s model: ch 16, one res block, 2 scales,
    8 x 8 images (L=192). `int8` is the JAX suite's `unet_int8` line
    (`bench.py:920-924`): `quant_int8` with bf16 GroupNorm outputs, the
    norms still through K13."""
    device = resolve_device(device)
    cfg = dataclasses.replace(
        _unet_cfg(tiny), dropout=0.0, compute_dtype=torch.bfloat16,
        norm_dtype=torch.bfloat16 if int8 else torch.float32,
        fused_norm=True, quant_int8=int8)
    model = _unet_model(cfg, seed).to(device).eval()
    apply_fn = make_model_apply(model)
    return _unet_spec(cfg), cfg, model, apply_fn, apply_fn.params


# The DNA tokenizer (`ddg_tpu/data/tokenizers.py:211-231`): 7 specials, then
# A C G T N; [MASK] is 3.
DNA_VOCAB, DNA_MASK = 12, 3
DNA_BASES = (7, 12)


def dimamba_flagship(tiny: bool = False, device=None, *, seed: int = 0,
                     route: str = 'fused_block'):
    """Returns (spec, cfg, model, model_apply, params) on `device`, its
    mixer through `route` (DIMAMBA_ROUTES: 'fused_block' or 'dt_lowrank';
    the weights are the same). `tiny` is a CPU-sized model: hidden 32,
    cond_dim 16, 2 blocks, L=256 (two scan chunks)."""
    device = resolve_device(device)
    cfg, model = _dimamba(tiny, seed, route)
    spec = DiffusionSpec(diffusion='uniform', parameterization='d3pm',
                         noise=LogLinearNoise(), vocab_size=DNA_VOCAB,
                         mask_index=DNA_MASK, num_classes=cfg.num_classes,
                         time_conditioning=True)
    model = model.to(device).eval()
    apply_fn = make_model_apply(model)
    return spec, cfg, model, apply_fn, apply_fn.params


def _dimamba(tiny: bool, seed: int, route: str, bidirectional: bool = True,
             num_classes: Optional[int] = 10):
    """The Species10 DiMamba (or its CPU-sized cut) with seeded random
    weights in the reference layout, its mixer through `route`: (cfg,
    model) on the CPU. `bidirectional=False, num_classes=None` is the AR
    baseline's."""
    if route not in DIMAMBA_ROUTES:
        raise ValueError(f'route must be one of {sorted(DIMAMBA_ROUTES)}, '
                         f'got {route!r}')
    if tiny:
        cfg = DiMambaConfig(hidden_size=32, cond_dim=16, length=256,
                            n_blocks=2)
    else:
        cfg = DiMambaConfig(hidden_size=256, cond_dim=128, length=32768,
                            n_blocks=8)
    cfg = dataclasses.replace(cfg, vocab_size=DNA_VOCAB,
                              num_classes=num_classes,
                              bidirectional=bidirectional,
                              d_state=16, d_conv=4, expand=2,
                              scan_chunk=128, scan_seg=64, scan_seg_bwd=64,
                              dropout=0.1, compute_dtype=torch.bfloat16,
                              **DIMAMBA_ROUTES[route])
    model = DiMamba(cfg)
    ref = make_reference_dimamba_state_dict(
        np.random.RandomState(seed), hidden=cfg.hidden_size,
        cond_dim=cfg.cond_dim, n_blocks=cfg.n_blocks, vocab=cfg.vocab_size,
        d_state=cfg.d_state, d_conv=cfg.d_conv, expand=cfg.expand,
        num_classes=cfg.num_classes, bidirectional=bidirectional)
    model.load_state_dict(dimamba_state_dict_from_jax(
        dimamba_params_from_reference(ref, n_blocks=cfg.n_blocks,
                                      bidirectional=bidirectional),
        n_blocks=cfg.n_blocks), strict=True)
    return cfg, model


def entry(device=None):
    """Returns (fn, example_args): fn(params, x, sigma) -> log-probs of one
    flagship forward, B=8."""
    spec, cfg, _, apply_fn, params = flagship(device=device)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, cfg.vocab_size, (8, cfg.length), generator=gen,
                      device=dev, dtype=torch.int32)
    sigma = torch.full((8,), 0.5, device=dev)

    def fn(params, x, sigma):
        with torch.no_grad():
            return log_x_theta(spec, apply_fn, params, x, sigma)

    return fn, (params, x, sigma)


@dataclasses.dataclass
class TrainRun:
    """What `train_flagship` and `dimamba_train_flagship` build;
    `step(state, batch)` is the train step."""
    spec: DiffusionSpec
    cfg: object                 # DITConfig, DiMambaConfig or UNetConfig
    model: torch.nn.Module
    apply_fn: object
    optim: OptimSpec
    averaging: AveragingSpec
    state: TrainState
    step: object
    global_batch: int
    micro_batch: int
    # Synthetic tokens are drawn uniformly over [lo, hi).
    tokens: tuple = (0, None)

    @property
    def accum_steps(self) -> int:
        return self.global_batch // self.micro_batch

    def batch(self, generator: torch.Generator) -> dict:
        """A synthetic global batch shaped (accum, micro, L) when
        accumulating: tokens uniform over `tokens` (by default [0, V-1), as
        `bench.py` draws them) and, for a class-conditional model, a class
        label per row ('cond', uniform over the classes)."""
        shape = (self.global_batch, self.cfg.length)
        if self.accum_steps > 1:
            shape = (self.accum_steps, self.micro_batch, self.cfg.length)
        lo, hi = self.tokens
        ids = torch.randint(lo, self.cfg.vocab_size - 1 if hi is None else hi,
                            shape, generator=generator,
                            device=generator.device, dtype=torch.int32)
        out = {'input_ids': ids,
               'attention_mask': torch.ones(shape, device=ids.device)}
        if self.cfg.num_classes is not None:
            out['cond'] = torch.randint(0, self.cfg.num_classes, shape[:-1],
                                        generator=generator,
                                        device=generator.device,
                                        dtype=torch.int32)
        return out


def train_flagship(device=None, *, seed: int = 0,
                   tiny: bool = False) -> TrainRun:
    """The training flagship on `device`, weights seeded random in the
    reference layout, the train state's generator seeded with `seed`.
    `tiny` is a 2-block, 64-wide model with V=258, L=32 and a global
    batch of 8 as 2 micro-batches, for runs on the CPU."""
    if tiny:
        cfg = DITConfig(hidden_size=64, cond_dim=32, length=32, n_blocks=2,
                        n_heads=2, vocab_size=258)
        global_batch, micro = 8, 4
    else:
        cfg = DITConfig(hidden_size=768, cond_dim=128, length=128,
                        n_blocks=12, n_heads=12, vocab_size=30523)
        global_batch, micro = TRAIN_GLOBAL_BATCH, TRAIN_MICRO_BATCH
    return _dit_train_run(
        _dit_train_setup(dataclasses.replace(cfg, fused_rope_attn=True),
                         global_batch, micro), device, seed)


@dataclasses.dataclass(frozen=True)
class DiTTrainSetup:
    """What a DiT MDLM training run is made of, before any model is
    built."""
    cfg: DITConfig
    spec: DiffusionSpec
    optim: OptimSpec
    averaging: AveragingSpec
    global_batch: int
    micro_batch: int


def _dit_train_setup(cfg: DITConfig, global_batch: int,
                     micro: int) -> DiTTrainSetup:
    """The DiT MDLM training run of `train_flagship` for `cfg` (its
    attention flags set): dropout 0.1, no classes, bf16 trunk, fp32 head,
    the adaLN kernels, absorbing SUBS with the log-linear schedule and
    antithetic t, AdamW 3e-4 (2500 warmup, clip 1.0), EMA 0.9999."""
    cfg = dataclasses.replace(cfg, dropout=0.1, num_classes=None,
                              compute_dtype=torch.bfloat16,
                              logits_dtype=torch.float32, fused_adaln=True)
    spec = DiffusionSpec(diffusion='absorbing_state',
                         parameterization='subs', noise=LogLinearNoise(),
                         vocab_size=cfg.vocab_size,
                         mask_index=cfg.vocab_size - 1,
                         antithetic_sampling=True, sampling_eps=1e-3)
    optim = OptimSpec(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                      weight_decay=0.0, grad_clip=1.0,
                      scheduler='constant_warmup', num_warmup_steps=2500)
    return DiTTrainSetup(cfg=cfg, spec=spec, optim=optim,
                         averaging=AveragingSpec.ema(0.9999),
                         global_batch=global_batch, micro_batch=micro)


def text8_train_setup(*, tiny: bool = False,
                      route: str = 'fused_rope') -> DiTTrainSetup:
    """The text8 run's configuration with attention through `route`
    ('fused_rope', 'short_seq' or 'flash', TEXT8_ROUTES). `tiny` is `bench.py
    --quick`'s text8 model with L raised to 256 (hidden 64, cond 32, 2
    blocks of 2 heads, V=35) and a global batch of 4 as 2 micro-batches,
    for runs on the CPU."""
    if route not in TEXT8_ROUTES:
        raise ValueError(f'route must be one of {sorted(TEXT8_ROUTES)}, '
                         f'got {route!r}')
    if tiny:
        cfg = DITConfig(hidden_size=64, cond_dim=32, length=256, n_blocks=2,
                        n_heads=2, vocab_size=TEXT8_VOCAB)
        global_batch, micro = 4, 2
    else:
        cfg = DITConfig(hidden_size=768, cond_dim=128, length=256,
                        n_blocks=12, n_heads=12, vocab_size=TEXT8_VOCAB)
        global_batch, micro = TEXT8_TRAIN_GLOBAL_BATCH, TEXT8_TRAIN_MICRO_BATCH
    return _dit_train_setup(dataclasses.replace(cfg, **TEXT8_ROUTES[route]),
                            global_batch, micro)


def text8_train_flagship(device=None, *, seed: int = 0, tiny: bool = False,
                         route: str = 'fused_rope') -> TrainRun:
    """The text8 training run (`text8_train_setup(tiny=tiny, route=route)`)
    on `device`, weights seeded random in the reference layout, the train
    state's generator seeded with `seed`."""
    return _dit_train_run(text8_train_setup(tiny=tiny, route=route), device,
                          seed)


def _dit_train_run(setup: DiTTrainSetup, device, seed: int) -> TrainRun:
    device = resolve_device(device)
    cfg = setup.cfg
    model = DIT(cfg)
    model.load_state_dict(make_reference_dit_state_dict(
        np.random.RandomState(seed), hidden=cfg.hidden_size,
        cond_dim=cfg.cond_dim, n_blocks=cfg.n_blocks,
        vocab=cfg.vocab_size), strict=True)
    model = model.to(device)
    apply_fn = make_model_apply(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(gen, apply_fn.params, setup.optim,
                             setup.averaging)
    step = make_train_step(setup.spec, apply_fn, setup.optim,
                           setup.averaging,
                           accum_steps=setup.global_batch // setup.micro_batch)
    return TrainRun(spec=setup.spec, cfg=cfg, model=model, apply_fn=apply_fn,
                    optim=setup.optim, averaging=setup.averaging, state=state,
                    step=step, global_batch=setup.global_batch,
                    micro_batch=setup.micro_batch)


def dimamba_train_flagship(device=None, *, seed: int = 0,
                           tiny: bool = False,
                           route: str = 'fused_block') -> TrainRun:
    """The Species10 DiMamba training run on `device`, weights seeded random
    in the reference layout, the train state's generator seeded with `seed`,
    the mixer through `route` (DIMAMBA_ROUTES) with that route's
    micro-batch (DIMAMBA_TRAIN_MICRO_BATCH, DIMAMBA_DTLR_TRAIN_MICRO_BATCH).
    `tiny` is
    `dimamba_flagship(tiny=True)`'s model (hidden 32, 2 blocks, L=256)
    with a global batch of 4 as 2 micro-batches, for runs on the CPU."""
    device = resolve_device(device)
    cfg, model = _dimamba(tiny, seed, route)
    global_batch, micro = ((4, 2) if tiny else
                           (DIMAMBA_TRAIN_GLOBAL_BATCH,
                            DIMAMBA_TRAIN_MICRO_BATCH if route == 'fused_block'
                            else DIMAMBA_DTLR_TRAIN_MICRO_BATCH))
    spec = DiffusionSpec(diffusion='uniform', parameterization='d3pm',
                         noise=LogLinearNoise(), vocab_size=DNA_VOCAB,
                         mask_index=DNA_MASK, num_classes=cfg.num_classes,
                         time_conditioning=True, zero_recon_loss=True,
                         cond_dropout=0.1, antithetic_sampling=True,
                         sampling_eps=1e-3)
    model = model.to(device)
    apply_fn = make_model_apply(model)
    optim = OptimSpec(lr=2e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                      weight_decay=0.0, grad_clip=1.0,
                      scheduler='constant_warmup', num_warmup_steps=2500)
    avg = AveragingSpec.ema(0.9999)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(gen, apply_fn.params, optim, avg)
    step = make_train_step(spec, apply_fn, optim, avg,
                           accum_steps=global_batch // micro)
    return TrainRun(spec=spec, cfg=cfg, model=model, apply_fn=apply_fn,
                    optim=optim, averaging=avg, state=state, step=step,
                    global_batch=global_batch, micro_batch=micro,
                    tokens=DNA_BASES)


UNET_TRAIN_GLOBAL_BATCH = 512
# The fastest micro-batch of the card's sweep whose step peaks under half of
# an 80 GB card (PERF.md §4; scripts/profile_torch_train.py --model unet
# --sweep).
UNET_TRAIN_MICRO_BATCH = 256


def class_pattern_images(cond: torch.Tensor, generator: torch.Generator, *,
                         image_size: int, channels: int = 3,
                         noise: float = 24.0) -> torch.Tensor:
    """Synthetic pixel tokens for class labels `cond` (...,): (..., C * H *
    W) int32 in [0, 256), CHW order. Class c is a low-frequency plane wave
    (c % 3 + 1 periods down the image, c // 3 across, phase 0.7 c, each
    channel a third of a period on), 127.5 + 80 sin(...), plus N(0,
    `noise`^2) from `generator` a pixel, rounded and clipped."""
    dev = cond.device
    c = cond.long()[..., None, None, None].float()
    ch = torch.arange(channels, device=dev).float()[:, None, None]
    pos = torch.arange(image_size, device=dev).float() / image_size
    phase = 2 * math.pi * (((c % 3) + 1) * pos[:, None]
                           + torch.div(c, 3, rounding_mode='floor')
                           * pos[None, :]) + 0.7 * c + 2 * math.pi * ch / 3
    img = 127.5 + 80.0 * torch.sin(phase)
    img = img + noise * torch.randn(img.shape, generator=generator,
                                    device=dev)
    tokens = torch.clamp(torch.round(img), 0, 255).to(torch.int32)
    return tokens.reshape(*cond.shape, -1)


@dataclasses.dataclass
class UNetTrainRun(TrainRun):
    """What `unet_train_flagship` builds: its batches are class-pattern
    images (`class_pattern_images`), not uniform tokens."""

    def batch(self, generator: torch.Generator) -> dict:
        """A synthetic global batch, shaped (accum, micro, L) when
        accumulating: a class label per image ('cond', uniform over the
        classes) and its class-pattern image."""
        shape = (self.global_batch,)
        if self.accum_steps > 1:
            shape = (self.accum_steps, self.micro_batch)
        cond = torch.randint(0, self.cfg.num_classes, shape,
                             generator=generator, device=generator.device,
                             dtype=torch.int32)
        ids = class_pattern_images(cond, generator,
                                   image_size=self.cfg.image_size,
                                   channels=self.cfg.input_channels)
        return {'input_ids': ids, 'cond': cond,
                'attention_mask': torch.ones(ids.shape, device=ids.device)}


def unet_train_flagship(device=None, *, seed: int = 0,
                        tiny: bool = False) -> UNetTrainRun:
    """The CIFAR10 UNet training run of
    `scripts/train_cifar10_unet_guidance.sh` on `device`: the UNet of
    `configs/model/unet.yaml` (ch 128, 2 res blocks, 4 scales of (1, 2, 2,
    2), attention at 16 x 16, dropout 0.1) with 10 classes over V=256 pixel
    values, bf16 compute with float32 GroupNorm outputs (the plain norms
    under autograd, as JAX trains); uniform-state D3PM in continuous time
    with the log-linear schedule, antithetic t (eps 1e-3), sigma
    conditioning, `zero_recon_loss` and CFG cond dropout 0.1; AdamW (lr
    2e-4, betas 0.9/0.999, eps 1e-8, no weight decay, clip 1.0) with 2500
    warmup steps, EMA 0.9999; a global batch of 512 images as
    micro-batches of UNET_TRAIN_MICRO_BATCH. Weights seeded random as the
    JAX module initialises them, the train state's generator seeded with
    `seed`. Its batches are synthetic class-pattern images
    (`class_pattern_images`): real CIFAR-10 waits for its data files in the
    repository. `tiny` is `unet_flagship(tiny=True)`'s model with a global
    batch of 4 as 2 micro-batches, for runs on the CPU."""
    device = resolve_device(device)
    cfg = dataclasses.replace(_unet_cfg(tiny), dropout=0.1,
                              compute_dtype=torch.bfloat16,
                              norm_dtype=torch.float32, fused_norm=False)
    global_batch, micro = ((4, 2) if tiny else
                           (UNET_TRAIN_GLOBAL_BATCH, UNET_TRAIN_MICRO_BATCH))
    spec = _unet_spec(cfg, zero_recon_loss=True, cond_dropout=0.1,
                      antithetic_sampling=True, sampling_eps=1e-3)
    model = _unet_model(cfg, seed).to(device)
    apply_fn = make_model_apply(model)
    optim = OptimSpec(lr=2e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                      weight_decay=0.0, grad_clip=1.0,
                      scheduler='constant_warmup', num_warmup_steps=2500)
    avg = AveragingSpec.ema(0.9999)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_train_state(gen, apply_fn.params, optim, avg)
    step = make_train_step(spec, apply_fn, optim, avg,
                           accum_steps=global_batch // micro)
    return UNetTrainRun(spec=spec, cfg=cfg, model=model, apply_fn=apply_fn,
                        optim=optim, averaging=avg, state=state, step=step,
                        global_batch=global_batch, micro_batch=micro)


@dataclasses.dataclass
class ARRun:
    """What the AR entry points build: a model (its `apply_fn` and
    `params`), the sampling settings and, for FUDGE and PPLM, the
    classifier. `sample(generator)` draws one batch through
    `samplers.ar_sample`."""
    spec: DiffusionSpec
    cfg: object                 # DITConfig or DiMambaConfig
    apply_fn: object
    params: dict
    sampler: SamplerSpec
    guidance: Optional[GuidanceSpec]
    batch_size: int
    length: int
    bos_token_id: int = 0
    # The stateful decode's config (the model's), or None for the full
    # causal forward each step.
    decode_cfg: object = None
    classifier_cfg: Optional[DITConfig] = None
    classifier_apply: object = None
    classifier_params: Optional[dict] = None

    def sample(self, generator: torch.Generator,
               batch_size: Optional[int] = None,
               length: Optional[int] = None,
               guided: bool = True) -> torch.Tensor:
        """(batch_size, length) int32 tokens on `generator.device`;
        `guided=False` samples without the guidance, from the same
        noise draw."""
        B = batch_size or self.batch_size
        guidance = self.guidance if guided else None
        cond = None
        if guidance is not None and guidance.method == 'cfg':
            cond = torch.full((B,), guidance.condition, dtype=torch.int32,
                              device=generator.device)
        return ar_sample(self.spec, self.sampler, self.apply_fn, self.params,
                         generator, batch_size=B,
                         length=length or self.length,
                         bos_token_id=self.bos_token_id, guidance=guidance,
                         cond=cond, classifier_apply=self.classifier_apply,
                         classifier_params=self.classifier_params,
                         decode_cfg=self.decode_cfg)


AR_BATCH = 256                   # bench.py's `ar` line
QM9_AR_BATCH = 16                # the QM9 eval protocol
DIMAMBA_AR_BATCH = 8             # the Species10 serving batch


def _ar_spec(vocab: int, mask: int, num_classes=None) -> DiffusionSpec:
    return DiffusionSpec(diffusion='absorbing_state', parameterization='ar',
                         noise=LogLinearNoise(), vocab_size=vocab,
                         mask_index=mask, num_classes=num_classes)


def _causal_dit(cfg: DITConfig, seed: int, device):
    """A causal DIT with seeded random weights in the reference layout
    (the class table and adaLN projections when `cfg.num_classes`), in
    eval mode on `device`: its `make_model_apply` adapter."""
    model = DIT(cfg)
    model.load_state_dict(make_reference_dit_state_dict(
        np.random.RandomState(seed), hidden=cfg.hidden_size,
        cond_dim=cfg.cond_dim, n_blocks=cfg.n_blocks, vocab=cfg.vocab_size,
        with_cond=cfg.num_classes is not None, causal=True), strict=True)
    return make_model_apply(model.to(device).eval())


def ar_flagship(tiny: bool = False, device=None, *, seed: int = 0,
                int8_kv: bool = False) -> ARRun:
    """The JAX bench's `ar` line (`int8_kv`: `ar_int8`) on `device`. `tiny`
    is a CPU-sized cut: hidden 64, cond 32, 2 blocks of 2 heads, L=32,
    V=258, B=4."""
    device = resolve_device(device)
    if tiny:
        cfg = DITConfig(hidden_size=64, cond_dim=32, length=32, n_blocks=2,
                        n_heads=2, vocab_size=258)
    else:
        cfg = DITConfig(hidden_size=768, cond_dim=128, length=128,
                        n_blocks=12, n_heads=12, vocab_size=30523)
    cfg = dataclasses.replace(cfg, num_classes=2, causal=True,
                              logits_dtype=torch.bfloat16,
                              fused_rope_attn=True, fused_adaln=True)
    apply_fn = _causal_dit(cfg, seed, device)
    return ARRun(spec=_ar_spec(cfg.vocab_size, cfg.vocab_size - 1, 2),
                 cfg=cfg, apply_fn=apply_fn, params=apply_fn.params,
                 sampler=SamplerSpec(ar_kv_int8=int8_kv),
                 guidance=GuidanceSpec(method='cfg', gamma=2.0, condition=0),
                 batch_size=4 if tiny else AR_BATCH, length=cfg.length,
                 decode_cfg=cfg)


def _qm9_ar(tiny: bool, seed: int, device, pooling: str):
    """The QM9 AR denoiser (seed) and a causal classifier in `pooling`
    (seed + 1): (spec, cfg, apply_fn, clf_cfg, clf_apply). `tiny`: the
    denoiser hidden 64, cond 32, 2 blocks of 2 heads at L=16; the
    classifier the same trunk."""
    device = resolve_device(device)
    if tiny:
        cfg = DITConfig(hidden_size=64, cond_dim=32, length=16, n_blocks=2,
                        n_heads=2)
    else:
        cfg = DITConfig(hidden_size=768, cond_dim=128, length=32,
                        n_blocks=12, n_heads=12)
    cfg = dataclasses.replace(cfg, dropout=0.0, vocab_size=QM9_VOCAB,
                              causal=True, num_classes=CLASSIFIER_CLASSES,
                              fused_rope_attn=True, fused_adaln=True)
    # `small-classifier` (tiny: the denoiser's trunk), causal without
    # adaLN, as `ddg_tpu/main.py` builds a classifier for an AR spec.
    clf_cfg = dataclasses.replace(cfg, dropout=0.1, num_classes=None,
                                  use_adaLN=False)
    apply_fn = _causal_dit(cfg, seed, device)
    clf = DITClassifier(clf_cfg, num_classes=CLASSIFIER_CLASSES,
                        pooling=pooling)
    clf.load_state_dict(make_reference_dit_classifier_state_dict(
        np.random.RandomState(seed + 1), hidden=clf_cfg.hidden_size,
        cond_dim=clf_cfg.cond_dim, n_blocks=clf_cfg.n_blocks,
        vocab=clf_cfg.vocab_size, num_classes=CLASSIFIER_CLASSES,
        causal=True), strict=True)
    clf_apply = make_classifier_apply(clf.to(device).eval())
    spec = _ar_spec(QM9_VOCAB, QM9_VOCAB - 1, CLASSIFIER_CLASSES)
    return spec, cfg, apply_fn, clf_cfg, clf_apply


def ar_fudge_flagship(tiny: bool = False, device=None, *,
                      seed: int = 0) -> ARRun:
    """FUDGE on the QM9 AR DiT-small with the causal `small-classifier` in
    `no_pooling` (weights from `seed` and `seed + 1`), topk 20, gamma 1,
    condition 0, B=16 (tiny: B=4), on `device`."""
    spec, cfg, apply_fn, clf_cfg, clf_apply = _qm9_ar(tiny, seed, device,
                                                      'no_pooling')
    return ARRun(spec=spec, cfg=cfg, apply_fn=apply_fn,
                 params=apply_fn.params, sampler=SamplerSpec(),
                 guidance=GuidanceSpec(method='fudge', topk=20, gamma=1.0,
                                       condition=0),
                 batch_size=4 if tiny else QM9_AR_BATCH, length=cfg.length,
                 classifier_cfg=clf_cfg, classifier_apply=clf_apply,
                 classifier_params=clf_apply.params)


def ar_pplm_flagship(tiny: bool = False, device=None, *,
                     seed: int = 0) -> ARRun:
    """PPLM (one Adagrad step of size 0.1, stability 0.01, condition 0) on
    the QM9 AR DiT-small with the causal `small-classifier` in mean pooling
    over the denoiser's hidden state, B=16 (tiny: B=4), on `device`."""
    spec, cfg, apply_fn, clf_cfg, clf_apply = _qm9_ar(tiny, seed, device,
                                                      'mean')
    return ARRun(spec=spec, cfg=cfg, apply_fn=apply_fn,
                 params=apply_fn.params, sampler=SamplerSpec(),
                 guidance=GuidanceSpec(method='pplm', condition=0,
                                       num_pplm_steps=1, pplm_step_size=0.1,
                                       pplm_stability_coef=0.01),
                 batch_size=4 if tiny else QM9_AR_BATCH, length=cfg.length,
                 classifier_cfg=clf_cfg, classifier_apply=clf_apply,
                 classifier_params=clf_apply.params)


def dimamba_ar_flagship(tiny: bool = False, device=None, *,
                        seed: int = 0) -> ARRun:
    """The Species10 AR baseline on `device`: the unidirectional,
    unconditional DiMamba (`dimamba_flagship`'s widths and vocabulary,
    `tiny` its CPU-sized cut) with seeded random weights, unguided, B=8
    (tiny: 2), from bos 0 through the stateful decode."""
    device = resolve_device(device)
    cfg, model = _dimamba(tiny, seed, 'fused_block', bidirectional=False,
                          num_classes=None)
    apply_fn = make_model_apply(model.to(device).eval())
    return ARRun(spec=_ar_spec(DNA_VOCAB, DNA_MASK), cfg=cfg,
                 apply_fn=apply_fn, params=apply_fn.params,
                 sampler=SamplerSpec(), guidance=None,
                 batch_size=2 if tiny else DIMAMBA_AR_BATCH,
                 length=cfg.length, decode_cfg=cfg)
