"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py [--phases build,kernels,eps,gates,sample,int8,blur,samplers,blur_deis,
                           f32,train,blur_train,run_lib] [--batch 16]

Phases (each prints one line per check; any failure raises and exits non-zero):
  1. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit;
  2. build: nvcc builds gddim_torch/csrc/*.cu (one process per source, in
     parallel), then K1's first launch;
  3. kernels: each of K1-K5 (K2-K4, and K9 below, also at B=16 and 64,
     apart from the kernels line, with their device time and share of the
     bf16 peak), and the int8 modes of K2-K5 with static and with
     per-sample scales (those of K2-K4, and K9's below, also at B=16 and 64,
     with their device time and share of the int8 peak), then the int8
     block GEMM alone at every int8 conv (B=4, and B=64 apart; its sums bit
     for bit against the exact conv) and its quantize pre-pass at every conv
     input, then the block GEMM's bf16 mode alone at every bf16 block conv
     (B=4 and 64, against the f32 conv, beside F.conv2d on channels_last
     bf16, eager and device time) and its bf16 pre-pass at every conv input
     it makes (at most one bf16 ulp off),
     at every sampling-path shape and K1 (f32, with
     and without SiLU) and K6-K8 at every training-path shape of the
     cld/accr_dcifar10 NCSN++ (B=4) against its plain version (K1-K8 in f32
     with TF32 off; the int8 modes against their int8 plain versions) on the
     same inputs, with timings and each call's bound (the least time the card
     could take: bytes over 3.35 TB/s or operations over the type's peak,
     whichever is larger); K7's 12 gradients each within its
     bound, and two K7 runs bit-identical; K6 with conv2's weight zero, where
     its output is the f32 residual (x + b2)/sqrt(2) to f32 rounding; then the
     layer-wise kernels at every shape of the trunk's layer-wise paths: K11
     (bf16, against its f32 plain version, with F.conv2d's time), K11-int8
     on the int8 block GEMM (bit-identical to its exact plain version, also
     with sums past 2^24 and a scalar scale; device time and int8-peak
     share beside the bare int8 GEMM's) and K12 (bf16 and f32 x: scales, int8
     values at most one step apart, its route's launches; device time and
     share of its bound), both at B=4, 16 and 64, and K1 without SiLU at the attention
     shapes beside F.group_norm's time; K11 bf16 again at B=16 and B=64
     (each shape beside F.conv2d, won or lost); K8 in f32 at the training
     batch (B=128) and in bf16 (against its plain version on the same bf16
     inputs) at B=16 and 64, each beside scaled_dot_product_attention in its
     dtype; then K9 (bf16, and int8 with static
     and per-sample scales) at the 6 transition shapes against its plain
     versions with the TPU kernel's rounding points, K10's forward and its 11
     gradients (f32) at the training attention shapes, and K2/K3/K4/K5/K9 on
     f32 activations (f32 out) at every main-path shape against the f32
     plain composition and against their plain versions with the TPU
     kernels' rounding points, the same bits on repeat, every block's convs
     on the block GEMM; then K5 (bf16, int8 static and per-sample)
     at B=4, 16 and 64 on both attention shapes with device time, share of
     the peak and, as its yardstick, the composition F.group_norm + matmul +
     SDPA + matmul; the bf16 mode also against its plain version with the
     TPU kernel's rounding points; its attention core alone (bf16, int8 and
     f32 outputs) against its plain version beside SDPA, and its two 1x1
     projections on the block GEMM alone beside torch.matmul (bf16) and
     torch._int_mm (int8); then the GroupNorm statistics kernel at every GN
     shape (bf16 and f32 x, B=4, 16 and 64) against gn_stats_reference,
     the same bits on repeat, beside torch.var_mean, and conv1's epilogue
     sums (GN2's partials) at every block conv1 (bf16 and int8, B=4 and 64,
     split-K shapes included) against gn2_partials_reference, with conv1's
     device time with and without them; then GN1 in one launch
     (gn_apply_kernel) at every main-path GN1 site (bf16, int8 static and
     per sample) and at the 6 transitions (its resample variant: h bf16, f32
     and int8), B=4, 16 and 64: the same bits as the launches it replaces
     and on repeat, against its plain version, its device time beside theirs
     and its bound; and the route each block's GN1 takes (one block call of
     each main-path kind, counted);
  4. eps: one full-width eps evaluation (B=4, t=0.5, seeded weights), kernel
     path in bf16 against the all-plain path in f32, the per-eval temb
     product (NCSNpp.temb_rows) against each block's exact projection, then
     the layer-wise paths ('pallas' and 'int8') against the same f32 path,
     with the launch counts of each evaluation;
  4b. gates: each whole-block gate against its tile plans at every block of
     both configs at nf = 32, 64 and 128, then one full-width-depth eps
     evaluation at nf = 32 and 64 through 'fused' and 'fused_int8' (static
     scales calibrated on the card) against the f32 plain path, with the
     blocks the kernels took and those that ran the plain composition;
  5. sample: CLD deis-2 NFE=50 sampling through gddim_torch.run_lib's sampling
     function (B=16, seeded weights) with the transitions through K4
     (transition_impl 'tail'): finite samples, launch counts, wall time;
     then the same with 'full' (K9), its samples against the K4 path's (the
     int8 and blur phases repeat their 'fused_int8' run so too);
  6. int8: the int8 path (conv_impl 'fused_int8'): static scales calibrated on
     the card (gddim_torch.cli.calibrate_int8), one full-width eps evaluation
     (B=4, t=0.5) with static scales against the bf16 kernel path and the f32
     plain path, and with per-sample scales against the f32 plain path, with
     the launch counts; then NFE=50 sampling at B=16 from the same seed as the
     bf16 run: finite samples, launch counts, wall time, and the pixel
     correlation and max|dx| of the int8 samples against the bf16 ones;
  7. blur: blur/ddpm_deep_cifar10 order-0 NFE=50 sampling at B=16 through
     gddim_torch.run_lib's sampling loop, one seed, conv_impl 'fused', then
     'int8' (layer-wise: K12, K11-int8, K1, K8), 'fused_int8' (calibrated on
     the card) and 'pallas' (layer-wise: K1, K11, K8): finite samples, launch
     counts, wall time, and each other run's pixel correlation and mean|dx|
     against the 'fused' samples;
  7a. samplers: the CLD samplers beside deis (order0, order0 with is_em,
     hybdeis, mldeis, ldeis, sdeis lambda=1 order 2, em lambda=1, sscs) at
     NFE=50 and --batch through gddim_torch.cli.build_sampling_fn (seeded
     weights, the transitions 'full'): each on the f32 plain path, then
     bf16 ('fused') and int8 ('fused_int8', static scales calibrated on the
     card) from the same generator seed (the same u0 and normals): every
     network output finite, launches nfe x the per-eval table, img/s, and
     the pixel correlation and mean|dx| against the plain samples (bf16 at
     SAMPLER_BF16_BOUND, int8 at SAMPLE_INT8_BOUND); then
     ode at B=4 (solve_ivp at the config's tolerances), plain and bf16,
     its nfe and seconds;
  7b. blur_deis: blur/ddpm_deep_cifar10 frequency-space deis (order 2,
     NFE=50, --batch) on the f32 plain path, then 'fused' and 'fused_int8'
     ('full'), with the same gates ('fused_int8' also against 'fused');
  7c. f32: the f32 path (model.dtype float32, conv_impl 'fused', the
     transitions 'full'): one full-width eps evaluation (B=4, t=0.5)
     against the f32 plain path with its launch counts (every block on the
     block GEMM's routes), CLD deis-2 NFE=50 sampling at --batch through
     gddim_torch.run_lib's sampling loop (finite samples, launch counts,
     wall time), one traced eval at B=64 (kernels, device time as their sum
     and their union);
  8. train: the full-width model in f32 (seeded weights) at the config's
     training batch (128): one loss + backward on the kernel path against the
     all-plain path with the same t, z and dropout masks (loss, gradient
     norm, worst per-tensor error), with training.fused_attn off and on (K10);
     then training.n_jitted_steps Adam steps through gddim_torch.run_lib's
     train loop (the CLI's train mode) with each setting: finite loss and
     parameters, launch counts per step; img/s and peak memory of the
     kernel path (K10 off and on) and
     of the plain path for information;
  9. blur_train: blur/ddpm_deep_cifar10 in f32 at B=128, dropout 0.1: one
     loss + backward with model.fused_train on (K6/K7) and off (the
     stride-1 blocks' unfused layers, K1 for their GroupNorms) against the
     all-plain path with
     the same t, z and masks (the train phase's bounds); then
     training.n_jitted_steps Adam steps through gddim_torch.run_lib's train
     loop with each setting (launch counts per step), and img/s and peak
     memory of both;
 10. run_lib: the run harness through gddim_torch.cli at full width
     (cld/accr_dcifar10) on a seeded CIFAR-10 fixture in its pickle layout:
     --mode train 20 steps at B=128 (evals, snapshots, preemption
     checkpoints and NFE=50 sample grids every 10 steps), resumed to 30 from
     its meta checkpoint (every tensor and the generator bit for bit),
     --mode sampling from snapshot 2 and again (nothing rewritten),
     fid_stats and fid (proxy extractor: finite fid, IS, KID), --mode eval of
     snapshots 1-2 and again (read back from eval_meta.json), a full-width
     legacy export restored bit for bit whose samples equal the snapshot's,
     and InceptionV3 at B=64; each run's launches held to the per-step and
     per-eval tables; the loop's img/s, the save and restore seconds.
Then one line {"kernels": [...]}, one line with the card's name and power
limit, and last {"ok": true, "device": {...}}.

``--phases blur_span`` (not in the default run) traces the blur layer-wise
'int8' and 'pallas' evals at B=64 and 16, twice each: kernels, device time
(sum and union), K11 int8's, K12's, K11's and K1's totals; ``--phases
f32_time`` times K2/K3/K4/K5/K9 on f32 activations at every shape at
B=4/16/64 beside F.conv2d, ``--phases f32_span`` traces the f32 B=64 eval
twice, ``--phases k1_time`` times K1 at its sites (bf16, f32, with and
without SiLU) at B=4/16/64 beside F.group_norm (``--k1-save`` /
``--k1-ref`` hold two trees' outputs against each other); a parent's
checkout runs each of these too.
``--phases profile`` (not in the default run) traces one eval of the CLD bf16
and int8 kernel paths, then of the same with transition_impl 'tail' and
'full', then of the blur 'fused_int8' and layer-wise 'int8' and 'pallas' paths, at
``--batch`` with torch.profiler and prints the wall, the device time, the
kernels that take it and each counted kernel's launches in that eval (GN1's
gn_apply_kernel, gn_stats_kernel, the pre-passes and K9's resample apart; a
gn_stats_kernel or transition_resample_kernel launch fails it). ``--phases
ab`` (not in the default run) times CLD
NFE=50 sampling with the transitions through K4 and through K9, bf16 and
int8 static, at B=16 and B=64, five rounds of tail, full, full, tail, with
each cell's medians and pairs won: the A/B behind
``model.transition_impl``'s default.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Bounds on max|kernel - plain| / max|plain|. K1-K5: bf16 inputs and weights,
# f32 plain version; the kernels write bf16 (a relative rounding of up to 2^-8 =
# 3.9e-3 per element) and measured 1.9e-3 to 3.4e-3 at every main-path shape
# on an H100; the bounds leave about 3x margin over that.
KERNEL_BOUND = {"K1": 1e-2, "K2": 1e-2, "K3": 1e-2, "K4": 1e-2, "K5": 1e-2,
                # K6: f32 in and out, bf16 MMA operands: measured 1.3e-3 to 3.0e-3
                # at every training-path shape on an H100 (f32 inputs)
                "K6": 1e-2,
                # K8 in f32: 3xTF32 on the tensor cores, f32 partial sums;
                # the f32 FMA form it replaced measured 3.5e-7 to 1.8e-6
                "K8": 1e-5}
# K8 in bf16 against the plain version on the same bf16 inputs: the same
# rounding points (normalised weights rounded to bf16, f32 sums), so a bf16
# rounding of a weight or of the output flipping on f32 summation order
K8_BF16_BOUND = 1e-2
# K1 in f32 (the training path's dtype) against the plain f32 version: both
# reduce in f32 with a two-pass variance, so only the summation order differs;
# measured 1.6e-7 to 3.1e-7 at the 12 training-path cases on an H100
K1_F32_BOUND = 1e-6
# K6 with conv2's weight zero: its output is (x + b2)/sqrt(2) computed in f32,
# so x must reach the residual unrounded (a bf16 x would be off by ~2e-3);
# measured 0 (the kernel rounds as the plain version does) on an H100
K6_RESIDUAL_BOUND = 1e-6
# The training GEMMs alone (K6/K7's convs and dgrads on the block GEMM, K7's
# weight gradients on wgrad_kernel) against their plain versions on the same
# bf16 operands: f32 sums in another order only, of up to 131072 products (a
# wgrad at B=128 32x32: 1.5e-5 measured on an H100)
TRAIN_GEMM_BOUND = 1e-4
# K7, per gradient, against autograd of the plain f32 block. The gradients
# that pass through bf16 tensor-core operands measured 1.4e-3 to 5.2e-3 on an
# H100; db2 and db_skip are f32 sums of the cotangent only (2.7e-7 at most).
K7_BOUND = {name: 1.5e-2 for name in ("dx", "dtemb", "dgn1s", "dgn1b", "dw1", "db1", "dgn2s",
                                      "dgn2b", "dw2", "dwsk")}
K7_BOUND.update(db2=1e-6, dbsk=1e-6)
# Full-width train step (B=128), kernel path vs all-plain f32 path on the same
# t, z and masks, on an H100: loss 1.7e-4, gradient norm 1.6e-3. Per gradient
# tensor, max|kernel - plain| / max|plain| and the L2 ratio: the error grows
# with the depth a gradient has passed through bf16 MMA operands (K7 runs in
# 70 blocks), so tensors whose largest gradient is at least DEEP_SHARE of the
# largest of all measured 1.65e-2 (L2 1.22e-2) and the smaller, deeper ones
# (766 of 962, down to 6e-9 of the largest) 7.64e-2 (L2 4.99e-2). About 3x.
TRAIN_BOUND = {"loss": 5e-4, "grad_norm": 5e-3, "worst_tensor": 5e-2, "worst_tensor_l2": 4e-2,
               "worst_deep_tensor": 0.25, "worst_deep_tensor_l2": 0.15,
               # the key biases' error against LEAF_FLOOR of the largest: measured
               # 0.9e-8 to 1.1e-8, the noise of two computations of an exact zero
               "key_bias": 5e-8}
DEEP_SHARE = 1e-3
# The attention key bias's exact gradient is zero (softmax ignores a constant
# added to every logit of a row), so its tensor is rounding noise (1e-11 of
# the largest gradient): its error is measured against LEAF_FLOOR of the
# largest gradient. Every other tensor is measured on its own scale, however
# small its gradient.
LEAF_FLOOR = 1e-3
# The int8 modes against their int8 plain versions (the same int8 weights
# and scales, f32 inputs holding the bf16 values): both quantize alike, so the
# gap is the kernels' bf16 output and the rare value whose rounding flips on
# an f32 last-bit difference; measured 1.8e-3 to 3.5e-3 at every sampling-path
# shape, static and per-sample, on an H100
KERNEL_BOUND.update({"K2-int8": 1e-2, "K3-int8": 1e-2, "K4-int8": 1e-2, "K5-int8": 1e-2})
# Whole network, bf16 kernel path vs f32 plain path: measured 7.1e-3 and
# 7.6e-3 (seeded weights, B=4, t=0.5); about 2.5x margin.
EPS_BOUND = 2e-2
# Whole network through the int8 kernels (B=4, t=0.5, seeded weights), max
# |int8 - other| / max |other|: static scales against the bf16 kernel path
# and the f32 plain path, per-sample scales against the f32 plain path;
# measured 5.1e-2, 5.0e-2 and 3.2e-2 on an H100, about 3x
EPS_INT8_BOUND = {"static_vs_bf16": 0.15, "static_vs_f32": 0.15, "dynamic_vs_f32": 0.1}
# NFE=50 int8 samples against the bf16 samples from the same seed (uint8
# images / 255): pixel correlation measured 0.99115 on an H100, so at least
# 1 - 3 * 0.00885; mean |dx| measured 0.00439, bounded at about 3x. max|dx|
# reads 1: the random weights drive some pixels to 0 or 255, and one pixel
# that lands on opposite ends in the two runs reaches the whole range.
SAMPLE_INT8_BOUND = {"corr": 0.97, "mean_dx": 0.015, "max_dx": 1.0}
# The layer-wise kernels against their plain versions. K11 bf16: f32 sums in
# another order, one bf16 rounding (as K2-K5). K11-int8: exact int32 sums and
# the plain version's dequant arithmetic, so bit-identical (bound 0). K12:
# the dequantized values q * s, one int8 step of the sample's amax at most
# (1/127 = 7.9e-3), with its scales within K12_SCALE_BOUND and at most
# K12_FLIP_SHARE of the int8 values one step apart (a value on a half step
# flips on a last-bit difference of the f32 GroupNorm).
KERNEL_BOUND.update({"K11": 1e-2, "K11-int8": 0.0, "K12": 1e-2})
# K9 against its plain versions with the TPU kernel's rounding points (bf16,
# and int8 with exact sums): the K4 path's bf16 h1 and output roundings, and
# an int8 value on a half step flipping, as K2-K5's; measured 3.2e-3 to
# 4.5e-3 (bf16) and 1.7e-3 to 3.9e-3 (int8) at the 6 shapes on an H100.
# K10's forward is K5 on f32 activations against the f32 plain composition,
# measured 9.8e-4 and 2.5e-3; its gradients are the plain composition's VJP
# on the same inputs, the same sums (measured 0)
KERNEL_BOUND.update({"K9": 1e-2, "K9-int8": 1e-2, "K10": 1e-2})
# K5 bf16 against its plain version with the TPU kernel's rounding points
# (attnblock_bf16_reference: h, q/k/v, p and a rounded to bf16 where the TPU
# kernel rounds them; f32 out), on the same inputs: measured 2.1e-3 to
# 2.4e-3 at B=4/16/64 on both shapes on an H100 (the kernel's bf16 output
# rounding); about 3x
K5_RP_BOUND = 7e-3
# K5's attention core against its plain version on the same bf16 q, k, v:
# the same rounding points, so a differs where f32 summation order flips a
# bf16 rounding of p or a. Measured on an H100: bf16 a 8.8e-4 to 3.2e-3 of
# max|a|; f32 a 1.1e-3, amax 7e-7; int8 a one step apart on up to 5.7e-4 of
# the values. Held to KERNEL_BOUND, one int8 step on at most S8_FLIP_SHARE
# of the values, and bf16 values differing on at most core_flip_share(S) of
# them: the gate that tells the TPU kernel's rounding points apart (a core
# that normalises late or leaves p unrounded moves max|diff| / max|a| by
# only 6e-3 to 8e-3, but flips 29-44% of the values on a block's q, k, v:
# tests/test_torch_attnblock.py)
KERNEL_BOUND.update({"K5-core": 1e-2})


def core_flip_share(s: int) -> float:
    """The share of the core's bf16 a that may differ from its plain
    version at S keys, about 3x the H100's: at S >= 64, 3e-3 (measured 4.1e-4
    to 1.1e-3); at S < 64, 1e-2 (measured up to 4.2e-3 at S=16, where each
    p is ~1/16 and one flipped p moves a by ~1/4 of its ulp, not ~1/16)."""
    return 3e-3 if s >= 64 else 1e-2
# The int8 block GEMM alone (unit scales): its int32 sums against the exact
# float64 conv's, bit for bit (bound 0; every sum under 2^24, where f32
# holds it exactly). Its quantize pre-pass against the plain version: at
# most one int8 step apart, and at most S8_FLIP_SHARE of the values (a
# value on a half step flips on the last bit of the kernel's FMA or SiLU)
KERNEL_BOUND.update({"S8-GEMM": 0.0, "S8-prepass": 1.0})
S8_FLIP_SHARE = 1e-3
# The bf16 block GEMM alone against the f32 conv of the same bf16 values:
# f32 sums in another order and f32 out, held to K11's gate (1e-2). Its
# pre-pass against the plain version: at most one bf16 ulp apart, on at most
# BF16_FLIP_SHARE of the values (a value near a rounding boundary flips on
# the last bit of the kernel's SiLU, __expf and a division)
KERNEL_BOUND.update({"BF16-GEMM": 1e-2, "BF16-prepass": 1.0})
BF16_FLIP_SHARE = 1e-3
# The GroupNorm statistics kernel against gn_stats_reference (the TPU
# kernels' E[x^2] - mean^2 from f32 per-channel sums, in another order of
# the same f32 sums), worst of the affine, mean and rstd over the largest of
# each: measured 1.1e-7 to 3.5e-7 at every GN shape (B=4/16/64, bf16 and f32
# x) on an H100; and the block GEMM's epilogue sums (GN2's partials of
# conv1's h1) against gn2_partials_reference of the same h1 under the same
# tile plan: measured 9.8e-8 to 2.6e-7. About 3x. Both also the same bits
# on repeat (a fixed order, no float atomics).
KERNEL_BOUND.update({"GN-stats": 1e-6, "GN2-sums": 1e-6})
# GN1 in one launch (gn_apply_kernel) against the launches it replaces
# (gn_stats_kernel, then the pre-pass, the per-sample amax pass or K9's
# transition_resample_kernel, through the bare wrappers with ctas 0): the
# same bits, as it sums in gn_stats_kernel's order and converts with the
# pre-pass's and the resample's arithmetic. Against its plain versions: the
# statistics (and the per-sample amax) within GN-stats' bound; the bf16 and
# int8 outputs against the plain conversion from the kernel's own statistics
# one ulp or step apart on at most BF16_FLIP_SHARE / S8_FLIP_SHARE of the
# values, as the pre-passes (KERNEL_BOUND["GN-apply"]: the largest
# difference, in ulps or steps); K9's q(h) likewise against the plain
# resample; its bf16 and f32 h (and the per-sample amax) within
# GN_RESAMPLE_BOUND of max|h|, K9's own gate (KERNEL_BOUND["K9"]): a bf16
# activation that rounds the other way (the kernel's fused multiply-add, the
# statistics' last bits) moves h by a tap's share of one ulp of that
# activation, which may be several ulps of a small h.
KERNEL_BOUND.update({"GN-apply": 1.0})
GN_RESAMPLE_BOUND = 1e-2
# K7's GroupNorm(+SiLU) backward alone (gn_bwd_kernel) against its plain
# version on the same f32 inputs: f32 sums in another order, so dL/dv, the
# per-sample partials, g's sums and dtemb within KERNEL_BOUND["GN-bwd"] of
# their largest values; GN2's gumm (bf16) differing on at most
# BF16_FLIP_SHARE of its values, each by one ulp or within the same bound
# of max|o| (gumm_flips); the same bits on repeat
KERNEL_BOUND.update({"GN-bwd": 1e-5})
# GN2's folding pre-pass (gn_prepass_kernel): its fold (gn_fold_kernel's,
# the same arithmetic; in training the fold it writes out, the same bits)
# within GN-stats' bound of the plain fold, and its output against the
# plain conversion from that fold one ulp or step apart on at most
# BF16_FLIP_SHARE / S8_FLIP_SHARE of the values, as the pre-passes; the
# same bits on repeat
KERNEL_BOUND.update({"GN2-prepass": 1.0})
# The per-eval temb product (one f32 addmm of the 76 blocks' Dense weights,
# TF32 off) against each block's own projection computed exactly (float64):
# the f32 rounding of 512-term dot products in cuBLAS's order, measured
# 1.11e-6 at B=64 on an H100 (the per-block f32 products 2.7e-7: another
# kernel and order; the CPU tests hold the CPU's product to 1e-6); about 3x.
# Beside it, the per-block f32 products against the same, and the two f32
# products against each other, for information.
TEMB_ROWS_BOUND = 4e-6
K10_GRAD_BOUND = 1e-5
# The K2-K5 wrappers on f32 activations write f32 (bf16 MMA operands) against
# the f32 plain composition: measured 7.5e-4 to 1.26e-3 on an H100, about 3x
F32_ACT_BOUND = 4e-3
# ... against their plain versions with the TPU kernels' rounding points
# (bf16 MMA operands, f32 elsewhere): the same roundings, f32 sums in another
# order, which flip a bf16 rounding of an operand now and then; measured
# 6.5e-7 to 7.5e-4 at every main-path shape on an H100 (on the block GEMM;
# 7.5e-4 K5 at 4x4), about 2.7x
F32_TPU_BOUND = 2e-3
# The whole network on f32 activations (model.dtype float32, 'fused') against
# the f32 plain path: measured 3.6e-3 on an H100 (B=4, t=0.5, seeded
# weights), about 2.7x
EPS_F32_BOUND = 1e-2
# NFE=50 samples through K9 against the K4 path's of the same seed (uint8
# images / 255): bf16 roundings moved within each transition. Measured on an
# H100: CLD bf16 corr 0.99914, mean|dx| 0.00044; the int8 runs, where a moved
# rounding flips int8 values that compound over the trajectory, CLD 0.99147 /
# 0.00424 and blur 0.98376 / 0.00812; held to the int8 samples' gate
SAMPLE_K9_BOUND = {"corr": 0.97, "mean_dx": 0.015}
K12_SCALE_BOUND = 1e-5
K12_FLIP_SHARE = 1e-3
# The layer-wise paths of the whole network against the f32 plain path
# (B=4, t=0.5, seeded weights)
EPS_LAYER_BOUND = {"pallas_vs_f32": 2e-2, "int8_vs_f32": 0.1}
# Blur NFE=50 samples of another path against the 'fused' (bf16) samples of
# the same seed: the int8 runs are gated as the CLD int8 samples are
# (SAMPLE_INT8_BOUND); 'pallas' is bf16 too and held to the same gate
# kernel launches per eps evaluation of cld/accr_dcifar10
PER_EVAL = {"K1": 7, "K2": 34, "K3": 36, "K4": 6, "K5": 10}
# ... of its layer-wise paths (and blur/ddpm_deep_cifar10's, the same trunk):
# K1 in the 6 transitions' GN1, the 10 attention GNs and the head, and
# ('pallas') every other GN; K12 in the 70 stride-1 and pair blocks' GN1 and
# all 76 GN2s; K11 in the 76 blocks' two convs; K8 in the 10 attention blocks
PER_EVAL_PALLAS = {"K1": 163, "K11": 152, "K8": 10}
PER_EVAL_LAYER_INT8 = {"K1": 17, "K12": 146, "K11-int8": 152, "K8": 10,
                       # counted in C: K11 int8's block GEMM launches, and K12 as
                       # one gn_apply_kernel launch at each of its 146 sites
                       "S8-GEMM": 152, "GN-apply": 146}
# ... of its int8 path: the same blocks through the int8 modes
PER_EVAL_INT8 = {"K1": 7, "K2-int8": 34, "K3-int8": 36, "K4-int8": 6, "K5-int8": 10}
# ... with model.transition_impl 'full': the 6 transitions through K9 (K1 only
# in the head)
PER_EVAL_FULL = {"K1": 1, "K2": 34, "K3": 36, "K9": 6, "K5": 10}
PER_EVAL_INT8_FULL = {"K1": 1, "K2-int8": 34, "K3-int8": 36, "K9-int8": 6, "K5-int8": 10}
# ... on f32 activations (model.dtype float32, 'fused', transitions 'full'):
# the bf16 modes on f32 x, every conv and projection on the block GEMM (172);
# GN1's statistics by gn_stats_kernel (the 34 K2, 36 K3, 6 K9 and 10 K5
# GroupNorms) and its bf16 pre-pass (70 conv1 operands, 10 K5 h), GN2's
# folding pre-pass (76; a bf16 pre-pass too); no gn_apply_kernel
PER_EVAL_F32 = {"K1": 1, "K2": 34, "K3": 36, "K9": 6, "K5": 10, "BF16-GEMM": 172,
                "BF16-prepass": 156, "K5-core": 10, "GN-stats": 86, "GN2-prepass": 76}
# the int8 block GEMM and its quantize pre-pass: once per conv of the 76
# int8 residual blocks (K2-K4 or K9 int8) and twice (q/k/v, output) in each
# of the 10 int8 attention blocks, the pre-pass once there (h; static
# scales: the core quantizes a), counted in C where each kernel is launched
# (DEVICE_COUNTED); K5's attention core once an attention block
# (GN1's gn_apply_kernel makes conv1's and K5's h; GN2's folding pre-pass
# makes every conv2's operand, K4's conv1 quantizes h; K9's static mode
# quantizes h in its gn_apply_kernel launch, so its conv1 takes no pre-pass)
for _per_eval, _n in ((PER_EVAL_INT8, 82), (PER_EVAL_INT8_FULL, 76)):
    _per_eval.update({"S8-GEMM": 172, "S8-prepass": _n, "K5-core": 10})
# ... and in the bf16 path its bf16 mode: once per conv of the 76 bf16 blocks
# (K2-K4 or K9) and twice in each attention block, the pre-pass before the
# 76 conv2s (GN2's folding pre-pass; K4's and K9's conv1 read h as it is)
for _per_eval in (PER_EVAL, PER_EVAL_FULL):
    _per_eval.update({"BF16-GEMM": 172, "BF16-prepass": 76, "K5-core": 10})
# GN2's folding pre-pass, counted apart too: the 76 blocks' conv2 operand
# in every block path (bf16, int8 static)
for _per_eval in (PER_EVAL, PER_EVAL_FULL, PER_EVAL_INT8, PER_EVAL_INT8_FULL):
    _per_eval["GN2-prepass"] = 76
# GN1 in one launch (gn_apply_kernel): the 34 K2 and 36 K3 blocks' conv1
# operand and the 10 attention blocks' h (in place of gn_stats_kernel and
# the pre-pass), and with transition_impl 'full' K9's 6 GN1s and resamples
# (in place of gn_stats_kernel and transition_resample_kernel); no
# gn_stats_kernel launch is left on the sampling path (launches_of raises on
# one); K4's GN1 stays K1's
for _per_eval, _n in ((PER_EVAL, 80), (PER_EVAL_INT8, 80), (PER_EVAL_FULL, 86),
                      (PER_EVAL_INT8_FULL, 86)):
    _per_eval["GN-apply"] = _n
# H100 SXM peaks (NVIDIA's data sheet, dense): operations per second by type,
# and device memory bytes per second
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
HBM = 3.35e12
# kernel launches per training step: K1 in the 6 transitions (GN1, GN2), the
# 10 attention blocks and norm_out; K6 forward and K7 backward in the 34
# stride-1 and 36 concatenated up-path blocks (37 of the 70 with a 1x1
# skip); K8 in the 10 attention blocks
TRAIN_BLOCKS, SKIP_BLOCKS = 70, 37
PER_STEP = {"K1": 23, "K6": TRAIN_BLOCKS, "K7": TRAIN_BLOCKS, "K8": 10,
            # GN1's statistics of x in K6 and in K7's recompute (GN2's come
            # from conv1's epilogue in both)
            "GN-stats": 2 * TRAIN_BLOCKS,
            # the block GEMM: K6's two convs; K7's conv1, two dgrads and the
            # skip's dgrad
            "train-GEMM": 5 * TRAIN_BLOCKS + SKIP_BLOCKS,
            # the bf16 pre-passes: K6's a1 (and bf16 x) and d; K7's a1, d and
            # bf16(r * g)
            "BF16-prepass": 5 * TRAIN_BLOCKS,
            # K7's dW2, dW1 and dW_skip
            "wgrad": 2 * TRAIN_BLOCKS + SKIP_BLOCKS,
            # K7's GN2 and GN1 backwards; GN2's folding pre-pass in K6 and in
            # K7's recompute (d with the dropout mask)
            "GN-bwd": 2 * TRAIN_BLOCKS, "GN2-prepass": 2 * TRAIN_BLOCKS}
# ... with training.fused_attn: the 10 attention blocks through K10 (K5 on
# f32 x: its GN statistics and bf16 pre-pass, the attention core, the two
# projections on the block GEMM)
PER_STEP_K10 = {**PER_STEP, "K1": 13, "K10": 10, "K5-core": 10,
                "GN-stats": 2 * TRAIN_BLOCKS + 10, "BF16-GEMM": 20,
                "BF16-prepass": 5 * TRAIN_BLOCKS + 10}
del PER_STEP_K10["K8"]

KERNELS = {
    "K1": dict(name="group_norm_silu", route="cuda", source="gddim_torch/csrc/groupnorm.cu",
               replaces="gddim_tpu/ops/groupnorm.py:162"),
    "K2": dict(name="fused_resblock", route="cuda", source="gddim_torch/csrc/resblock.cu",
               replaces="gddim_tpu/ops/resblock.py:600"),
    "K3": dict(name="fused_resblock_pair", route="cuda", source="gddim_torch/csrc/resblock.cu",
               replaces="gddim_tpu/ops/resblock.py:993"),
    "K4": dict(name="fused_resblock_tail", route="cuda", source="gddim_torch/csrc/resblock.cu",
               replaces="gddim_tpu/ops/resblock.py:1111"),
    "K5": dict(name="fused_attnblock", route="cuda", source="gddim_torch/csrc/attnblock.cu",
               replaces="gddim_tpu/ops/attnblock.py:166"),
    "K6": dict(name="fused_resblock_train", route="cuda", source="gddim_torch/csrc/resblock.cu",
               replaces="gddim_tpu/ops/resblock.py:1709"),
    "K7": dict(name="fused_resblock_train_grads", route="cuda",
               source="gddim_torch/csrc/resblock_bwd.cu",
               replaces="gddim_tpu/ops/resblock_bwd.py:353"),
    "K8": dict(name="flash_attention", route="cuda", source="gddim_torch/csrc/flash.cu",
               replaces="gddim_tpu/ops/flash.py:97"),
    "K2-int8": dict(name="fused_resblock_int8", route="cuda",
                    source="gddim_torch/csrc/resblock.cu", replaces="gddim_tpu/ops/resblock.py:600"),
    "K3-int8": dict(name="fused_resblock_pair_int8", route="cuda",
                    source="gddim_torch/csrc/resblock.cu", replaces="gddim_tpu/ops/resblock.py:993"),
    "K4-int8": dict(name="fused_resblock_tail_int8", route="cuda",
                    source="gddim_torch/csrc/resblock.cu",
                    replaces="gddim_tpu/ops/resblock.py:1111"),
    "K5-int8": dict(name="fused_attnblock_int8", route="cuda",
                    source="gddim_torch/csrc/attnblock.cu",
                    replaces="gddim_tpu/ops/attnblock.py:166"),
    "K11": dict(name="conv3x3_pallas", route="cuda", source="gddim_torch/csrc/conv3x3.cu",
                replaces="gddim_tpu/ops/conv3x3.py:87"),
    # K11 int8 on the int8 block GEMM (int32 split-K partials)
    "K11-int8": dict(name="conv3x3_pallas_int8", route="cuda",
                     source="gddim_torch/csrc/block_gemm.cu",
                     replaces="gddim_tpu/ops/conv3x3.py:206"),
    # K12: gn_apply_kernel's per-sample int8 mode with the unfolded affine
    "K12": dict(name="group_norm_silu_quant", route="cuda",
                source="gddim_torch/csrc/gn_apply.cu",
                replaces="gddim_tpu/ops/groupnorm.py:140"),
    "K9": dict(name="fused_resblock_transition", route="cuda",
               source="gddim_torch/csrc/transition.cu",
               replaces="gddim_tpu/ops/resblock.py:1480"),
    "K9-int8": dict(name="fused_resblock_transition_int8", route="cuda",
                    source="gddim_torch/csrc/transition.cu",
                    replaces="gddim_tpu/ops/resblock.py:1480"),
    "K10": dict(name="fused_attnblock_train", route="cuda", source="gddim_torch/csrc/attnblock.cu",
                replaces="gddim_tpu/ops/attnblock.py:295"),
    # the int8 block GEMM (both convs of K2-K4 and K9 in int8) and its
    # quantize pre-pass: the int8 path of the K2 / K3 Pallas kernels
    "S8-GEMM": dict(name="int8_conv_gemm", route="cuda",
                    source="gddim_torch/csrc/block_gemm.cu",
                    replaces="gddim_tpu/ops/resblock.py:600"),
    "S8-prepass": dict(name="quantize_conv_input", route="cuda",
                       source="gddim_torch/csrc/resblock.cu",
                       replaces="gddim_tpu/ops/resblock.py:993"),
    # the block GEMM's bf16 mode (both convs of K2-K4 and K9 in bf16) and its
    # bf16 pre-pass: the bf16 path of the K2 / K3 Pallas kernels
    "BF16-GEMM": dict(name="bf16_conv_gemm", route="cuda",
                      source="gddim_torch/csrc/block_gemm.cu",
                      replaces="gddim_tpu/ops/resblock.py:600"),
    "BF16-prepass": dict(name="bf16_conv_input", route="cuda",
                         source="gddim_torch/csrc/resblock.cu",
                         replaces="gddim_tpu/ops/resblock.py:993"),
    # K5's attention core (bf16 and int8 blocks and K10): wgmma fed by TMA
    "K5-core": dict(name="attention_core", route="cuda", source="gddim_torch/csrc/attnblock.cu",
                    replaces="gddim_tpu/ops/attnblock.py:166"),
    # the GroupNorm statistics where GN1 is not one launch (the f32 paths,
    # K6, K7, K10): gn_silu_tile's sums of the K2 / K3 Pallas kernels, one
    # cluster a sample
    "GN-stats": dict(name="gn_stats", route="cuda", source="gddim_torch/csrc/resblock.cu",
                     replaces="gddim_tpu/ops/resblock.py:600"),
    # the training path's GEMMs: K6's two convs, K7's recomputed conv1, its
    # two 3x3 dgrads (the forward's weights read K-major, tap-reversed) and
    # the 1x1 skip's dgrad on the block GEMM (counted apart from the sampling
    # path's); K7's three weight gradients on wgrad_kernel
    "train-GEMM": dict(name="bf16_dgrad_gemm", route="cuda",
                       source="gddim_torch/csrc/block_gemm.cu",
                       replaces="gddim_tpu/ops/resblock_bwd.py:353"),
    "wgrad": dict(name="wgrad", route="cuda", source="gddim_torch/csrc/resblock_bwd.cu",
                  replaces="gddim_tpu/ops/resblock_bwd.py:353"),
    # GN1 in one launch (K2/K3's conv1 operand, K5's h, K9's resample):
    # gn_silu_tile and the activation of the K2 / K3 Pallas kernels. Its
    # max_abs_err is each case's largest difference (err_is: bf16 ulps, int8
    # steps, or K9's bf16 / f32 h relative to max|h| with the per-sample
    # amax's), its max_rel_err the largest share of values that differ
    "GN-apply": dict(name="gn_apply", route="cuda", source="gddim_torch/csrc/gn_apply.cu",
                     replaces="gddim_tpu/ops/resblock.py:600"),
    # K7's GroupNorm(+SiLU) backwards (GN2's with the dropout mask, GN1's):
    # _resblock_bwd_kernel's (resblock_bwd.py:209-222, :233-242), one
    # cluster a sample
    "GN-bwd": dict(name="gn_silu_bwd", route="cuda", source="gddim_torch/csrc/resblock_bwd.cu",
                   replaces="gddim_tpu/ops/resblock_bwd.py:353"),
    # GN2's folding pre-pass (conv2's operand in every block; K6/K7's d):
    # gn_silu_tile of conv1's acc3 in the K2 / K3 Pallas kernels
    "GN2-prepass": dict(name="gn2_prepass", route="cuda", source="gddim_torch/csrc/resblock.cu",
                        replaces="gddim_tpu/ops/resblock.py:600"),
}
# main-path shapes of cld/accr_dcifar10 (H, channels in, channels out)
SHAPES = {
    "K1": [(32, 128), (16, 256), (8, 256), (4, 256)],
    "K2": [(32, 128, 128), (16, 128, 256), (16, 256, 256), (8, 256, 256), (4, 256, 256)],
    "K3": [(4, (256, 256), 256), (8, (256, 256), 256), (16, (256, 256), 256),
           (16, (256, 128), 256), (32, (256, 128), 128), (32, (128, 128), 128)],
    "K4": [(16, 128, 128), (8, 256, 256), (4, 256, 256), (16, 256, 256), (32, 256, 256)],
    "K5": [(16, 256), (4, 256)],
    # training path, f32: GN1/GN2 of the 6 transitions, the attention GNs
    # (16x16x256 and 4x4x256, no SiLU) and norm_out (32x32x128)
    "K1_train": [(32, 128), (16, 128), (16, 256), (8, 256), (4, 256), (32, 256)],
    # training path: every stride-1 block shape (K6 and K7 alike)
    "K6": [(32, 128, 128), (32, 384, 128), (32, 256, 128), (16, 512, 256), (16, 384, 256),
           (16, 256, 256), (16, 128, 256), (8, 512, 256), (8, 256, 256), (4, 512, 256),
           (4, 256, 256)],
    # (B, S, C): the training path's 16x16 and 4x4 attention, and one long sequence
    "K8": [(4, 256, 256), (4, 16, 256), (1, 2048, 128)],
    # ... f32 at the training batch, and bf16 at the layer-wise sampling paths' batches
    "K8_train": [(128, 256, 256), (128, 16, 256)],
    "K8_bf16": [(16, 256, 256), (16, 16, 256), (64, 256, 256), (64, 16, 256)],
    # the layer-wise paths (logged from one eval of the trunk): every 3x3 conv
    # (H, Cin, Cout) of the 76 residual blocks, K11 and K11-int8 alike ...
    "K11": [(32, 128, 128), (32, 256, 128), (32, 256, 256), (32, 384, 128), (16, 128, 128),
            (16, 128, 256), (16, 256, 256), (16, 384, 256), (16, 512, 256), (8, 256, 256),
            (8, 512, 256), (4, 256, 256), (4, 512, 256)],
    # ... every K12 input (H, C): the stride-1 and pair blocks' GN1, every GN2
    "K12": [(32, 128), (32, 256), (32, 384), (16, 128), (16, 256), (16, 384), (16, 512),
            (8, 256), (8, 512), (4, 256), (4, 512)],
    # K1 without SiLU: the attention GroupNorms (layer-wise and training paths)
    "K1_attn": [(16, 256), (4, 256)],
    # K9: (H_in, C, Cout, up) of the 6 transitions, 3 down then 3 up
    "K9": [(32, 128, 128, False), (16, 256, 256, False), (8, 256, 256, False),
           (4, 256, 256, True), (8, 256, 256, True), (16, 256, 256, True)],
    # K10: (H, C) of the training path's attention, f32
    "K10": [(16, 256), (4, 256)],
}
GRADS = ["dx", "dtemb", "dgn1s", "dgn1b", "dw1", "db1", "dgn2s", "dgn2b", "dw2", "db2", "dwsk",
         "dbsk"]
TEMB = 512  # 4 * nf


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's cost of enqueueing them does not enter (it does
    in time_ms where a call's host work outlasts its kernels)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def verdict(ms: float, library_ms: float) -> str:
    return f"{'wins' if ms <= library_ms else 'loses'}, {ms / library_ms:.2f}x"


class Inputs:
    """Seeded random operands on the card. Weights are bf16, as the model
    hands them to the kernels; the plain version gets the same values in f32."""

    def __init__(self, seed: int):
        self.g = torch.Generator(device="cuda").manual_seed(seed)

    def act(self, *shape):
        return torch.randn(shape, generator=self.g, device="cuda").to(torch.bfloat16)

    def w(self, *shape, fan_in=None):
        fan_in = fan_in or int(np.prod(shape[:-1]))
        t = torch.randn(shape, generator=self.g, device="cuda") / fan_in ** 0.5
        return t.to(torch.bfloat16)

    def vec(self, n, base=0.0):
        return base + 0.1 * torch.randn((n,), generator=self.g, device="cuda")


def _f32(args):
    return [a.float() if isinstance(a, torch.Tensor) else a for a in args]


def kernel_cases(B: int):
    """(kernel, shape label, fused fn, plain fn, kernel args, plain args)."""
    from gddim_torch.ops import attnblock, groupnorm, resblock

    inp = Inputs(0)
    for h, c in SHAPES["K1"]:
        args = (inp.act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c))
        kw = dict(num_groups=32, eps=1e-6, apply_silu=True)
        yield ("K1", f"{h}x{h}x{c}", lambda a=args, k=kw: groupnorm.group_norm_silu(*a, **k),
               lambda a=args, k=kw: groupnorm.group_norm_silu_reference(*_f32(a), **k), args, kw)
    for h, cin, cout in SHAPES["K2"]:
        skip = (inp.w(cin, cout), inp.vec(cout)) if cin != cout else (None, None)
        args = (inp.act(B, h, h, cin), inp.act(B, TEMB), inp.w(TEMB, cout).float(), inp.vec(cout),
                inp.vec(cin, 1.0), inp.vec(cin), inp.w(3, 3, cin, cout), inp.vec(cout),
                inp.vec(cout, 1.0), inp.vec(cout), inp.w(3, 3, cout, cout), inp.vec(cout),
                *skip)
        kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
        yield ("K2", f"{h}x{h} {cin}->{cout}",
               lambda a=args, k=kw: resblock.fused_resblock(*a, **k),
               lambda a=args, k=kw: resblock.resblock_reference(*_f32(a), **k), args, kw)
    for h, (c1, c2), cout in SHAPES["K3"]:
        cin = c1 + c2
        args = (inp.act(B, h, h, c1), inp.act(B, h, h, c2), inp.act(B, TEMB),
                inp.w(TEMB, cout).float(), inp.vec(cout), inp.vec(cin, 1.0), inp.vec(cin),
                inp.w(3, 3, cin, cout), inp.vec(cout), inp.vec(cout, 1.0), inp.vec(cout),
                inp.w(3, 3, cout, cout), inp.vec(cout), inp.w(cin, cout), inp.vec(cout))
        kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
        yield ("K3", f"{h}x{h} {c1}+{c2}->{cout}",
               lambda a=args, k=kw: resblock.fused_resblock_pair(*a, **k),
               lambda a=args, k=kw: resblock.resblock_pair_reference(*_f32(a), **k), args, kw)
    for h, c, cout in SHAPES["K4"]:
        args = (inp.act(B, h, h, c), inp.act(B, h, h, c), inp.act(B, TEMB), inp.w(TEMB, cout).float(),
                inp.vec(cout), inp.w(3, 3, c, cout), inp.vec(cout), inp.vec(cout, 1.0),
                inp.vec(cout), inp.w(3, 3, cout, cout), inp.vec(cout), inp.w(c, cout),
                inp.vec(cout))
        kw = dict(num_groups2=min(cout // 4, 32))
        yield ("K4", f"{h}x{h} {c}->{cout}",
               lambda a=args, k=kw: resblock.fused_resblock_tail(*a, **k),
               lambda a=args, k=kw: resblock.resblock_tail_reference(*_f32(a), **k), args, kw)
    for h, c in SHAPES["K5"]:
        args = (inp.act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c),
                *[t for _ in range(4) for t in (inp.w(c, c), inp.vec(c))])
        kw = dict(num_groups=32, skip_rescale=True)
        yield ("K5", f"{h}x{h}x{c}",
               lambda a=args, k=kw: attnblock.fused_attnblock(*a, **k),
               lambda a=args, k=kw: attnblock.attnblock_reference(*_f32(a), **k), args, kw)


def plain_bf16(kernel):
    """The plain version at the working dtype (bf16 activations), for timing."""
    from gddim_torch.ops import attnblock, groupnorm, resblock

    return {"K1": groupnorm.group_norm_silu_reference, "K2": resblock.resblock_reference,
            "K3": resblock.resblock_pair_reference, "K4": resblock.resblock_tail_reference,
            "K5": attnblock.attnblock_reference}[kernel]


# Static amaxes of the int8 kernel cases: the seeded N(0, 1) inputs through
# GN(+SiLU) reach about 5, which the 1.5x calibration margin on 4 covers; the
# attention output (a convex combination of v rows) stays near 1
INT8_AMAX = {"res": (4.0, 4.0), "attn": (4.0, 1.0)}


def int8_kernel_cases(B: int):
    """(kernel, label, fused fn, plain fn, kernel args) of K2-K5's int8 modes at
    every sampling-path shape, static and per-sample scales. Weights are
    quantized from bf16 values, as the model does; the plain version gets
    the same int8 weights and scales, and the activations in f32."""
    from gddim_torch.ops import attnblock, resblock as rb

    inp = Inputs(2)
    qw = lambda *shape: rb.quantize_weight(inp.w(*shape))  # noqa: E731
    qk = lambda *shape: rb.pack_int8_weight(qw(*shape))  # noqa: E731
    qp = lambda *shape: attnblock.pack_projection(qw(*shape))  # noqa: E731
    for static in (True, False):
        mode = ("" if B == 4 else f"B={B} ") + ("static" if static else "dynamic")
        res_s, attn_s = (torch.stack(rb.act_scales_from_amax(INT8_AMAX[k])).cuda() if static
                         else None for k in ("res", "attn"))
        for h, cin, cout in SHAPES["K2"]:
            skip = (inp.w(cin, cout), inp.vec(cout)) if cin != cout else (None, None)
            args = (inp.act(B, h, h, cin), inp.act(B, TEMB), inp.w(TEMB, cout).float(),
                    inp.vec(cout), inp.vec(cin, 1.0), inp.vec(cin), qk(3, 3, cin, cout),
                    inp.vec(cout), inp.vec(cout, 1.0), inp.vec(cout), qk(3, 3, cout, cout),
                    inp.vec(cout), *skip, res_s)
            kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
            yield ("K2-int8", f"{mode} {h}x{h} {cin}->{cout}",
                   lambda a=args, k=kw: rb.fused_resblock_int8(*a, **k),
                   lambda a=args, k=kw: rb.resblock_int8_reference(*_f32(a), **k), args)
        for h, (c1, c2), cout in SHAPES["K3"]:
            cin = c1 + c2
            args = (inp.act(B, h, h, c1), inp.act(B, h, h, c2), inp.act(B, TEMB),
                    inp.w(TEMB, cout).float(), inp.vec(cout), inp.vec(cin, 1.0), inp.vec(cin),
                    qk(3, 3, cin, cout), inp.vec(cout), inp.vec(cout, 1.0), inp.vec(cout),
                    qk(3, 3, cout, cout), inp.vec(cout), inp.w(cin, cout), inp.vec(cout), res_s)
            kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
            yield ("K3-int8", f"{mode} {h}x{h} {c1}+{c2}->{cout}",
                   lambda a=args, k=kw: rb.fused_resblock_pair_int8(*a, **k),
                   lambda a=args, k=kw: rb.resblock_pair_int8_reference(*_f32(a), **k), args)
        for h, c, cout in SHAPES["K4"]:
            args = (inp.act(B, h, h, c), inp.act(B, h, h, c), inp.act(B, TEMB),
                    inp.w(TEMB, cout).float(), inp.vec(cout), qk(3, 3, c, cout), inp.vec(cout),
                    inp.vec(cout, 1.0), inp.vec(cout), qk(3, 3, cout, cout), inp.vec(cout),
                    inp.w(c, cout), inp.vec(cout), res_s)
            kw = dict(num_groups2=min(cout // 4, 32))
            yield ("K4-int8", f"{mode} {h}x{h} {c}->{cout}",
                   lambda a=args, k=kw: rb.fused_resblock_tail_int8(*a, **k),
                   lambda a=args, k=kw: rb.resblock_tail_int8_reference(*_f32(a), **k), args)
        for h, c in SHAPES["K5"]:
            args = (inp.act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c), qp(c, 3 * c),
                    inp.vec(3 * c), qp(c, c), inp.vec(c), attn_s)
            kw = dict(num_groups=32, skip_rescale=True)
            yield ("K5-int8", f"{mode} {h}x{h}x{c}",
                   lambda a=args, k=kw: attnblock.fused_attnblock_int8(*a, **k),
                   lambda a=args, k=kw: attnblock.attnblock_int8_reference(*_f32(a), **k), args)


def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def nbytes(*objs) -> int:
    """Bytes of every tensor in objs (tuples and lists flattened; None skipped)."""
    total = 0
    for o in objs:
        if isinstance(o, (tuple, list)):
            total += nbytes(*o)
        elif isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
    return total


def block_ops(kernel: str, B: int, h: int, cin: int, cout: int, skip: bool) -> dict:
    """Operations of one residual block call by type: the two 3x3 convs (bf16
    or int8 tensor-core operands), the bf16 1x1 skip, the f32 temb row; K7
    recomputes conv1 and runs both convs' dgrads and wgrads and the skip's."""
    m = B * h * h
    conv = 2 * m * 9 * (cin * cout + cout * cout)
    sk = 2 * m * cin * cout if skip else 0
    if kernel == "K7":
        return {"bf16": 2 * m * 9 * (3 * cin * cout + 2 * cout * cout) + 2 * sk}
    if kernel == "K6":
        return {"bf16": conv + sk}
    return {"int8" if kernel.endswith("int8") else "bf16": conv, "bf16_skip": sk,
            "f32": 2 * B * TEMB * cout}


def attn_ops(kernel: str, B: int, s: int, c: int) -> dict:
    """K5: the q/k/v and output projections and the two attention products."""
    return {"int8" if kernel.endswith("int8") else "bf16": 2 * B * s * c * 4 * c,
            "bf16_attn": 4 * B * s * s * c}


def bound(bytes_: int, ops: dict):
    """(bound ms, bytes ms, operations ms): the least time the card could take,
    bytes over HBM and operations over their type's peak, whichever is larger."""
    t_bytes = 1e3 * bytes_ / HBM
    t_ops = 1e3 * sum(n / PEAK[k.split("_")[0]] for k, n in ops.items())
    return max(t_bytes, t_ops), t_bytes, t_ops


def _record(results, kernel, label, err, rel, ms, plain_ms, bound_ms, library_ms=None, **extra):
    r = results.setdefault(kernel, dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0,
                                        bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                                        library_ms=None, shapes=[]))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["max_rel_err"] = max(r["max_rel_err"], rel)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    for key, v in zip(("bound_ms", "bytes_ms", "ops_ms"), bound_ms):
        r[key] += v
    if library_ms is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
    r["shapes"].append(dict(shape=label, max_abs_err=err, rel=rel, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms[0], library_ms=library_ms, **extra))


def _ops_of(kernel, B, args, out):
    """Operations of one K1-K5 case from its arguments' and output's shapes."""
    x, cout = args[0], out.shape[-1]
    if kernel == "K1":
        return {"f32": 8 * x.numel()}  # statistics, affine and SiLU per element
    if kernel.startswith("K5"):
        return attn_ops(kernel, B, x.shape[1] * x.shape[2], x.shape[3])
    if kernel.startswith("K3"):
        return block_ops(kernel, B, x.shape[1], x.shape[3] + args[1].shape[3], cout, True)
    skip = args[11] is not None if kernel.startswith("K4") else args[12] is not None
    return block_ops(kernel, B, x.shape[1], x.shape[3], cout, skip)


def _check_kernel(results, kernel, label, fused, plain, args, ops, plain_timed=None,
                  plain_reps=20, library_ms=None, B=4, **extra):
    """Run one case: kernel vs plain (bf16 output within KERNEL_BOUND), timings
    (of plain_timed, else of plain), bound from the arguments' bytes and the
    operations ``ops`` by type (a dict, or a function of the output)."""
    out = fused()
    torch.cuda.synchronize()
    ref = plain()
    if out.shape != ref.shape or out.dtype != torch.bfloat16:
        raise AssertionError(f"{kernel} {label}: got {out.dtype} {tuple(out.shape)}, "
                             f"plain {tuple(ref.shape)}")
    err, rel = (out.float() - ref.float()).abs().max().item(), _rel(out, ref)
    ms = time_ms(fused)
    plain_ms = time_ms(plain_timed or plain, plain_reps)
    bd = bound(nbytes(args, out), ops(out) if callable(ops) else ops)
    lib = "" if library_ms is None else f" library_ms={library_ms:.4f} ({verdict(ms, library_ms)})"
    print(f"kernel {kernel} {KERNELS[kernel]['name']} [{label}] B={B}: max|err|={err:.3e} "
          f"rel={rel:.3e} (bound {KERNEL_BOUND[kernel]:.0e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bd[0]:.4f} ({'bytes' if bd[1] >= bd[2] else 'operations'}){lib}"
          + "".join(f" {k}={v:.4f}" for k, v in extra.items()), flush=True)
    _record(results, kernel, label, err, rel, ms, plain_ms, bd, library_ms, **extra)
    if not np.isfinite(rel) or rel > KERNEL_BOUND[kernel]:
        raise AssertionError(f"{kernel} {label}: rel err {rel:.3e} > {KERNEL_BOUND[kernel]:.0e}")


# batches at which the bf16 and int8 blocks are also checked and timed: the
# sampling batches of bench.py's main path; their results stay out of the
# kernels line, whose rows are at B=4 (print_block_sums reports them)
BLOCK_BATCHES = (16, 64)
# the bf16 blocks on the block GEMM: their rows get device time and the
# bf16-peak share
BF16_BLOCKS = ("K2", "K3", "K4")


def device_share(ops: dict, dev_ms: float) -> dict:
    """A case's device time (CUDA graph), its tensor-core products (int8,
    else bf16) and their share of that type's peak over that time."""
    kind = "int8" if "int8" in ops else "bf16"
    return {"graph_ms": dev_ms, f"{kind}_ops": ops[kind],
            f"{kind}_peak_share": ops[kind] / PEAK[kind] * 1e3 / dev_ms}


def phase_kernels(results: dict, batch_results: dict, B: int = 4):
    for kernel, label, fused, plain, args, kw in kernel_cases(B):
        extra = {}
        if kernel in BF16_BLOCKS:
            extra = device_share(_ops_of(kernel, B, args, fused()), graph_ms(fused))
        _check_kernel(results, kernel, label, fused, plain, args,
                      lambda out, k=kernel, a=args: _ops_of(k, B, a, out),
                      lambda: plain_bf16(kernel)(*args, **kw), B=B, plain_f32_ms=time_ms(plain),
                      **extra)
    # the bf16 blocks also at BLOCK_BATCHES, into batch_results
    for batch in BLOCK_BATCHES:
        for kernel, label, fused, plain, args, kw in kernel_cases(batch):
            if kernel not in BF16_BLOCKS:
                continue
            ops = _ops_of(kernel, batch, args, fused())
            _check_kernel(batch_results, kernel, f"B={batch} {label}", fused, plain, args, ops,
                          lambda a=args, k=kernel, w=kw: plain_bf16(k)(*a, **w), plain_reps=5,
                          B=batch, **device_share(ops, graph_ms(fused)))
    # the int8 modes, with their device time (K2-K4 also at BLOCK_BATCHES,
    # into batch_results); the int8 plain version sums exactly in float64:
    # no yardstick of speed
    for batch in (B, *BLOCK_BATCHES):
        for kernel, label, fused, plain, args in int8_kernel_cases(batch):
            if batch != B and kernel == "K5-int8":
                continue
            out = fused()
            ops = _ops_of(kernel, batch, args, out)
            _check_kernel(results if batch == B else batch_results, kernel, label, fused, plain,
                          args, ops, plain_reps=5, B=batch, **device_share(ops, graph_ms(fused)))


def transition_ops(kernel: str, B: int, h_in: int, c: int, cout: int, up: bool) -> dict:
    """K9: the two 3x3 convs and the 1x1 skip at the output resolution,
    2*B*h*w*(9*(C*Cout + Cout^2) + C*Cout), and the f32 temb row."""
    m = B * (2 * h_in if up else h_in // 2) ** 2
    return {"int8" if kernel.endswith("int8") else "bf16": 2 * m * 9 * (c * cout + cout * cout),
            "bf16_skip": 2 * m * c * cout, "f32": 2 * B * TEMB * cout}


def block_shapes():
    """The block GEMM's convs (H, Cin, Cout), and the conv inputs its
    pre-pass makes (H, channel parts, dtype, GN affine + SiLU), of every
    K2/K3/K4/K9 shape of the main path (K9's at its output resolution); in
    the bf16 mode only those with the affine (K4's and K9's conv1 read h as
    it is)."""
    convs, sites = set(), set()
    blocks = ([(h, (c,), n, "bf16", True) for h, c, n in SHAPES["K2"]]
              + [(h, parts, n, "bf16", True) for h, parts, n in SHAPES["K3"]]
              + [(h, (c,), n, "f32", False) for h, c, n in SHAPES["K4"]]
              + [(2 * h if up else h // 2, (c,), n, "f32", False) for h, c, n, up in SHAPES["K9"]])
    for h, parts, n, dtype, affine in blocks:
        convs |= {(h, sum(parts), n), (h, n, n)}
        sites |= {(h, parts, dtype, affine), (h, (n,), "f32", True)}  # conv1's, conv2's (h1)
    return sorted(convs), sorted(sites)


def phase_s8_kernels(results: dict, batch_results: dict, batches=(4, 64)):
    """The int8 block GEMM alone at every int8 block conv (unit scales): its
    int32 sums against the exact float64 conv, bit for bit; the quantize
    pre-pass at every conv input, static and per-sample scales (the pair's
    per-sample form a * (127 / amax)), against its plain version. The first
    batch's results go into the kernels line, the others' into
    batch_results."""
    from gddim_torch.ops import conv3x3, resblock as rb

    inp = Inputs(7)
    convs, sites = block_shapes()
    for B in batches:
        res = results if B == batches[0] else batch_results
        for h, cin, n in convs:
            label = f"B={B} {h}x{h} {cin}->{n}"
            x8, _ = conv3x3.quantize_per_sample(inp.act(B, h, h, cin))
            wq, _ = rb.quantize_weight(inp.w(3, 3, cin, n))
            wk, _ = rb.pack_int8_weight((wq, None))
            fused = lambda: rb.int8_conv_gemm(x8, wk)  # noqa: E731
            plain = lambda: rb.conv3x3_int8_exact(x8, wq)  # noqa: E731
            out = fused()
            torch.cuda.synchronize()
            ref = plain()
            top = ref.abs().max().item()
            exact = out.dtype == torch.float32 and torch.equal(out, ref)
            err = (out - ref).abs().max().item()
            ops = {"int8": 2 * B * h * h * 9 * cin * n}
            ms, plain_ms, dev = time_ms(fused), time_ms(plain, 5), device_share(ops, graph_ms(fused))
            bd = bound(nbytes(x8, wk, out), ops)
            print(f"kernel S8-GEMM int8_conv_gemm [{label}]: sums bit-identical to the exact conv: "
                  f"{exact} (largest |sum| {top:.0f}, under 2^24: {top < 2 ** 24}) ms={ms:.4f} "
                  f"device ms={dev['graph_ms']:.4f} plain_ms={plain_ms:.4f} bound_ms={bd[0]:.4f} "
                  f"({'bytes' if bd[1] >= bd[2] else 'operations'}); "
                  f"{dev['int8_peak_share']:.1%} of the int8 peak", flush=True)
            _record(res, "S8-GEMM", label, err, err / top, ms, plain_ms, bd, **dev)
            if not (exact and top < 2 ** 24):
                raise AssertionError(f"S8-GEMM {label}: sums differ from the exact conv by {err}")
        for h, parts, dtype, affine in sites:
            for static in (True, False):
                inv_mul = len(parts) == 2 and not static  # the pair's conv1
                label = (f"B={B} {'static' if static else 'dynamic'} {h}x{h} "
                         f"{'+'.join(map(str, parts))} {dtype}{' GN+SiLU' if affine else ''}")
                xs = [inp.act(B, h, h, c) if dtype == "bf16"
                      else 2 * torch.randn((B, h, h, c), generator=inp.g, device="cuda")
                      for c in parts]
                c = sum(parts)
                sc = sh = None
                if affine:
                    sc = 1.0 + 0.3 * torch.randn((B, c), generator=inp.g, device="cuda")
                    sh = 0.2 * torch.randn((B, c), generator=inp.g, device="cuda")
                kw = dict(silu=affine, inv_mul=inv_mul)
                if static:
                    kw["act_scale"] = rb.act_scales_from_amax((4.0,))[0].cuda()
                else:
                    a = torch.cat(xs, -1).float()
                    if affine:
                        a = a * sc[:, None, None] + sh[:, None, None]
                        a = a * torch.sigmoid(a)
                    kw["amax"] = a.abs().amax(dim=(1, 2, 3))
                x1 = xs[1] if len(xs) > 1 else None
                fused = lambda: rb.quantize_conv_input(xs[0], x1, sc, sh, **kw)  # noqa: E731
                plain = lambda: rb.quantize_conv_input_reference(  # noqa: E731
                    xs[0], x1, sc, sh, **kw)
                q = fused()
                torch.cuda.synchronize()
                step = (q.int() - plain().int()).abs()
                steps, share = step.max().item(), (step > 0).float().mean().item()
                ms, plain_ms, dev_ms = time_ms(fused), time_ms(plain), graph_ms(fused)
                bd = bound(nbytes(xs, sc, sh, q), {"f32": 8 * q.numel()})
                print(f"kernel S8-prepass quantize_conv_input [{label}]: int8 values one step "
                      f"apart {share:.2e} (bound {S8_FLIP_SHARE:.0e}), largest step {steps}; "
                      f"ms={ms:.4f} device ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                      f"bound_ms={bd[0]:.4f}", flush=True)
                _record(res, "S8-prepass", label, steps, share, ms, plain_ms, bd,
                        graph_ms=dev_ms)
                if q.dtype != torch.int8 or steps > 1 or share > S8_FLIP_SHARE:
                    raise AssertionError(f"S8-prepass {label}: steps {steps}, share {share:.2e}")


def bf16_steps(got, ref):
    """|got - ref| of bf16 tensors in bf16 ulps of ref: 2^(e - 8) for |ref|
    in [2^(e-1), 2^e)."""
    r = ref.float()
    e = torch.frexp(r)[1]
    return (got.float() - r).abs() / torch.ldexp(torch.ones_like(r), e - 8)


def phase_bf16_kernels(results: dict, batch_results: dict, batches=(4, 64)):
    """The bf16 block GEMM alone at every bf16 block conv against the f32 conv
    of the same bf16 values (TF32 off), beside F.conv2d on the same NHWC
    bytes (a channels_last bf16 view), eager and device time (CUDA graph),
    won or lost, and its share of the bf16 peak; the bf16 pre-pass at every
    conv input it makes (the GN affine + SiLU) against its plain version.
    The first batch's results go into the kernels line, the others' into
    batch_results."""
    from gddim_torch.ops import resblock as rb

    inp = Inputs(8)
    convs, sites = block_shapes()
    for B in batches:
        res = results if B == batches[0] else batch_results
        for h, cin, n in convs:
            label = f"B={B} {h}x{h} {cin}->{n}"
            x, w = inp.act(B, h, h, cin), inp.w(3, 3, cin, n)
            products = 2 * B * h * h * 9 * cin * n
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            fused = lambda: rb.bf16_conv_gemm(x, w)  # noqa: E731
            plain = lambda: rb.conv3x3_nhwc(x.float(), w.float())  # noqa: E731
            library = lambda: F.conv2d(xc, wc, padding=1)  # noqa: E731
            out = fused()
            torch.cuda.synchronize()
            ref = plain()
            err, rel = (out - ref).abs().max().item(), _rel(out, ref)
            ms, plain_ms, lib_ms = time_ms(fused), time_ms(plain, 5), time_ms(library)
            dev = device_share({"bf16": products}, graph_ms(fused))
            lib_dev = graph_ms(library)
            bd = bound(nbytes(x, w, out), {"bf16": products})
            print(f"kernel BF16-GEMM bf16_conv_gemm [{label}]: rel={rel:.3e} (bound "
                  f"{KERNEL_BOUND['BF16-GEMM']:.0e}) ms={ms:.4f} device ms={dev['graph_ms']:.4f} "
                  f"plain_ms={plain_ms:.4f} bound_ms={bd[0]:.4f} "
                  f"({'bytes' if bd[1] >= bd[2] else 'operations'}); F.conv2d ms={lib_ms:.4f} "
                  f"device ms={lib_dev:.4f} (device time {verdict(dev['graph_ms'], lib_dev)}); "
                  f"{dev['bf16_peak_share']:.1%} of the bf16 peak", flush=True)
            _record(res, "BF16-GEMM", label, err, rel, ms, plain_ms, bd, lib_ms,
                    library_graph_ms=lib_dev, **dev)
            if out.dtype != torch.float32 or not np.isfinite(rel) or rel > KERNEL_BOUND["BF16-GEMM"]:
                raise AssertionError(f"BF16-GEMM {label}: {out.dtype}, rel err {rel:.3e}")
        for h, parts, dtype, affine in sites:
            if not affine:  # K4's and K9's conv1: no pre-pass in the bf16 mode
                continue
            label = f"B={B} {h}x{h} {'+'.join(map(str, parts))} {dtype} GN+SiLU"
            xs = [inp.act(B, h, h, c) if dtype == "bf16"
                  else 2 * torch.randn((B, h, h, c), generator=inp.g, device="cuda")
                  for c in parts]
            c = sum(parts)
            sc = 1.0 + 0.3 * torch.randn((B, c), generator=inp.g, device="cuda")
            sh = 0.2 * torch.randn((B, c), generator=inp.g, device="cuda")
            x1 = xs[1] if len(xs) > 1 else None
            fused = lambda: rb.bf16_conv_input(xs[0], x1, sc, sh, silu=True)  # noqa: E731
            plain = lambda: rb.bf16_conv_input_reference(xs[0], x1, sc, sh, silu=True)  # noqa: E731
            a = fused()
            torch.cuda.synchronize()
            step = bf16_steps(a, plain())
            steps, share = step.max().item(), (step > 0).float().mean().item()
            ms, plain_ms, dev_ms = time_ms(fused), time_ms(plain), graph_ms(fused)
            bd = bound(nbytes(xs, sc, sh, a), {"f32": 8 * a.numel()})
            print(f"kernel BF16-prepass bf16_conv_input [{label}]: bf16 values one ulp apart "
                  f"{share:.2e} (bound {BF16_FLIP_SHARE:.0e}), largest {steps:.2f} ulp; "
                  f"ms={ms:.4f} device ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={bd[0]:.4f}", flush=True)
            _record(res, "BF16-prepass", label, steps, share, ms, plain_ms, bd, graph_ms=dev_ms)
            if a.dtype != torch.bfloat16 or steps > 1 or share > BF16_FLIP_SHARE:
                raise AssertionError(f"BF16-prepass {label}: {steps} ulp, share {share:.2e}")


def gn_sites():
    """(H, channel parts) of every GroupNorm the statistics kernel takes on
    the main path: the residual blocks' GN1 (K2, K3's pairs, K9's at its
    input resolution), K5's GN, and conv1's h1 (GN2, which the f32 paths and
    K7 take by the kernel; the block GEMM's blocks from conv1's epilogue)."""
    sites = {(h, (c,)) for h, c, _ in SHAPES["K2"]} | {(h, p) for h, p, _ in SHAPES["K3"]}
    sites |= {(h, (c,)) for h, c, _, _ in SHAPES["K9"]} | {(h, (c,)) for h, c in SHAPES["K5"]}
    sites |= {(h, (n,)) for h, _, n in SHAPES["K2"] + SHAPES["K3"] + SHAPES["K4"]}
    sites |= {(2 * h if up else h // 2, (n,)) for h, _, n, up in SHAPES["K9"]}
    return sorted(sites)


def conv1_shapes():
    """(H, Cin, Cout) of conv1 of every K2/K3/K4/K9 shape of the main path
    (K9's at its output resolution): the convs whose epilogue takes GN2's sums."""
    convs = {(h, c, n) for h, c, n in SHAPES["K2"] + SHAPES["K4"]}
    convs |= {(h, sum(p), n) for h, p, n in SHAPES["K3"]}
    convs |= {(2 * h if up else h // 2, c, n) for h, c, n, up in SHAPES["K9"]}
    return sorted(convs)


def phase_gn_kernels(results: dict, batch_results: dict, batches=(4, 16, 64)):
    """The GroupNorm statistics kernel against gn_stats_reference at every GN
    shape of the main path, bf16 and f32 inputs, at each batch, with device
    time, bound (the bytes once) and torch.var_mean over the (B, HW, G, C/G)
    view as the library yardstick; then conv1's epilogue sums (GN2's
    partials) against gn2_partials_reference at every block conv1, bf16 and
    int8, at B=4 and 64, with conv1's device time with and without them. The
    first batch's results go into the kernels line, the others' into
    batch_results."""
    from gddim_torch.ops import conv3x3, resblock as rb

    inp = Inputs(9)
    for B in batches:
        res = results if B == batches[0] else batch_results
        for h, parts in gn_sites():
            for dtype in (torch.bfloat16, torch.float32):
                c = sum(parts)
                label = (f"B={B} {h}x{h} {'+'.join(map(str, parts))} "
                         f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")
                xs = [(inp.act(B, h, h, p).float() + inp.vec(p)).to(dtype) for p in parts]
                x1 = xs[1] if len(xs) > 1 else None
                gamma, beta, groups = inp.vec(c, 1.0), inp.vec(c), min(c // 4, 32)
                xcat = torch.cat(xs, -1)
                fused = lambda: rb.gn_stats(xs[0], x1, gamma, beta, num_groups=groups)  # noqa: E731
                plain = lambda: rb.gn_stats_reference(xcat, groups, 1e-6, gamma, beta)  # noqa: E731
                library = lambda: torch.var_mean(  # noqa: E731
                    xcat.view(B, h * h, groups, c // groups), dim=(1, 3))
                out = fused()
                again = fused()
                torch.cuda.synchronize()
                ref = plain()
                same = all(torch.equal(a, b) for a, b in zip(out, again))
                rel = max(_rel(o, r) for o, r in zip(out, ref))
                err = max((o - r).abs().max().item() for o, r in zip(out, ref))
                ms, plain_ms, lib_ms = time_ms(fused), time_ms(plain), time_ms(library)
                dev, lib_dev = graph_ms(fused), graph_ms(library)
                bd = bound(nbytes(xs, gamma, beta, out), {"f32": 3 * xcat.numel()})
                print(f"kernel GN-stats gn_stats [{label}]: rel={rel:.3e} (bound "
                      f"{KERNEL_BOUND['GN-stats']:.0e}), same bits on repeat: {same}; "
                      f"ms={ms:.4f} device ms={dev:.4f} plain_ms={plain_ms:.4f} "
                      f"bound_ms={bd[0]:.4f} (bytes); torch.var_mean ms={lib_ms:.4f} device "
                      f"ms={lib_dev:.4f} (device time {verdict(dev, lib_dev)})", flush=True)
                _record(res, "GN-stats", label, err, rel, ms, plain_ms, bd, lib_ms, graph_ms=dev,
                        library_graph_ms=lib_dev)
                if not (same and np.isfinite(rel) and rel <= KERNEL_BOUND["GN-stats"]):
                    raise AssertionError(f"GN-stats {label}: rel err {rel:.3e}, repeat {same}")
        sums = [r for r in res["GN-stats"]["shapes"] if r["shape"].startswith(f"B={B} ")]
        print(f"sum GN-stats B={B}: {len(sums)} cases, eager {sum(r['ms'] for r in sums):.4f} ms, "
              f"device {sum(r['graph_ms'] for r in sums):.4f} ms, torch.var_mean device "
              f"{sum(r['library_graph_ms'] for r in sums):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in sums):.4f} ms", flush=True)
    for B in (4, 64):
        for int8 in (False, True):
            mode = "int8" if int8 else "bf16"
            total = {"with": 0.0, "without": 0.0}
            for h, cin, n in conv1_shapes():
                plan = (rb.s8_tile_plan if int8 else rb.bf16_tile_plan)(B, h, h, cin, 0, n)
                if int8:
                    x8, _ = conv3x3.quantize_per_sample(inp.act(B, h, h, cin))
                    wk, _ = rb.pack_int8_weight(rb.quantize_weight(inp.w(3, 3, cin, n)))
                    run = lambda s, x8=x8, wk=wk: rb.int8_conv_gemm(x8, wk, stats=s)  # noqa: E731
                else:
                    x, w = inp.act(B, h, h, cin), inp.w(3, 3, cin, n)
                    run = lambda s, x=x, w=w: rb.bf16_conv_gemm(x, w, stats=s)  # noqa: E731
                out, part = run(True)
                out2, part2 = run(True)
                torch.cuda.synchronize()
                same = torch.equal(part, part2) and torch.equal(out, out2)
                rel = _rel(part, rb.gn2_partials_reference(out, plan))
                dev_with, dev_without = graph_ms(lambda: run(True)), graph_ms(lambda: run(False))
                total["with"] += dev_with
                total["without"] += dev_without
                label = (f"{mode} B={B} {h}x{h} {cin}->{n}: tiles of {plan.box_b} sample(s) x "
                         f"{plan.box_h} rows, {plan.splits} split(s)")
                print(f"kernel GN2-sums conv1 epilogue [{label}]: rel={rel:.3e} (bound "
                      f"{KERNEL_BOUND['GN2-sums']:.0e}), same bits on repeat: {same}; conv1 "
                      f"device ms {dev_with:.4f} with the sums, {dev_without:.4f} without "
                      f"({dev_with / dev_without - 1:+.1%})", flush=True)
                if not (same and np.isfinite(rel) and rel <= KERNEL_BOUND["GN2-sums"]):
                    raise AssertionError(f"GN2-sums {label}: rel err {rel:.3e}, repeat {same}")
            print(f"sum GN2-sums {mode} B={B}: {len(conv1_shapes())} conv1s, device "
                  f"{total['with']:.4f} ms with the sums, {total['without']:.4f} without "
                  f"({total['with'] / total['without'] - 1:+.1%})", flush=True)


def gn1_sites():
    """(H, channel parts, SiLU) of every GN1 of the main path that
    gn_apply_kernel's convert variant takes: the K2 and K3 blocks' conv1
    input (the pairs' two parts) and the attention blocks' GN (no SiLU);
    their (H, C) are tests/test_torch_gn_stats.py:GN_SHAPES."""
    sites = {(h, (c,), True) for h, c, _ in SHAPES["K2"]} | {(h, p, True) for h, p, _ in SHAPES["K3"]}
    return sorted(sites | {(h, (c,), False) for h, c in SHAPES["K5"]})


def _flips(kind: str, got, ref):
    """(largest difference, share of values that differ) of a bf16 or int8
    output against its plain version: bf16 ulps, int8 steps."""
    if kind == "int8":
        d = (got.int() - ref.int()).abs().float()
    else:
        d = bf16_steps(got, ref)
    return d.max().item(), (d > 0).float().mean().item()


def phase_gn_apply_kernels(results: dict, batch_results: dict, batches=(4, 16, 64)):
    """GN1 in one launch (gn_apply_kernel) at every main-path GN1 site (bf16,
    int8 static and int8 per sample; the pairs' per-sample a * (127 / amax))
    and at the 6 transitions (the resample variant: h bf16, f32 with the
    per-sample amax, and int8 by a static scale), at each batch: the same
    bits as the launches it replaces and on repeat, against its plain
    version, with eager and device time beside the replaced launches' device
    time (the yardstick) and the bound (its bytes once); F.group_norm, one
    call for the same function, beside K5's GN (no SiLU, bf16). The first
    batch's results go into the kernels line, the others' into
    batch_results."""
    from gddim_torch.ops import resblock as rb

    inp = Inputs(10)
    for B in batches:
        res = results if B == batches[0] else batch_results
        for h, parts, silu in gn1_sites():
            c = sum(parts)
            xs = [(inp.act(B, h, h, p).float() * 1.5 + inp.vec(p)).bfloat16() for p in parts]
            x1 = xs[1] if len(xs) > 1 else None
            gamma, beta, groups = inp.vec(c, 1.0), inp.vec(c), min(c // 4, 32)
            for mode in ("bf16", "static", "dynamic"):
                int8 = mode != "bf16"
                kw = dict(num_groups=groups, silu=silu, int8=int8,
                          act_scale=(rb.act_scales_from_amax((4.0,))[0].cuda() if mode == "static"
                                     else None),
                          inv_mul=mode == "dynamic" and x1 is not None)
                label = (f"B={B} {mode} {h}x{h} {'+'.join(map(str, parts))} "
                         f"{'GN+SiLU' if silu else 'GN'}")
                fused = lambda: rb.gn_apply(xs[0], x1, gamma, beta, **kw)  # noqa: E731
                old = lambda: rb.gn_apply(xs[0], x1, gamma, beta, ctas=0, **kw)  # noqa: E731
                plain = lambda: rb.gn_apply_reference(xs[0], x1, gamma, beta, **kw)  # noqa: E731
                got, again, was = fused(), fused(), old()
                torch.cuda.synchronize()
                ref = plain()
                bits = [(got[0], was[0]), *zip(got[1], was[1])] + (
                    [(got[2], was[2])] if got[2] is not None else [])
                same_old = all(torch.equal(a, b) for a, b in bits)
                same = torch.equal(got[0], again[0]) and torch.equal(got[1][0], again[1][0])
                srel = max(_rel(a, b) for a, b in zip(got[1], ref[1]))
                if got[2] is not None:
                    srel = max(srel, _rel(got[2], ref[2]))
                # the output against the plain conversion from the kernel's own
                # statistics (as the pre-passes are held): near a value's zero,
                # f32 last bits of the statistics move it by many ulps of itself
                sc, sh = got[1][:2]
                if int8:
                    want = rb.quantize_conv_input_reference(
                        xs[0], x1, sc, sh, silu=silu, act_scale=kw["act_scale"], amax=got[2],
                        inv_mul=kw["inv_mul"])
                else:
                    want = rb.bf16_conv_input_reference(xs[0], x1, sc, sh, silu=silu)
                worst, share = _flips("int8" if int8 else "bf16", got[0], want)
                ms, plain_ms, dev, old_dev = (time_ms(fused), time_ms(plain), graph_ms(fused),
                                              graph_ms(old))
                lib_ms = lib_dev = None
                if not silu and not int8:  # K5's GN: one PyTorch call computes it
                    xc = xs[0].permute(0, 3, 1, 2)
                    library = lambda: F.group_norm(xc, groups, gamma.bfloat16(),  # noqa: E731
                                                   beta.bfloat16(), 1e-6)
                    lib_ms, lib_dev = time_ms(library), graph_ms(library)
                bd = bound(nbytes(xs, gamma, beta, got[0]), {"f32": 8 * got[0].numel()})
                lib = ("" if lib_ms is None else f"; F.group_norm ms={lib_ms:.4f} device "
                       f"ms={lib_dev:.4f} (device time {verdict(dev, lib_dev)})")
                print(f"kernel GN-apply gn_apply [{label}]: {rb.gn_apply_ctas(h, h, c)} CTAs a sample; the same bits "
                      f"as the launches it replaces: {same_old}, on repeat: {same}; statistics "
                      f"rel={srel:.3e} (bound {KERNEL_BOUND['GN-stats']:.0e}); values one "
                      f"{'step' if int8 else 'ulp'} apart {share:.2e} (bound "
                      f"{S8_FLIP_SHARE if int8 else BF16_FLIP_SHARE:.0e}), largest {worst:.2f}; "
                      f"ms={ms:.4f} device ms={dev:.4f}, replaced launches device ms="
                      f"{old_dev:.4f} ({dev / old_dev:.2f}x); plain_ms={plain_ms:.4f} "
                      f"bound_ms={bd[0]:.4f} (bytes){lib}", flush=True)
                _record(res, "GN-apply", label, worst, share, ms, plain_ms, bd, lib_ms,
                        err_is="steps" if int8 else "ulps", graph_ms=dev,
                        replaced_graph_ms=old_dev, library_graph_ms=lib_dev)
                flip_bound = S8_FLIP_SHARE if int8 else BF16_FLIP_SHARE
                if not (same_old and same and srel <= KERNEL_BOUND["GN-stats"]
                        and worst <= KERNEL_BOUND["GN-apply"] and share <= flip_bound):
                    raise AssertionError(f"GN-apply {label}: bits {same_old}/{same}, stats "
                                         f"{srel:.3e}, {worst} apart on {share:.2e}")
        for hin, c, _, up in SHAPES["K9"]:
            x = (inp.act(B, hin, hin, c).float() * 1.5 + inp.vec(c)).bfloat16()
            gamma, beta = inp.vec(c, 1.0), inp.vec(c)
            s1 = rb.act_scales_from_amax((4.0,))[0].cuda()
            for mode in ("bf16", "f32", "int8"):
                kw = dict(up=up, num_groups=min(c // 4, 32), mode=mode,
                          act_scale=s1 if mode == "int8" else None)
                label = f"B={B} resample {mode} {'up' if up else 'down'} {hin}x{hin}x{c}"
                fused = lambda: rb.gn_resample(x, gamma, beta, **kw)  # noqa: E731
                if mode == "int8":  # the old route: h f32, then the int8 pre-pass
                    def old(kw=kw):
                        h, xr, _ = rb.gn_resample(x, gamma, beta, **{**kw, "mode": "f32",
                                                                    "act_scale": None}, ctas=0)
                        return rb.quantize_conv_input(h, act_scale=s1), xr, None
                else:
                    old = lambda: rb.gn_resample(x, gamma, beta, ctas=0, **kw)  # noqa: E731
                plain = lambda: rb.gn_resample_reference(x, gamma, beta, **kw)  # noqa: E731
                got, again, was = fused(), fused(), old()
                torch.cuda.synchronize()
                ref = plain()
                same_old = all(torch.equal(a, b) for a, b in zip(got, was) if a is not None)
                same = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
                xr_worst, xr_share = _flips("bf16", got[1], ref[1])
                if mode == "int8":
                    worst, share = _flips("int8", got[0], ref[0])
                    ok = worst <= KERNEL_BOUND["GN-apply"] and share <= S8_FLIP_SHARE
                else:
                    worst = _rel(got[0], ref[0])
                    if mode == "f32":
                        worst = max(worst, _rel(got[2], ref[2]))
                    share = (got[0] != ref[0].to(got[0].dtype)).float().mean().item()
                    ok = worst <= GN_RESAMPLE_BOUND
                ok = ok and xr_worst <= 1 and xr_share <= BF16_FLIP_SHARE
                ms, plain_ms, dev, old_dev = (time_ms(fused), time_ms(plain), graph_ms(fused),
                                              graph_ms(old))
                bd = bound(nbytes(x, gamma, beta, got[0], got[1]), {"f32": 8 * x.numel()})
                what = (f"h values one step apart {share:.2e}, largest {worst:.2f}"
                        if mode == "int8" else f"h rel={worst:.3e} (bound "
                        f"{GN_RESAMPLE_BOUND:.0e}), values that differ {share:.2e}")
                print(f"kernel GN-apply gn_resample [{label}]: "
                      f"{rb.gn_resample_ctas(hin, hin, c, up)} CTAs a sample; the same bits as "
                      f"the launches it replaces: {same_old}, on repeat: {same}; {what}; xr one "
                      f"ulp apart {xr_share:.2e}; ms={ms:.4f} device ms={dev:.4f}, replaced "
                      f"launches device ms={old_dev:.4f} ({dev / old_dev:.2f}x); "
                      f"plain_ms={plain_ms:.4f} bound_ms={bd[0]:.4f} (bytes)", flush=True)
                _record(res, "GN-apply", label, worst, share, ms, plain_ms, bd,
                        err_is="steps" if mode == "int8" else "h rel", graph_ms=dev,
                        replaced_graph_ms=old_dev)
                if not (same_old and same and ok):
                    raise AssertionError(f"GN-apply {label}: bits {same_old}/{same}, {what}")
        cases = [r for r in res["GN-apply"]["shapes"] if r["shape"].startswith(f"B={B} ")]
        print(f"sum GN-apply B={B}: {len(cases)} cases, eager "
              f"{sum(r['ms'] for r in cases):.4f} ms, device {sum(r['graph_ms'] for r in cases):.4f}"
              f" ms, the replaced launches device "
              f"{sum(r['replaced_graph_ms'] for r in cases):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in cases):.4f} ms", flush=True)


def phase_gn2_prepass_kernels(results: dict, batch_results: dict, batches=(4, 16, 64)):
    """GN2's folding pre-pass (gn_prepass_kernel) alone at every block conv1
    of the main path (its GN2 partial rows under conv1's tile plan), bf16
    and int8 (static), at each batch; and its training form (d with the
    dropout mask, the fold written out for K7) at the training shapes, B=4
    and 128: its fold (gn_fold_kernel's, the same arithmetic, run alone)
    against the plain fold, its output against the plain conversion from
    that fold (one ulp or step apart on at most BF16_FLIP_SHARE /
    S8_FLIP_SHARE of the values), the same bits on repeat, with device time
    beside the fold alone's and the bound (h1 read once, the operand written
    once). Library: none (no one PyTorch call folds partial sums). The
    first batch's results go into the kernels line, the others' into
    batch_results."""
    from gddim_torch.ops import resblock as rb

    inp = Inputs(13)
    s1 = rb.act_scales_from_amax((4.0,))[0].cuda()
    cases = [(B, mode, h, cin, n) for B in batches for mode in ("bf16", "int8")
             for h, cin, n in conv1_shapes()]
    cases += [(B, "train", h, cin, n) for B in (4, 128) for h, cin, n in SHAPES["K6"]]
    sums = {}
    for B, mode, h, cin, n in cases:
        res = results if B == batches[0] and mode != "train" else batch_results
        h1 = torch.randn((B, h, h, n), generator=inp.g, device="cuda") * 1.5 + 0.3
        plan = (rb.s8_tile_plan if mode == "int8" else rb.bf16_tile_plan)(B, h, h, cin, 0, n)
        part = rb.gn2_partials_reference(h1, plan)
        gamma, beta = inp.vec(n, 1.0), inp.vec(n)
        mask = ((torch.rand((B, h, h, n), generator=inp.g, device="cuda") < 0.9).to(torch.int8)
                if mode == "train" else None)
        kw = dict(num_groups=min(n // 4, 32), mode=mode, act_scale=s1 if mode == "int8" else None,
                  mask=mask, keep_prob=0.9)
        fused = lambda kw=kw: rb.gn2_prepass(h1, part, gamma, beta, **kw)  # noqa: E731
        fold = lambda kw=kw: rb.gn2_prepass(h1, part, gamma, beta, fold_only=True,  # noqa: E731
                                            **{**kw, "mode": "bf16", "act_scale": None,
                                               "mask": None})
        plain = lambda kw=kw: rb.gn2_prepass_reference(h1, part, gamma, beta, **kw)  # noqa: E731
        got, again, folded = fused(), fused(), fold()
        torch.cuda.synchronize()
        ref = plain()
        same = torch.equal(got[0], again[0])
        int8 = mode == "int8"
        # the fold against the plain fold (and, training, the one it writes
        # out: the same bits), then the output against the plain conversion
        # from that fold, as the pre-passes are held: near a value's zero,
        # f32 last bits of the affine move it by many ulps of itself
        frel = max(_rel(a, b) for a, b in zip(folded[1][:2], ref[1][:2]))
        if got[1] is not None:
            same = same and all(torch.equal(a, b) for a, b in zip(got[1][:2], folded[1][:2]))
        want = rb.gn2_convert_reference(h1, *folded[1][:2], mode=mode, act_scale=kw["act_scale"],
                                        mask=mask, keep_prob=0.9)
        worst, share = _flips("int8" if int8 else "bf16", got[0], want)
        ms, plain_ms = time_ms(fused), time_ms(plain, 20 if B < 128 else 3)
        dev, fold_dev = graph_ms(fused), graph_ms(fold)
        bd = bound(nbytes(h1, part, gamma, beta, mask, got[0]), {"f32": 8 * h1.numel()})
        label = f"B={B} {mode} {h}x{h} {cin}->{n}, {plan.tiles_h} partial row(s)"
        print(f"kernel GN2-prepass gn2_prepass [{label}]: the same bits on repeat (and as the "
              f"fold alone): {same}; fold rel={frel:.3e} (bound {KERNEL_BOUND['GN-stats']:.0e}); "
              f"values one {'step' if int8 else 'ulp'} apart {share:.2e}, largest {worst:.2f}; "
              f"ms={ms:.4f} device ms={dev:.4f}, the fold alone {fold_dev:.4f}; "
              f"plain_ms={plain_ms:.4f} bound_ms={bd[0]:.4f} (bytes; {bd[0] / dev:.1%} of it)",
              flush=True)
        _record(res, "GN2-prepass", label, worst, share, ms, plain_ms, bd,
                err_is="steps" if int8 else "ulps", graph_ms=dev, fold_graph_ms=fold_dev)
        t = sums.setdefault((mode, B), [0.0, 0.0, 0.0, 0])
        for i, x in enumerate((dev, fold_dev, bd[0], 1)):
            t[i] += x
        flip_bound = S8_FLIP_SHARE if int8 else BF16_FLIP_SHARE
        if not (same and worst <= KERNEL_BOUND["GN2-prepass"] and share <= flip_bound
                and frel <= KERNEL_BOUND["GN-stats"]):
            raise AssertionError(f"GN2-prepass {label}: repeat {same}, fold {frel:.3e}, "
                                 f"{worst} apart on {share:.2e}")
    for (mode, B), (dev, fold_dev, bd, k) in sums.items():
        print(f"sum GN2-prepass {mode} B={B}: {k} sites, device {dev:.4f} ms, the fold alone "
              f"{fold_dev:.4f} ms, bound {bd:.4f} ms [{card_line()}]", flush=True)


def report_gn_routes():
    """GN1's route at each site of the main path: the route function's
    answer (ops/resblock.py:gn_apply_ctas, gn_resample_ctas) beside the
    launches one block call makes (B=4, every K2/K3/K5 and K9 shape, bf16
    and int8 static and per sample): one gn_apply_kernel and no
    gn_stats_kernel where the route is one launch."""
    from gddim_torch.ops import resblock as rb

    cases = [(k, label, fused, args) for k, label, fused, _, args, _ in kernel_cases(4)
             if k in ("K2", "K3", "K5")]
    cases += [(k, label, fused, args) for k, label, fused, _, args in int8_kernel_cases(4)
              if k != "K4-int8"]
    inp = Inputs(11)
    cases += [("K9-int8", label, fused, args)
              for label, fused, _, args, _ in transition_int8_cases(4, inp)]
    for h, c, cout, up in SHAPES["K9"]:
        args = (inp.act(4, h, h, c), inp.act(4, TEMB), inp.w(TEMB, cout).float(), inp.vec(cout),
                inp.vec(c, 1.0), inp.vec(c), inp.w(3, 3, c, cout), inp.vec(cout),
                inp.vec(cout, 1.0), inp.vec(cout), inp.w(3, 3, cout, cout), inp.vec(cout),
                inp.w(c, cout), inp.vec(cout))
        kw = dict(up=up, num_groups1=min(c // 4, 32), num_groups2=min(cout // 4, 32))
        cases.append(("K9", f"{'up' if up else 'down'} {h}x{h} {c}->{cout}",
                      lambda a=args, k=kw: rb.fused_resblock_transition(*a, **k), args))
    for kernel, label, fused, args in cases:
        x = args[0]
        _, h, w, c = x.shape
        if kernel.startswith("K9"):
            up = "up" in label
            ctas = rb.gn_resample_ctas(h, w, c, up)
        else:
            if kernel.startswith("K3"):
                c += args[1].shape[-1]
            ctas = rb.gn_apply_ctas(h, w, c)
        rb.block_launches(reset=True)
        fused()
        torch.cuda.synchronize()
        n = rb.block_launches(kernels=("gn_apply_kernel", "gn_stats_kernel"))
        print(f"route GN1 {kernel} [{label}]: "
              f"{f'one launch, {ctas} CTAs a sample' if ctas else 'two launches'}; the block "
              f"launched gn_apply_kernel {n['gn_apply_kernel']}x, gn_stats_kernel "
              f"{n['gn_stats_kernel']}x", flush=True)
        if not ctas or n != {"gn_apply_kernel": 1, "gn_stats_kernel": 0}:
            raise AssertionError(f"GN1 {kernel} {label}: route {ctas}, launches {n}")


def check_temb_rows(model, card: str, batch: int = 64):
    """The per-eval temb product (``NCSNpp.temb_rows``) against each residual
    block's own f32 projection, and its device time beside the per-block
    products it replaces."""
    from gddim_torch.ops import resblock as rb

    assert not torch.backends.cuda.matmul.allow_tf32, "the temb rows are f32, TF32 off"
    g = torch.Generator(device="cuda").manual_seed(3)
    temb = torch.randn((batch, TEMB), generator=g, device="cuda")
    dense = [blk.temb_dense for blk in model.res_blocks]
    with torch.no_grad():
        rows = model.temb_rows(temb)
        rel = rel_f32 = rel_block = 0.0
        for blk in model.res_blocks:
            w, b = blk.temb_dense.weight, blk.temb_dense.bias
            exact = F.silu(temb.double()) @ w.double() + b.double()
            own = rb.temb_projection(temb, w, b)
            rel = max(rel, _rel(rows[:, blk.temb_cols], exact))
            rel_block = max(rel_block, _rel(own, exact))
            rel_f32 = max(rel_f32, _rel(rows[:, blk.temb_cols], own))
        per_eval = graph_ms(lambda: model.temb_rows(temb))
        per_block = graph_ms(lambda: [rb.temb_projection(temb, d.weight, d.bias) for d in dense])
    cols = rows.shape[1]
    bd = bound(4 * (TEMB * cols + cols + batch * TEMB + batch * cols),
               {"f32": 2 * batch * TEMB * cols})
    print(f"temb rows B={batch}: one f32 product of {len(dense)} blocks' Dense ({TEMB} x {cols}) "
          f"against each block's exact projection rel={rel:.3e} (bound {TEMB_ROWS_BOUND:.0e}; "
          f"the per-block f32 products {rel_block:.3e}, the two f32 products apart "
          f"{rel_f32:.3e}); device "
          f"ms={per_eval:.4f} (torch.addmm), the {len(dense)} per-block products "
          f"{per_block:.4f}; bound_ms={bd[0]:.4f} ({'bytes' if bd[1] >= bd[2] else 'operations'}) "
          f"[{card}]", flush=True)
    if not (np.isfinite(rel) and rel <= TEMB_ROWS_BOUND):
        raise AssertionError(f"temb rows rel err {rel:.3e} > {TEMB_ROWS_BOUND:.0e}")


def trace_blocks(config):
    """[(kind, input shapes, Cout)] of every residual block ('stride1',
    'pair', 'down', 'up') and attention block ('attn') of the config's
    network at B=4, in the order the forward runs them: the forward on the
    meta device with each block replaced by its output's shape."""
    from gddim_torch.models import blocks
    from gddim_torch.models.unet import NCSNpp

    seen = []

    def res(self, x, temb, *args, **kw):
        pair = isinstance(x, (tuple, list))
        shapes = tuple(tuple(t.shape) for t in (x if pair else (x,)))
        cout = self.conv1.weight.shape[-1]
        seen.append(("pair" if pair else "up" if self.up else "down" if self.down else "stride1",
                     shapes, cout))
        b, h, w, _ = shapes[0]
        h, w = (2 * h, 2 * w) if self.up else (h // 2, w // 2) if self.down else (h, w)
        return torch.empty((b, h, w, cout))

    def attn(self, x, *args, **kw):
        seen.append(("attn", (tuple(x.shape),), x.shape[-1]))
        return x

    forwards = blocks.ResnetBlockBigGANpp.forward, blocks.AttnBlockpp.forward
    blocks.ResnetBlockBigGANpp.forward, blocks.AttnBlockpp.forward = res, attn
    try:
        with torch.device("meta"):
            model = NCSNpp(config)
            model.fused = False
            size, ch = config.data.image_size, config.data.num_channels
            model(torch.empty((4, size, size, ch * (2 if config.sde == "cld" else 1))),
                  torch.empty((4,)))
    finally:
        blocks.ResnetBlockBigGANpp.forward, blocks.AttnBlockpp.forward = forwards
    return seen


def gate_disagreements(config) -> tuple[int, list]:
    """Each whole-block kernel gate of the config's network (bf16 and int8)
    against the tile plans it stands for: (gates checked, disagreements)."""
    from gddim_torch.ops import attnblock, resblock as rb

    def planned(plan, *args):
        try:
            plan(*args)
            return True
        except ValueError:
            return False

    def convs(h, w, cin, cskip, cout, int8):
        plan = rb.s8_tile_plan if int8 else rb.bf16_tile_plan
        return planned(plan, 4, h, w, cin, 0, cout) and planned(plan, 4, h, w, cout, cskip, cout)

    n, bad = 0, []
    for kind, shapes, cout in trace_blocks(config):
        b, h, w, c = shapes[0]
        for int8 in (False, True):
            if kind == "stride1":
                pairs = [(rb.stride1_supported(shapes[0], cout, int8),
                          convs(h, w, c, 0 if c == cout else c, cout, int8))]
            elif kind == "pair":
                ca, cb = c, shapes[1][-1]
                pairs = [(rb.pair_supported(shapes[0], cb, cout, int8),
                          ca % rb.GEMM_SKIP_SLICE == 0 and cb % rb.GEMM_SKIP_SLICE == 0
                          and convs(h, w, ca + cb, ca + cb, cout, int8))]
            elif kind == "attn":
                pairs = [(attnblock.supported(shapes[0], int8),
                          planned(attnblock.block_plan, b, h, w, c, int8))]
            else:
                up = kind == "up"
                ho, wo = (2 * h, 2 * w) if up else (h // 2, w // 2)
                want = convs(ho, wo, c, c, cout, int8)
                pairs = [(rb.tail_supported((b, ho, wo, c), cout, int8), want),
                         (rb.transition_supported(shapes[0], cout, up, True, (1, 3, 3, 1), int8),
                          want)]
            for got, want in pairs:
                n += 1
                if got != want:
                    bad.append((kind, shapes, cout, int8, got))
    return n, bad


def phase_gates(card: str):
    """The whole-block kernels' gates (ROADMAP Queue 3's repair): each gate
    against its tile plans at every block of cld/accr_dcifar10 and
    blur/ddpm_deep_cifar10 at nf 32, 64 and 128 (the widths of the JAX
    package's simple and debug configs); then one full-width-depth eps
    evaluation at nf=32 and 64 (B=4, t=0.5, seeded weights, transitions
    'full') through 'fused' and 'fused_int8' (static scales calibrated on the
    card) against the f32 plain path, with each evaluation's launches: the
    blocks the kernels took and those that ran the plain composition."""
    from gddim_torch.cli import build_model, calibrate_int8
    from gddim_torch.configs import get_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.blocks import AttnBlockpp
    from gddim_torch.models.wrappers import make_cld_eps_fn

    for name in ("cld/accr_dcifar10", "blur/ddpm_deep_cifar10"):
        for nf in (32, 64, 128):
            config = get_config(name)
            config.model.nf = nf
            n, bad = gate_disagreements(config)
            print(f"gates {name} nf={nf}: {n} gates (bf16 and int8) against the tile plans, "
                  f"{len(bad)} disagree", flush=True)
            if bad:
                raise AssertionError(f"gates disagree with the tile plans: {bad[:4]}")
    kernels = {"res": ("K2", "K3", "K4", "K9"), "attn": ("K5",)}
    for nf in (32, 64):
        config = get_config("cld/accr_dcifar10")
        config.model.nf = nf
        model = build_model(config, "cuda", None, seed=0)
        eps_apply = make_cld_eps_fn(CLD.from_config(config))
        u, t = eps_inputs()
        model.fused, model.dtype = False, torch.float32
        ref = eps_apply(model, u, t)
        model.fused, model.dtype = True, torch.bfloat16
        calibrate_int8(config, model, seed=0)
        n_res = len(model.res_blocks)
        n_attn = sum(isinstance(m, AttnBlockpp) for _, m in model.scopes)
        for int8 in (False, True):
            model.int8 = int8
            reset_counts()
            got = eps_apply(model, u, t)
            torch.cuda.synchronize()
            counts = {k: v for k, v in read_counts().items() if v}
            suffix = "-int8" if int8 else ""
            took = {kind: sum(counts.get(k + suffix, 0) for k in ks)
                    for kind, ks in kernels.items()}
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            limit = EPS_INT8_BOUND["static_vs_f32"] if int8 else EPS_BOUND
            print(f"gates eps nf={nf} B=4 t=0.5 {'fused_int8 static' if int8 else 'fused'} vs "
                  f"the f32 plain path: rel={rel:.3e} (bound {limit:.2g}); residual blocks on "
                  f"the kernels {took['res']} of {n_res}, plain composition "
                  f"{n_res - took['res']}; attention on K5 {took['attn']} of {n_attn}; "
                  f"launches {counts} [{card}]", flush=True)
            if not (np.isfinite(rel) and rel <= limit):
                raise AssertionError(f"nf={nf} eps rel err {rel:.3e} > {limit:.2g}")
            if nf == 64 and took["res"] == 0:
                raise AssertionError("nf=64: no residual block took the kernels")
        del model


def print_block_sums(*results: dict):
    """The bf16 and int8 blocks and the bare GEMMs summed by kernel, scale
    mode and batch: eager and device ms, bound, and the tensor-core
    products' share of their type's peak over the device time."""
    groups = {}
    for kernel in ("K2", "K3", "K4", "K9", "BF16-GEMM", "K2-int8", "K3-int8", "K4-int8",
                   "K9-int8", "S8-GEMM"):
        kind = "int8" if kernel.endswith("int8") or kernel.startswith("S8") else "bf16"
        for r in (r for res in results for r in res.get(kernel, {}).get("shapes", [])):
            if "graph_ms" not in r:
                continue
            words = r["shape"].split()
            batch = words[0] if words[0].startswith("B=") else "B=4"
            mode = next((w for w in words if w in ("static", "dynamic")), "")
            g = groups.setdefault(" ".join(w for w in (kernel, mode, batch) if w),
                                  dict(n=0, ms=0.0, dev=0.0, bound=0.0, ops=0, kind=kind))
            g["n"] += 1
            for k, v in (("ms", "ms"), ("dev", "graph_ms"), ("bound", "bound_ms"),
                         ("ops", f"{kind}_ops")):
                g[k] += r[v]
    for key, g in groups.items():
        print(f"sum {key}: {g['n']} shapes, eager {g['ms']:.4f} ms, device {g['dev']:.4f} ms, "
              f"bound {g['bound']:.4f} ms, {g['ops'] / PEAK[g['kind']] * 1e3 / g['dev']:.1%} of "
              f"the {g['kind']} peak", flush=True)


def print_sums(*results: dict):
    """K11, the bf16 block GEMM and K8 summed by batch (and dtype): eager and
    device (CUDA graph) ms of the kernel and its library call, bound, and the
    shapes won."""
    groups = {}
    for kernel in ("K11", "BF16-GEMM", "K8"):
        for r in (r for res in results for r in res.get(kernel, {}).get("shapes", [])):
            if "library_graph_ms" not in r:
                continue
            label = r["shape"]
            if kernel == "K8":
                dtype, batch = label.split()[:2]
                key = f"K8 {dtype} {batch}"
            else:
                key = f"{kernel} {label.split()[0]}" if label.startswith("B=") else f"{kernel} B=4"
            g = groups.setdefault(key, dict(n=0, won=0, ms=0.0, lib=0.0, dev=0.0, libdev=0.0,
                                            bound=0.0))
            g["n"] += 1
            g["won"] += r["graph_ms"] <= r["library_graph_ms"]
            for k, v in (("ms", "ms"), ("lib", "library_ms"), ("dev", "graph_ms"),
                         ("libdev", "library_graph_ms"), ("bound", "bound_ms")):
                g[k] += r[v]
    for key, g in groups.items():
        print(f"sum {key}: {g['n']} shapes, kernel {g['ms']:.4f} ms (library {g['lib']:.4f}); "
              f"device kernel {g['dev']:.4f} ms (library {g['libdev']:.4f}, "
              f"{verdict(g['dev'], g['libdev'])}); bound {g['bound']:.4f} ms; device time won "
              f"at {g['won']} of {g['n']} shapes", flush=True)


def phase_transition_kernels(results: dict, batch_results: dict, B: int = 4):
    """K9 (bf16) and its int8 mode (static and per-sample scales) at the 6
    transition shapes, against the plain versions with the TPU kernel's
    rounding points; plain ms of the bf16 composition in bf16. Both modes
    also at BLOCK_BATCHES, into batch_results, with their device time."""
    from gddim_torch.ops import resblock as rb

    def bf16_cases(batch, inp):
        for h, c, cout, up in SHAPES["K9"]:
            kw = dict(up=up, num_groups1=min(c // 4, 32), num_groups2=min(cout // 4, 32))
            label = (f"B={batch} " if batch != B else "") + f"{'up' if up else 'down'} {h}x{h} {c}->{cout}"
            args = (inp.act(batch, h, h, c), inp.act(batch, TEMB), inp.w(TEMB, cout).float(),
                    inp.vec(cout), inp.vec(c, 1.0), inp.vec(c), inp.w(3, 3, c, cout),
                    inp.vec(cout), inp.vec(cout, 1.0), inp.vec(cout), inp.w(3, 3, cout, cout),
                    inp.vec(cout), inp.w(c, cout), inp.vec(cout))
            yield (label, lambda a=args, k=kw: rb.fused_resblock_transition(*a, **k),
                   lambda a=args, k=kw: rb.resblock_transition_bf16_reference(*_f32(a), **k),
                   lambda a=args, k=kw: rb.resblock_transition_reference(*a, **k), args,
                   transition_ops("K9", batch, h, c, cout, up))

    inp = Inputs(4)
    for batch in (B, *BLOCK_BATCHES):
        # B's cases come first from inp; the int8 ones at B draw on from it
        for label, fused, plain, plain_timed, args, ops in bf16_cases(
                batch, inp if batch == B else Inputs(5)):
            _check_kernel(results if batch == B else batch_results, "K9", label, fused, plain,
                          args, ops, plain_timed, plain_reps=20 if batch == B else 5, B=batch,
                          **device_share(ops, graph_ms(fused)))
    for batch in (B, *BLOCK_BATCHES):
        cases = transition_int8_cases(batch, inp if batch == B else Inputs(6))
        for label, fused, plain, args, ops in cases:
            # the int8 plain version sums exactly in float64: no yardstick of speed
            _check_kernel(results if batch == B else batch_results, "K9-int8", label, fused,
                          plain, args, ops, plain_reps=5, B=batch,
                          **device_share(ops, graph_ms(fused)))


def transition_int8_cases(B: int, inp):
    """(label, fused fn, plain fn, kernel args, operations) of K9's int8 mode
    at the 6 transition shapes, static and per-sample scales, drawn from
    ``inp`` (an Inputs)."""
    from gddim_torch.ops import resblock as rb

    qk = lambda *shape: rb.pack_int8_weight(rb.quantize_weight(inp.w(*shape)))  # noqa: E731
    for static in (True, False):
        scales = torch.stack(rb.act_scales_from_amax(INT8_AMAX["res"])).cuda() if static else None
        for h, c, cout, up in SHAPES["K9"]:
            kw = dict(up=up, num_groups1=min(c // 4, 32), num_groups2=min(cout // 4, 32))
            label = (("" if B == 4 else f"B={B} ") + ("static " if static else "dynamic ")
                     + f"{'up' if up else 'down'} {h}x{h} {c}->{cout}")
            args = (inp.act(B, h, h, c), inp.act(B, TEMB), inp.w(TEMB, cout).float(),
                    inp.vec(cout), inp.vec(c, 1.0), inp.vec(c), qk(3, 3, c, cout), inp.vec(cout),
                    inp.vec(cout, 1.0), inp.vec(cout), qk(3, 3, cout, cout), inp.vec(cout),
                    inp.w(c, cout), inp.vec(cout), scales)
            yield (label, lambda a=args, k=kw: rb.fused_resblock_transition_int8(*a, **k),
                   lambda a=args, k=kw: rb.resblock_transition_int8_reference(*_f32(a), **k),
                   args, transition_ops("K9-int8", B, h, c, cout, up))


def phase_attn_train_kernels(results: dict, B: int = 4):
    """K10 at the training path's attention shapes, f32: the forward against
    the f32 plain composition, the 11 gradients against autograd of the plain
    composition; ms of the forward, bound that of K5's forward."""
    from gddim_torch.ops import attnblock

    inp = Inputs(5)
    act = lambda *shape: torch.randn(shape, generator=inp.g, device="cuda")  # noqa: E731
    kw = dict(num_groups=32, skip_rescale=True)
    for h, c in SHAPES["K10"]:
        label = f"f32 {h}x{h}x{c}"
        args = [act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c)]
        for _ in range(4):
            args += [act(c, c) / c ** 0.5, inp.vec(c)]
        g = act(B, h, h, c)
        leaves = lambda: [a.detach().clone().requires_grad_(True) for a in args]  # noqa: E731
        ka, pa = leaves(), leaves()
        out = attnblock.fused_attnblock_train(*ka, **kw)
        ref = attnblock.attnblock_reference(*pa, **kw)
        out.backward(g)
        ref.backward(g)
        torch.cuda.synchronize()
        if out.dtype != torch.float32 or out.shape != ref.shape:
            raise AssertionError(f"K10 {label}: got {out.dtype} {tuple(out.shape)}")
        err, rel = (out - ref).abs().max().item(), _rel(out, ref)
        largest = max(a.grad.abs().max().item() for a in pa)
        # the key bias's exact gradient is zero: on the largest gradient's scale
        grel = max((a.grad - b.grad).abs().max().item()
                   / (LEAF_FLOOR * largest if i == 6 else b.grad.abs().max().item())
                   for i, (a, b) in enumerate(zip(ka, pa)))
        with torch.no_grad():
            ms = time_ms(lambda: attnblock.fused_attnblock_train(*args, **kw))
            plain_ms = time_ms(lambda: attnblock.attnblock_reference(*args, **kw))
        bd = bound(nbytes(args, out), attn_ops("K5", B, h * h, c))
        print(f"kernel K10 fused_attnblock_train [{label}] B={B}: forward max|err|={err:.3e} "
              f"rel={rel:.3e} (bound {KERNEL_BOUND['K10']:.0e}); gradients rel={grel:.3e} "
              f"(bound {K10_GRAD_BOUND:.0e}) ms={ms:.4f} plain_f32_ms={plain_ms:.4f} "
              f"bound_ms={bd[0]:.4f}", flush=True)
        _record(results, "K10", label, err, rel, ms, plain_ms, bd, grad_rel=grel)
        if not (np.isfinite(rel) and rel <= KERNEL_BOUND["K10"] and np.isfinite(grel)
                and grel <= K10_GRAD_BOUND):
            raise AssertionError(f"K10 {label}: forward {rel:.3e}, gradients {grel:.3e} over bounds")


def f32_block_cases(B: int, inp):
    """(kernel, label, fused fn, f32 plain fn, rounding-point plain fn, kernel
    args, operations, convs) of K2/K3/K4/K5/K9 on f32 activations at every
    main-path shape: the bf16 modes' wrappers on f32 x (f32 out), the f32
    plain composition, and the plain version with the TPU kernels' rounding
    points (bf16 MMA operands, f32 elsewhere); convs: the block's (H, Cin,
    Cout, taps) products, the F.conv2d yardstick's. Uses only what a parent's
    checkout has too."""
    from gddim_torch.ops import attnblock, resblock as rb

    act = lambda *shape: torch.randn(shape, generator=inp.g, device="cuda")  # noqa: E731
    for h, cin, cout in SHAPES["K2"]:
        skip = (inp.w(cin, cout), inp.vec(cout)) if cin != cout else (None, None)
        args = (act(B, h, h, cin), act(B, TEMB), inp.w(TEMB, cout).float(), inp.vec(cout),
                inp.vec(cin, 1.0), inp.vec(cin), inp.w(3, 3, cin, cout), inp.vec(cout),
                inp.vec(cout, 1.0), inp.vec(cout), inp.w(3, 3, cout, cout), inp.vec(cout), *skip)
        kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
        convs = [(h, cin, cout, 9), (h, cout, cout, 9)] + ([(h, cin, cout, 1)] if skip[0] is not None
                                                           else [])
        yield ("K2", f"{h}x{h} {cin}->{cout}", lambda a=args, k=kw: rb.fused_resblock(*a, **k),
               lambda a=args, k=kw: rb.resblock_reference(*_f32(a), **k),
               lambda a=args, k=kw: rb.resblock_bf16_reference(*_f32(a), **k), args,
               block_ops("K2", B, h, cin, cout, skip[0] is not None), convs)
    for h, (c1, c2), cout in SHAPES["K3"]:
        cin = c1 + c2
        args = (act(B, h, h, c1), act(B, h, h, c2), act(B, TEMB), inp.w(TEMB, cout).float(),
                inp.vec(cout), inp.vec(cin, 1.0), inp.vec(cin), inp.w(3, 3, cin, cout),
                inp.vec(cout), inp.vec(cout, 1.0), inp.vec(cout), inp.w(3, 3, cout, cout),
                inp.vec(cout), inp.w(cin, cout), inp.vec(cout))
        kw = dict(num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
        yield ("K3", f"{h}x{h} {c1}+{c2}->{cout}",
               lambda a=args, k=kw: rb.fused_resblock_pair(*a, **k),
               lambda a=args, k=kw: rb.resblock_pair_reference(*_f32(a), **k),
               lambda a=args, k=kw: rb.resblock_pair_bf16_reference(*_f32(a), **k), args,
               block_ops("K3", B, h, cin, cout, True),
               [(h, cin, cout, 9), (h, cout, cout, 9), (h, cin, cout, 1)])
    for h, c, cout in SHAPES["K4"]:
        args = (act(B, h, h, c), act(B, h, h, c), act(B, TEMB), inp.w(TEMB, cout).float(),
                inp.vec(cout), inp.w(3, 3, c, cout), inp.vec(cout), inp.vec(cout, 1.0),
                inp.vec(cout), inp.w(3, 3, cout, cout), inp.vec(cout), inp.w(c, cout),
                inp.vec(cout))
        kw = dict(num_groups2=min(cout // 4, 32))
        yield ("K4", f"{h}x{h} {c}->{cout}", lambda a=args, k=kw: rb.fused_resblock_tail(*a, **k),
               lambda a=args, k=kw: rb.resblock_tail_reference(*_f32(a), **k),
               lambda a=args, k=kw: rb.resblock_tail_bf16_reference(*_f32(a), **k), args,
               block_ops("K4", B, h, c, cout, True),
               [(h, c, cout, 9), (h, cout, cout, 9), (h, c, cout, 1)])
    for h, c, cout, up in SHAPES["K9"]:
        kw = dict(up=up, num_groups1=min(c // 4, 32), num_groups2=min(cout // 4, 32))
        args = (act(B, h, h, c), act(B, TEMB), inp.w(TEMB, cout).float(), inp.vec(cout),
                inp.vec(c, 1.0), inp.vec(c), inp.w(3, 3, c, cout), inp.vec(cout),
                inp.vec(cout, 1.0), inp.vec(cout), inp.w(3, 3, cout, cout), inp.vec(cout),
                inp.w(c, cout), inp.vec(cout))
        ho = 2 * h if up else h // 2
        yield ("K9", f"{'up' if up else 'down'} {h}x{h} {c}->{cout}",
               lambda a=args, k=kw: rb.fused_resblock_transition(*a, **k),
               lambda a=args, k=kw: rb.resblock_transition_reference(*_f32(a), **k),
               lambda a=args, k=kw: rb.resblock_transition_bf16_reference(*_f32(a), **k), args,
               transition_ops("K9", B, h, c, cout, up),
               [(ho, c, cout, 9), (ho, cout, cout, 9), (ho, c, cout, 1)])
    for h, c in SHAPES["K5"]:
        args = (act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c),
                *[t for _ in range(4) for t in (inp.w(c, c), inp.vec(c))])
        kw = dict(num_groups=32, skip_rescale=True)
        yield ("K5", f"{h}x{h}x{c}", lambda a=args, k=kw: attnblock.fused_attnblock(*a, **k),
               lambda a=args, k=kw: attnblock.attnblock_reference(*_f32(a), **k),
               lambda a=args, k=kw: attnblock.attnblock_bf16_reference(*_f32(a), **k), args,
               attn_ops("K5", B, h * h, c), [(h, c, 3 * c, 1), (h, c, c, 1)])


def phase_f32_activations(B: int = 4):
    """K2/K3/K4/K5/K9 (the bf16 modes) on f32 activations at every main-path
    shape: f32 out, within F32_ACT_BOUND of the f32 plain composition and
    F32_TPU_BOUND of the plain version with the TPU kernels' rounding points,
    the same bits on repeat; the launches of one call of each kind (every
    block on the block GEMM, GN1 through gn_stats_kernel and the pre-pass)."""
    from gddim_torch.ops import resblock as rb

    worst = {}
    for kernel, label, fused, plain, tpu, args, _, _ in f32_block_cases(B, Inputs(14)):
        rb.block_launches(reset=True)
        out = fused()
        torch.cuda.synchronize()
        launched = {k: n for k, n in rb.block_launches(reset=True).items() if n}
        again = fused()
        ref, ref_tpu = plain(), tpu()
        rel, rel_tpu = _rel(out, ref), _rel(out, ref_tpu)
        same = torch.equal(out, again)
        worst[kernel] = max(worst.get(kernel, 0.0), rel_tpu)
        print(f"kernel {kernel} {KERNELS[kernel]['name']} [f32 activations {label}] B={B}: "
              f"out {out.dtype}, rel={rel:.3e} against the f32 plain composition (bound "
              f"{F32_ACT_BOUND:.0e}), rel={rel_tpu:.3e} against its rounding points (bound "
              f"{F32_TPU_BOUND:.0e}); the same bits on repeat: {same}; launches {launched}",
              flush=True)
        if (out.dtype != torch.float32 or not np.isfinite(rel) or rel > F32_ACT_BOUND
                or not np.isfinite(rel_tpu) or rel_tpu > F32_TPU_BOUND or not same):
            raise AssertionError(f"{kernel} {label} on f32 activations: {out.dtype}, rel {rel:.3e}, "
                                 f"{rel_tpu:.3e}, same bits {same}")
        if launched.get("block_gemm_kernel<bf16>", 0) != 2 or "gn_apply_kernel" in launched:
            raise AssertionError(f"{kernel} {label} on f32: launches {launched}")
    print("kernel f32 activations: worst rel against the rounding points "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)


def conv2d_ms(convs, B: int, inp) -> float:
    """Device ms of F.conv2d (bf16, channels_last, SAME) for each (H, Cin,
    Cout, taps) of ``convs`` at batch B, summed: a block's library yardstick."""
    total = 0.0
    for h, cin, cout, taps in convs:
        x = inp.act(B, h, h, cin).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        k = 3 if taps == 9 else 1
        w = inp.w(cout, cin, k, k, fan_in=k * k * cin).contiguous(memory_format=torch.channels_last)
        total += graph_ms(lambda x=x, w=w, p=k // 2: F.conv2d(x, w, padding=p))
    return total


def phase_f32_time(card: str, batches=(4, 16, 64)):
    """K2/K3/K4/K5/K9 on f32 activations at every main-path shape and each
    batch: device ms (CUDA graph of 20 calls) and the share of the bf16 peak
    its tensor-core products make of it, beside F.conv2d (bf16,
    channels_last) on the same convs, the library yardstick; per kind and
    in all. No check: the kernels phase holds them to their plain versions.
    Uses only what a parent's checkout has too (copy this file there to run
    it on the parent)."""
    for B in batches:
        sums = {}
        inp, lib_inp = Inputs(15), Inputs(16)
        for kernel, label, fused, _, _, args, ops, convs in f32_block_cases(B, inp):
            dev = graph_ms(fused)
            lib = conv2d_ms(convs, B, lib_inp)
            tc = ops.get("bf16", 0) + ops.get("bf16_skip", 0)
            s = sums.setdefault(kernel, [0.0, 0.0, 0, 0])
            s[0], s[1], s[2], s[3] = s[0] + dev, s[1] + lib, s[2] + tc, s[3] + 1
            print(f"f32 {kernel} [{label}] B={B}: device {dev:.4f} ms "
                  f"({tc / PEAK['bf16'] * 1e3 / dev:.1%} of the bf16 peak), F.conv2d "
                  f"{lib:.4f} ms ({verdict(dev, lib)}) [{card}]", flush=True)
        for kernel, (dev, lib, tc, n) in sums.items():
            print(f"sum f32 {kernel} B={B} ({n} shapes): device {dev:.4f} ms "
                  f"({tc / PEAK['bf16'] * 1e3 / dev:.1%} of the bf16 peak), F.conv2d {lib:.4f} ms"
                  f" ({verdict(dev, lib)}) [{card}]", flush=True)
        dev, lib, tc = (sum(v[i] for v in sums.values()) for i in range(3))
        print(f"sum f32 blocks B={B}: device {dev:.4f} ms ({tc / PEAK['bf16'] * 1e3 / dev:.1%} of "
              f"the bf16 peak), F.conv2d {lib:.4f} ms ({verdict(dev, lib)}) [{card}]", flush=True)


def trace_f32_eval(card: str, batch: int = 64, traces: int = 2):
    """One CLD eval with model.dtype float32 and conv_impl 'fused' (the
    transitions 'full') at ``batch``, traced ``traces`` times: kernels,
    device time as their sum and as the union of their intervals
    (busy_ms), the block GEMMs' and conv_gemm_kernel's totals. Uses only
    what a parent's checkout has too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gddim_torch.configs import get_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model
    from gddim_torch.models.wrappers import make_cld_eps_fn

    config = get_config("cld/accr_dcifar10")
    config.model.dtype = "float32"
    config.model.transition_impl = "full"
    model = seeded_model(config, seed=0, device="cuda")
    eps_apply = make_cld_eps_fn(CLD.from_config(config))
    u, t = eps_inputs(batch)
    for _ in range(3):
        eps_apply(model, u, t)
    torch.cuda.synchronize()
    unions = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eps_apply(model, u, t)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        unions.append(busy_ms(prof))
        part = {name: sum(m for k, m, _ in dev if name in k)
                for name in ("block_gemm_kernel", "conv_gemm_kernel", "gn_stats_kernel",
                             "prepass_kernel", "attention_wgmma_kernel")}
        print(f"span f32 B={batch} full [{card}]: kernels {sum(n for *_, n in dev)}, sum "
              f"{sum(m for _, m, _ in dev):.3f} ms, union {unions[-1]:.3f} ms, traced wall "
              f"{wall:.3f} ms; " + ", ".join(f"{k} {v:.3f} ms" for k, v in part.items()),
              flush=True)
        for key, ms, n in sorted(dev, key=lambda r: -r[1])[:8]:
            print(f"  {ms:8.3f} ms {n:5d}x {key[:110]}", flush=True)
    del model
    return unions


def phase_f32(card: str, batch: int):
    """The f32 path as the training loop's eval and sampling snapshots will
    run it (model.dtype float32, conv_impl 'fused', the config's transitions
    'full'): one full-width eps evaluation (B=4, t=0.5) against the f32
    plain path with its launches (every block on the block GEMM's routes,
    none on the plain composition), CLD deis-2 NFE=50 sampling at ``batch``
    through run_lib's sampling loop (finite samples, launches, wall),
    and one traced eval at B=64 (trace_f32_eval)."""
    from gddim_torch.configs import get_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model
    from gddim_torch.models.wrappers import make_cld_eps_fn

    config = get_config("cld/accr_dcifar10")
    config.model.dtype = "float32"
    config.model.conv_impl = "fused"
    model = seeded_model(config, seed=0, device="cuda")
    eps_apply = make_cld_eps_fn(CLD.from_config(config))
    u, t = eps_inputs()
    reset_counts()
    got = eps_apply(model, u, t)
    torch.cuda.synchronize()
    counts = launches_of(PER_EVAL_F32)
    model.fused = False
    ref = eps_apply(model, u, t)
    model.fused = True
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"f32 eps B=4 t=0.5: kernel path (f32 activations) vs plain path (f32) rel={rel:.3e} "
          f"(bound {EPS_F32_BOUND:.0e}); launches {counts}", flush=True)
    if got.dtype != torch.float32 or not np.isfinite(rel) or rel > EPS_F32_BOUND:
        raise AssertionError(f"f32 eps: {got.dtype}, rel err {rel:.3e} > {EPS_F32_BOUND:.0e}")
    if counts != PER_EVAL_F32:
        raise AssertionError(f"f32 launch counts {counts} != {PER_EVAL_F32}")
    samples, wall, sample_counts = _run_samples(config, model, batch, PER_EVAL_F32)
    if not np.isfinite(samples.astype(np.float64)).all():
        raise AssertionError("f32 samples are not finite")
    _sample_line("deis-2 f32", config, batch, wall, card, sample_counts)
    del model
    trace_f32_eval(card, 64, traces=1)
    return sample_counts


# K1's sites by dtype and SiLU: every GroupNorm of the trunk on the
# layer-wise paths (bf16, SiLU: K12's 11 sites, which hold K1's 4 sampling
# sites), attention's GroupNorm (no SiLU), the training shapes (f32, both)
K1_SITES = ([(h, c, torch.bfloat16, True) for h, c in SHAPES["K12"]]
            + [(h, c, torch.bfloat16, False) for h, c in SHAPES["K1_attn"]]
            + [(h, c, torch.float32, silu) for h, c in SHAPES["K1_train"] for silu in (True, False)])


def phase_k1_time(card: str, save: str | None, ref: str | None, batches=(4, 16, 64)):
    """K1 at each of K1_SITES and batch: device ms (CUDA graph), its bytes
    bound's share, the cluster size it chose (where the tree plans one), its
    error against the plain version and the same bits on repeat, beside
    F.group_norm (NCHW view, no SiLU; with SiLU F.group_norm then F.silu);
    per dtype and in all. With ``save`` its outputs at B=4 go to that file;
    with ``ref`` (another tree's file, e.g. the parent's Triton outputs)
    each is held against it (max |this - that| / max |that|, printed). Uses
    only what a parent's checkout has too."""
    from gddim_torch.ops import groupnorm, resblock as rb

    plan = getattr(rb, "gn_silu_ctas", None)
    outs, worst = {}, 0.0
    want = torch.load(ref) if ref else None
    for B in batches:
        inp = Inputs(17)
        sums = {}
        for h, c, dtype, silu in K1_SITES:
            x = torch.randn((B, h, h, c), generator=inp.g, device="cuda").to(dtype)
            gs, gb = inp.vec(c, 1.0), inp.vec(c)
            kw = dict(num_groups=32, eps=1e-6, apply_silu=silu)
            fused = lambda x=x, gs=gs, gb=gb, kw=kw: groupnorm.group_norm_silu(x, gs, gb, **kw)  # noqa: E731
            out, again = fused(), fused()
            plain = groupnorm.group_norm_silu_reference(x.float(), gs, gb, **kw)
            err = _rel(out, plain)
            same = torch.equal(out, again)
            xc, gs_, gb_ = x.permute(0, 3, 1, 2), gs.to(dtype), gb.to(dtype)
            lib = (lambda xc=xc, gs_=gs_, gb_=gb_: F.silu(F.group_norm(xc, 32, gs_, gb_, 1e-6))) \
                if silu else (lambda xc=xc, gs_=gs_, gb_=gb_: F.group_norm(xc, 32, gs_, gb_, 1e-6))
            dev, lib_ms = graph_ms(fused), graph_ms(lib)
            bd = bound(nbytes(x, gs, gb, out), {"f32": 8 * out.numel()})[0]
            key = f"{str(dtype)[6:]} {h}x{h}x{c}{' silu' if silu else ''}"
            k = plan(B, h, h, c, x.element_size()) if plan else None
            vs = ""
            if B == 4:
                outs[key] = out.cpu()
                if want is not None:
                    d = _rel(out.cpu(), want[key])
                    worst = max(worst, d)
                    vs = f", against {ref}: rel={d:.3e}"
            s = sums.setdefault(f"{str(dtype)[6:]}{' silu' if silu else ''}", [0.0, 0.0, 0.0, 0])
            s[0], s[1], s[2], s[3] = s[0] + dev, s[1] + lib_ms, s[2] + bd, s[3] + 1
            print(f"k1 [{key}] B={B}: device {dev:.4f} ms, bound {bd:.4f} ms ({bd / dev:.1%}), "
                  f"F.group_norm{'+silu' if silu else ''} {lib_ms:.4f} ms ({verdict(dev, lib_ms)}); "
                  f"ctas {k}; rel={err:.3e} against the plain version, the same bits on repeat: "
                  f"{same}{vs} [{card}]", flush=True)
            if not same or not np.isfinite(err) or err > (
                    K1_F32_BOUND if dtype == torch.float32 else KERNEL_BOUND["K1"]):
                raise AssertionError(f"K1 {key} B={B}: rel {err:.3e}, same bits {same}")
        for name, (dev, lib_ms, bd, n) in sums.items():
            print(f"sum k1 {name} B={B} ({n} sites): device {dev:.4f} ms, bound {bd:.4f} ms "
                  f"({bd / dev:.1%}), library {lib_ms:.4f} ms ({verdict(dev, lib_ms)}) [{card}]",
                  flush=True)
        dev, lib_ms, bd = (sum(v[i] for v in sums.values()) for i in range(3))
        print(f"sum k1 all B={B}: device {dev:.4f} ms, bound {bd:.4f} ms ({bd / dev:.1%}), "
              f"library {lib_ms:.4f} ms ({verdict(dev, lib_ms)}) [{card}]", flush=True)
    if save:
        torch.save(outs, save)
    if want is not None:
        print(f"k1: worst rel against {ref}: {worst:.3e}", flush=True)


# K5 at the sampling batches; its B=4 rows are in the kernels line (the core
# as K5-core), every other batch's in batch_results
ATTN_BATCHES = (4, 16, 64)


def k5_composition(x, gs, gb, wqkv, bqkv, wo, bo, *, num_groups: int, out_scale: float):
    """K5 as a composition of PyTorch calls in x's dtype, the yardstick of
    the block (no single call computes it): F.group_norm, one matmul for
    [q|k|v], scaled_dot_product_attention on (B, 1, S, C) views, one matmul
    for the output, the residual."""
    b, h, w, c = x.shape
    x2 = x.reshape(b, h * w, c)
    hn = F.group_norm(x2.transpose(1, 2), num_groups, gs, gb, 1e-6).transpose(1, 2)
    q, k, v = (hn @ wqkv + bqkv).chunk(3, -1)
    a = F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])[:, 0]
    return ((x2 + a @ wo + bo) * out_scale).reshape(x.shape)


def host_ms(fn, reps: int = 20) -> float:
    """Host time to enqueue one call (the host clock around ``reps`` calls
    with no synchronize between them; the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def phase_attn_kernels(results: dict, card: str):
    """K5 at ATTN_BATCHES on its two shapes: the bf16 block through the
    model's packed path against the f32 plain composition and against its
    rounding-point plain version, the int8 modes (static and per-sample)
    against their plain version, each timed (eager, device, host enqueue,
    the share of its type's peak, bound, plain ms) beside the composition
    yardstick (k5_composition); then the attention core alone on the block's
    own q, k, v (bf16, int8 and f32 outputs) against its plain version beside
    SDPA, and the two 1x1 projections on the block GEMM alone (bf16 against
    the f32 product beside torch.matmul, int8 bit for bit against the exact
    product beside torch._int_mm). The core's B=4 rows go into the kernels
    line."""
    from gddim_torch.ops import attnblock as ab, resblock as rb

    inp = Inputs(9)
    kw = dict(num_groups=32, skip_rescale=True)
    sums = {}
    for B in ATTN_BATCHES:
        for h, c in SHAPES["K5"]:
            s = h * h
            tag = f"B={B} {h}x{h}x{c}"
            args = (inp.act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c),
                    *[t for _ in range(4) for t in (inp.w(c, c), inp.vec(c))])
            x, gs, gb = args[:3]
            packed = ab.pack_attn_weights(*args[3:])
            wb = [packed.wqkv, packed.bqkv.to(x.dtype), packed.wo, args[10].to(x.dtype)]
            comp = lambda: k5_composition(x, gs.to(x.dtype), gb.to(x.dtype), *wb,  # noqa: E731
                                          num_groups=32, out_scale=ab._INV_SQRT2)
            comp_ms, comp_dev = time_ms(comp), graph_ms(comp)
            # the bf16 block, as the model calls it
            fused = lambda: ab.fused_attnblock_packed(x, gs, gb, packed, **kw)  # noqa: E731
            out = fused()
            torch.cuda.synchronize()
            rel = _rel(out, ab.attnblock_reference(*_f32(args), **kw))
            rel_rp = _rel(out, ab.attnblock_bf16_reference(*_f32(args), **kw))
            print(f"kernel K5 fused_attnblock [{tag}]: rel={rel:.3e} (bound "
                  f"{KERNEL_BOUND['K5']:.0e}), against its rounding points rel={rel_rp:.3e} "
                  f"(bound {K5_RP_BOUND:.0e})", flush=True)
            if not (np.isfinite(rel) and rel <= KERNEL_BOUND["K5"] and rel_rp <= K5_RP_BOUND):
                raise AssertionError(f"K5 {tag}: rel {rel:.3e}, rounding points {rel_rp:.3e}")
            cases = [("bf16", fused, lambda: ab.attnblock_reference(*args, **kw), args,
                      attn_ops("K5", B, s, c))]
            # the int8 modes, from the same x and weights
            wqkv8 = ab.pack_projection(rb.quantize_weight(torch.cat(args[3:9:2], 1)))
            wo8 = ab.pack_projection(rb.quantize_weight(args[9]))
            for static in (True, False):
                scales = (torch.stack(rb.act_scales_from_amax(INT8_AMAX["attn"])).cuda()
                          if static else None)
                a8 = (x, gs, gb, wqkv8, torch.cat(args[4:9:2]), wo8, args[10], scales)
                mode = "static" if static else "dynamic"
                fused8 = lambda a=a8: ab.fused_attnblock_int8(*a, **kw)  # noqa: E731
                plain8 = lambda a=a8: ab.attnblock_int8_reference(*_f32(a), **kw)  # noqa: E731
                out8 = fused8()
                torch.cuda.synchronize()
                rel8 = _rel(out8, plain8())
                print(f"kernel K5-int8 fused_attnblock_int8 [{tag} {mode}]: rel={rel8:.3e} "
                      f"(bound {KERNEL_BOUND['K5-int8']:.0e})", flush=True)
                if not np.isfinite(rel8) or rel8 > KERNEL_BOUND["K5-int8"]:
                    raise AssertionError(f"K5-int8 {tag}: rel err {rel8:.3e}")
                cases.append((f"int8 {mode}", fused8, plain8, a8, attn_ops("K5-int8", B, s, c)))
            # their times, each beside the composition
            for mode, fn, plain_fn, a, ops in cases:
                kind = "int8" if "int8" in ops else "bf16"
                ms, dev, host = time_ms(fn), graph_ms(fn), host_ms(fn)
                bd = bound(nbytes(a, out), ops)
                print(f"time K5 {mode} [{tag}]: ms={ms:.4f} device ms={dev:.4f} "
                      f"({ops[kind] / PEAK[kind] * 1e3 / dev:.1%} of the {kind} peak) host "
                      f"enqueue ms={host:.4f} plain_ms={time_ms(plain_fn, 3):.4f} "
                      f"bound_ms={bd[0]:.4f} ({'bytes' if bd[1] >= bd[2] else 'operations'}); "
                      f"composition ms={comp_ms:.4f} device ms={comp_dev:.4f} (device time "
                      f"{verdict(dev, comp_dev)}) [{card}]", flush=True)
            # the core alone, on this block's q, k, v (bf16, as the projection writes them)
            hn = F.group_norm(x.float().permute(0, 3, 1, 2), 32, gs, gb, 1e-6)
            hn = hn.permute(0, 2, 3, 1).bfloat16().contiguous()
            qkv = (hn.float() @ packed.wqkv.float() + packed.bqkv).bfloat16().reshape(B, s, 3 * c)
            check_core(results if B == 4 else {}, sums, qkv, tag, B)
            # the projections alone on the block GEMM
            check_projections(sums, hn, packed, wqkv8, wo8, tag, B)
    for key, g in sums.items():
        print(f"sum {key}: {g['n']} shapes, eager {g['ms']:.4f} ms, device {g['dev']:.4f} ms, "
              f"library {g['lib']:.4f} ms, device {g['libdev']:.4f} ms (device time "
              f"{verdict(g['dev'], g['libdev'])}), bound {g['bound']:.4f} ms", flush=True)


def _sum(sums, key, ms, dev, lib, libdev, bd):
    g = sums.setdefault(key, dict(n=0, ms=0.0, dev=0.0, lib=0.0, libdev=0.0, bound=0.0))
    g["n"] += 1
    for k, v in (("ms", ms), ("dev", dev), ("lib", lib), ("libdev", libdev), ("bound", bd[0])):
        g[k] += v


def check_core(res, sums, qkv, tag: str, B: int):
    """K5's attention core alone on qkv (B, S, 3C) bf16 against its plain
    version (bf16 and f32 a and the amax within the bound, bf16 a differing
    on at most core_flip_share(S) of the values, int8 a one step on at most
    S8_FLIP_SHARE), beside SDPA on (B, 1, S, C) views."""
    from gddim_torch.ops import attnblock as ab, resblock as rb

    _, s, c3 = qkv.shape
    c = c3 // 3
    fused = lambda: ab.attention_core(qkv)  # noqa: E731
    plain = lambda: ab.attention_core_reference(qkv)  # noqa: E731
    a = fused()
    a32, amax = ab.attention_core(qkv, mode="f32")
    s_a = rb.act_scales_from_amax((1.0,))[0].cuda()
    a8 = ab.attention_core(qkv, mode="int8", act_scale=s_a)
    torch.cuda.synchronize()
    ref = plain()
    ref32, ref_amax = ab.attention_core_reference(qkv, mode="f32")
    rel, share = _rel(a, ref), (a != ref).float().mean().item()
    step8 = (a8.int() - ab.attention_core_reference(qkv, mode="int8", act_scale=s_a).int()).abs()
    steps8, share8 = step8.max().item(), (step8 > 0).float().mean().item()
    rel32, rel_amax = _rel(a32, ref32), _rel(amax, ref_amax)
    q, k, v = (t[:, None] for t in qkv.chunk(3, -1))
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    ms, dev, plain_ms = time_ms(fused), graph_ms(fused), time_ms(plain)
    lib, libdev = time_ms(sdpa), graph_ms(sdpa)
    ops = {"bf16": 4 * B * s * s * c}
    bd = bound(nbytes(qkv, a), ops)
    share_pk = ops["bf16"] / PEAK["bf16"] * 1e3 / dev
    flip_bound = core_flip_share(s)
    print(f"kernel K5-core attention_core [{tag}]: bf16 a rel={rel:.3e} (bound "
          f"{KERNEL_BOUND['K5-core']:.0e}), differing on {share:.2e} of the values (bound "
          f"{flip_bound:.0e}); int8 a steps {steps8} on {share8:.2e} (bound "
          f"{S8_FLIP_SHARE:.0e}); f32 a rel={rel32:.3e}, amax rel={rel_amax:.3e} ms={ms:.4f} "
          f"device ms={dev:.4f} "
          f"({share_pk:.1%} of the bf16 peak; a ring of {ab.core_plan(B, s)}) "
          f"plain_ms={plain_ms:.4f} bound_ms={bd[0]:.4f} "
          f"({'bytes' if bd[1] >= bd[2] else 'operations'}); SDPA ms={lib:.4f} device "
          f"ms={libdev:.4f} (device time {verdict(dev, libdev)})", flush=True)
    _record(res, "K5-core", tag, (a.float() - ref.float()).abs().max().item(), rel, ms,
            plain_ms, bd, lib, graph_ms=dev, library_graph_ms=libdev, bf16_peak_share=share_pk,
            differing=share, rel_f32=rel32, int8_flip_share=share8)
    _sum(sums, f"K5-core B={B}", ms, dev, lib, libdev, bd)
    bound_ = KERNEL_BOUND["K5-core"]
    if not (rel <= bound_ and share <= flip_bound and steps8 <= 1 and share8 <= S8_FLIP_SHARE
            and rel32 <= bound_ and rel_amax <= bound_):
        raise AssertionError(f"K5-core {tag}: bf16 {rel:.3e} on {share:.2e}, int8 steps "
                             f"{steps8} on {share8:.2e}, f32 {rel32:.3e}, amax {rel_amax:.3e}")


def check_projections(sums, hn, packed, wqkv8, wo8, tag: str, B: int):
    """K5's two 1x1 projections on the block GEMM alone: bf16 (h by [Wq|Wk|Wv]
    and by Wo) against the f32 product beside torch.matmul in bf16, int8
    (int8 h by the K-major int8 weights) bit for bit against the exact
    product beside torch._int_mm."""
    from gddim_torch.ops import conv3x3, resblock as rb

    m, c = hn.shape[0] * hn.shape[1] * hn.shape[2], hn.shape[-1]
    h8, _ = conv3x3.quantize_per_sample(hn)
    for name, w, w8 in (("qkv", packed.wqkv, wqkv8.q), ("out", packed.wo, wo8.q)):
        n = w.shape[-1]
        label = f"{tag} {name} {c}->{n}"
        fused = lambda: rb.bf16_conv_gemm(hn, w)  # noqa: E731
        out = fused()
        torch.cuda.synchronize()
        ref = hn.float() @ w.float()
        rel = _rel(out, ref)
        a2 = hn.reshape(m, c)
        lib = lambda: torch.matmul(a2, w)  # noqa: E731
        ops = {"bf16": 2 * m * c * n}
        ms, dev, lib_ms, lib_dev = time_ms(fused), graph_ms(fused), time_ms(lib), graph_ms(lib)
        mw = rb.bf16_tile_plan(*hn.shape, 0, n, taps=1).mw
        bd = bound(nbytes(hn, w, out), ops)
        print(f"kernel BF16-GEMM bf16_conv_gemm [1x1 {label}]: rel={rel:.3e} (bound "
              f"{KERNEL_BOUND['BF16-GEMM']:.0e}) ms={ms:.4f} device ms={dev:.4f} "
              f"({ops['bf16'] / PEAK['bf16'] * 1e3 / dev:.1%} of the bf16 peak; {128 * mw}-pixel "
              f"tiles) bound_ms={bd[0]:.4f}; "
              f"torch.matmul ms={lib_ms:.4f} device ms={lib_dev:.4f} "
              f"(device time {verdict(dev, lib_dev)})", flush=True)
        _sum(sums, f"BF16-GEMM 1x1 B={B}", ms, dev, lib_ms, lib_dev, bd)
        if out.dtype != torch.float32 or not np.isfinite(rel) or rel > KERNEL_BOUND["BF16-GEMM"]:
            raise AssertionError(f"BF16-GEMM 1x1 {label}: rel err {rel:.3e}")
        fused8 = lambda: rb.int8_conv_gemm(h8, w8)  # noqa: E731
        out8 = fused8()
        torch.cuda.synchronize()
        exact = torch.equal(out8, rb.int8_matmul_exact(h8, w8.t()))
        a8 = h8.reshape(m, c)
        lib8 = lambda: torch._int_mm(a8, w8.t())  # noqa: E731
        ops8 = {"int8": 2 * m * c * n}
        ms8, dev8, lib8_ms, lib8_dev = time_ms(fused8), graph_ms(fused8), time_ms(lib8), graph_ms(lib8)
        bd8 = bound(nbytes(h8, w8, out8), ops8)
        print(f"kernel S8-GEMM int8_conv_gemm [1x1 {label}]: sums bit-identical to the exact "
              f"product: {exact} ms={ms8:.4f} device ms={dev8:.4f} "
              f"({ops8['int8'] / PEAK['int8'] * 1e3 / dev8:.1%} of the int8 peak) "
              f"bound_ms={bd8[0]:.4f}; torch._int_mm ms={lib8_ms:.4f} device ms={lib8_dev:.4f} "
              f"(device time {verdict(dev8, lib8_dev)})", flush=True)
        _sum(sums, f"S8-GEMM 1x1 B={B}", ms8, dev8, lib8_ms, lib8_dev, bd8)
        if not exact:
            raise AssertionError(f"S8-GEMM 1x1 {label}: sums differ from the exact product")


def train_block_inputs(inp: Inputs, B: int, h: int, cin: int, cout: int, keep: float = 0.9):
    """f32 operands of one training block (not rounded to bf16, so the
    kernels' bf16 operand rounding shows), a seeded dropout mask and a
    cotangent."""
    g = inp.g
    act = lambda *shape: torch.randn(shape, generator=g, device="cuda")  # noqa: E731
    w = lambda *shape: act(*shape) / float(np.prod(shape[:-1])) ** 0.5  # noqa: E731
    skip = (w(cin, cout), inp.vec(cout)) if cin != cout else (None, None)
    args = (act(B, h, h, cin), act(B, cout), inp.vec(cin, 1.0), inp.vec(cin),
            w(3, 3, cin, cout), inp.vec(cout), inp.vec(cout, 1.0), inp.vec(cout),
            w(3, 3, cout, cout), inp.vec(cout), *skip)
    mask = (torch.rand((B, h, h, cout), generator=g, device="cuda") < keep).to(torch.int8)
    return args, mask, act(B, h, h, cout)


def phase_train_kernels(results: dict, batch_results: dict, B: int = 4):
    """K1 in f32 at every training-path GroupNorm shape, K6 and K7 at every
    training-path block shape, their GEMMs alone (``check_train_gemms``),
    K8 at its shapes."""
    from gddim_torch.ops import attention, groupnorm, resblock, resblock_bwd

    inp = Inputs(1)
    for h, c in SHAPES["K1_train"]:
        args = (torch.randn((B, h, h, c), generator=inp.g, device="cuda"), inp.vec(c, 1.0),
                inp.vec(c))
        for silu in (True, False):
            kw = dict(num_groups=32, eps=1e-6, apply_silu=silu)
            label = f"f32 {h}x{h}x{c}{' silu' if silu else ''}"
            fused = lambda: groupnorm.group_norm_silu(*args, **kw)  # noqa: E731
            plain = lambda: groupnorm.group_norm_silu_reference(*args, **kw)  # noqa: E731
            out = fused()
            torch.cuda.synchronize()
            ref = plain()
            if out.dtype != torch.float32 or out.shape != ref.shape:
                raise AssertionError(f"K1 {label}: got {out.dtype} {tuple(out.shape)}")
            err, rel = (out - ref).abs().max().item(), _rel(out, ref)
            ms, plain_ms = time_ms(fused), time_ms(plain)
            bd = bound(nbytes(args, out), {"f32": 8 * out.numel()})
            print(f"kernel K1 group_norm_silu [{label}] B={B}: max|err|={err:.3e} rel={rel:.3e} "
                  f"(bound {K1_F32_BOUND:.0e}) ms={ms:.4f} plain_f32_ms={plain_ms:.4f} "
                  f"bound_ms={bd[0]:.4f}", flush=True)
            _record(results, "K1", label, err, rel, ms, plain_ms, bd)
            if not np.isfinite(rel) or rel > K1_F32_BOUND:
                raise AssertionError(f"K1 {label}: rel err {rel:.3e} > {K1_F32_BOUND:.0e}")

    for h, cin, cout in SHAPES["K6"]:
        args, mask, g = train_block_inputs(inp, B, h, cin, cout)
        kw = dict(keep_prob=0.9, num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
        label = f"{h}x{h} {cin}->{cout}"
        fused = lambda: resblock.fused_resblock_train(*args, mask, **kw)  # noqa: E731
        plain = lambda: resblock.resblock_train_reference(*args, mask, **kw)  # noqa: E731
        out = fused()
        torch.cuda.synchronize()
        ref = plain()
        if out.shape != ref.shape or out.dtype != torch.float32:
            raise AssertionError(f"K6 {label}: got {out.dtype} {tuple(out.shape)}")
        err, rel = (out - ref).abs().max().item(), _rel(out, ref)
        ms, plain_ms = time_ms(fused), time_ms(plain)
        skip = args[10] is not None
        bd = bound(nbytes(args, mask, out), block_ops("K6", B, h, cin, cout, skip))
        print(f"kernel K6 fused_resblock_train [{label}] B={B}: max|err|={err:.3e} "
              f"rel={rel:.3e} (bound {KERNEL_BOUND['K6']:.0e}) ms={ms:.4f} "
              f"plain_f32_ms={plain_ms:.4f} bound_ms={bd[0]:.4f}", flush=True)
        _record(results, "K6", label, err, rel, ms, plain_ms, bd)
        if not np.isfinite(rel) or rel > KERNEL_BOUND["K6"]:
            raise AssertionError(f"K6 {label}: rel err {rel:.3e} > {KERNEL_BOUND['K6']:.0e}")

        kgrads = lambda: resblock_bwd.fused_resblock_train_grads(*args, mask, g, **kw)  # noqa: E731
        pgrads = lambda: resblock_bwd.resblock_train_grads_reference(*args, mask, g, **kw)  # noqa: E731
        got, again = kgrads(), kgrads()
        torch.cuda.synchronize()
        want = pgrads()
        errs = {}
        for name, a, b2, w in zip(GRADS, got, again, want):
            if w is None:
                if a is not None:
                    raise AssertionError(f"K7 {label}: {name} should be None without a skip")
                continue
            if not torch.equal(a, b2):
                raise AssertionError(f"K7 {label}: {name} differs between two runs")
            errs[name] = _rel(a, w)
        ms, plain_ms = time_ms(kgrads), time_ms(pgrads)
        abs_err = max((a - w).abs().max().item() for a, w in zip(got, want) if w is not None)
        bd = bound(nbytes(args, mask, g, got), block_ops("K7", B, h, cin, cout, skip))
        print(f"kernel K7 fused_resblock_train_grads [{label}] B={B}: bit-identical on repeat; "
              + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
              + f" (bounds {K7_BOUND['dx']:.1e}, db2 and dbsk {K7_BOUND['db2']:.0e}) "
              f"ms={ms:.4f} plain_f32_ms={plain_ms:.4f} bound_ms={bd[0]:.4f}", flush=True)
        _record(results, "K7", label, abs_err, max(errs.values()), ms, plain_ms, bd, grads=errs)
        bad = {k: v for k, v in errs.items() if not np.isfinite(v) or v > K7_BOUND[k]}
        if bad:
            raise AssertionError(f"K7 {label}: gradients over their bounds: {bad}")

    # conv2's weight zero: out = (x + b2)/sqrt(2), so the identity residual
    # shows whether x stays f32 through K6
    args, mask, _ = train_block_inputs(inp, B, 16, 256, 256)
    args = list(args)
    args[8] = torch.zeros_like(args[8])
    kw = dict(keep_prob=0.9, num_groups1=32, num_groups2=32)
    out = resblock.fused_resblock_train(*args, mask, **kw)
    ref = resblock.resblock_train_reference(*args, mask, **kw)
    rel = _rel(out, ref)
    print(f"kernel K6 fused_resblock_train [16x16 256->256, conv2 weight 0] B={B}: "
          f"rel={rel:.3e} (bound {K6_RESIDUAL_BOUND:.0e}; a bf16 x would give ~2e-3)", flush=True)
    results["K6"]["shapes"].append(dict(shape="16x16 256->256, conv2 weight 0", rel=rel))
    if not np.isfinite(rel) or rel > K6_RESIDUAL_BOUND:
        raise AssertionError(f"K6 residual: rel err {rel:.3e} > {K6_RESIDUAL_BOUND:.0e}")
    check_train_gemms(results, batch_results)
    check_gn_bwd(results, batch_results)

    for b, s_, c in SHAPES["K8"] + SHAPES["K8_train"]:
        q, k, v = (torch.randn((b, s_, c), generator=inp.g, device="cuda") for _ in range(3))
        # 3xTF32: three TF32 products per f32 product
        check_attention(results, q, k, v, {"tf32": 3 * 4 * b * s_ * s_ * c}, KERNEL_BOUND["K8"])
    for b, s_, c in SHAPES["K8_bf16"]:
        q, k, v = (torch.randn((b, s_, c), generator=inp.g, device="cuda").bfloat16()
                   for _ in range(3))
        check_attention(results, q, k, v, {"bf16": 4 * b * s_ * s_ * c}, K8_BF16_BOUND)


def train_gemm_cases(inp: Inputs, B: int, h: int, cin: int, cout: int):
    """(row, label, kernel fn, plain fn, library fn, operands, bf16 products)
    of the GEMMs of one training block shape: on the block GEMM K6's conv1
    and conv2 (K7's conv1 is conv1), K7's two dgrads and the skip's 1x1
    dgrad (the forward's weights read as they are); on wgrad_kernel dW2, dW1
    and dW_skip. Library: one PyTorch call in bf16 channels_last, F.conv2d
    (a dgrad: the conv with the flipped, transposed weights) and
    torch.nn.grad.conv2d_weight."""
    from gddim_torch.ops import resblock, resblock_bwd

    a1, d, g = inp.act(B, h, h, cin), inp.act(B, h, h, cout), inp.act(B, h, h, cout)
    w1, w2 = inp.w(3, 3, cin, cout), inp.w(3, 3, cout, cout)
    cl = torch.channels_last
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731  (channels_last views)
    oihw = lambda w: w.permute(3, 2, 0, 1).contiguous(memory_format=cl)  # noqa: E731
    dgrad_w = lambda w: oihw(w.flip(0, 1).transpose(2, 3))  # noqa: E731
    m = B * h * h
    cases = [
        ("train-GEMM", f"conv1 {cin}->{cout}", lambda: resblock.bf16_conv_gemm(a1, w1),
         lambda: resblock.conv3x3_nhwc(a1.float(), w1.float()),
         (lambda x=nchw(a1), w=oihw(w1): F.conv2d(x, w, padding=1)), (a1, w1),
         2 * m * 9 * cin * cout),
        ("train-GEMM", f"conv2 {cout}->{cout}", lambda: resblock.bf16_conv_gemm(d, w2),
         lambda: resblock.conv3x3_nhwc(d.float(), w2.float()),
         (lambda x=nchw(d), w=oihw(w2): F.conv2d(x, w, padding=1)), (d, w2),
         2 * m * 9 * cout * cout),
        ("train-GEMM", f"dgrad2 {cout}->{cout}", lambda: resblock_bwd.bf16_dgrad_gemm(g, w2),
         lambda: resblock_bwd.dgrad_reference(g, w2),
         (lambda x=nchw(g), w=dgrad_w(w2): F.conv2d(x, w, padding=1)), (g, w2),
         2 * m * 9 * cout * cout),
        ("train-GEMM", f"dgrad1 {cout}->{cin}", lambda: resblock_bwd.bf16_dgrad_gemm(g, w1),
         lambda: resblock_bwd.dgrad_reference(g, w1),
         (lambda x=nchw(g), w=dgrad_w(w1): F.conv2d(x, w, padding=1)), (g, w1),
         2 * m * 9 * cin * cout),
        ("wgrad", f"dW2 {cout}x{cout}", lambda: resblock_bwd.wgrad(d, g),
         lambda: resblock_bwd.wgrad_reference(d, g),
         (lambda x=nchw(d), y=nchw(g): torch.nn.grad.conv2d_weight(x, (cout, cout, 3, 3), y,
                                                                  padding=1)),
         (d, g), 2 * m * 9 * cout * cout),
        ("wgrad", f"dW1 {cin}x{cout}", lambda: resblock_bwd.wgrad(a1, g),
         lambda: resblock_bwd.wgrad_reference(a1, g),
         (lambda x=nchw(a1), y=nchw(g): torch.nn.grad.conv2d_weight(x, (cout, cin, 3, 3), y,
                                                                   padding=1)),
         (a1, g), 2 * m * 9 * cin * cout),
    ]
    if cin != cout:
        ws = inp.w(cin, cout)
        cases += [
            ("train-GEMM", f"skip dgrad {cout}->{cin}", lambda: resblock_bwd.bf16_dgrad_gemm(g, ws),
             lambda: resblock_bwd.dgrad_reference(g, ws),
             (lambda x=nchw(g), w=ws[:, :, None, None].contiguous(memory_format=cl):
              F.conv2d(x, w)), (g, ws), 2 * m * cin * cout),
            ("wgrad", f"dW_skip {cin}x{cout}", lambda: resblock_bwd.wgrad(a1, g, 1),
             lambda: resblock_bwd.wgrad_reference(a1, g, 1),
             (lambda x=nchw(a1), y=nchw(g): torch.nn.grad.conv2d_weight(x, (cout, cin, 1, 1), y)),
             (a1, g), 2 * m * cin * cout),
        ]
    return cases


def check_train_gemms(results: dict, batch_results: dict, batches=(4, 128)):
    """K6/K7's GEMMs alone (``train_gemm_cases``) at every training block
    shape against their plain versions on the same bf16 operands
    (TRAIN_GEMM_BOUND), with eager and device (CUDA graph) time, the share
    of the bf16 peak and the library call's time; B=4 in the kernels line,
    B=128 (the training batch) in the sums."""
    for B in batches:
        inp = Inputs(7)
        sums = {}
        for h, cin, cout in SHAPES["K6"]:
            for row, label, fused, plain, library, ops_in, prods in train_gemm_cases(
                    inp, B, h, cin, cout):
                out = fused()
                torch.cuda.synchronize()
                ref = plain()
                if out.dtype != torch.float32 or out.shape != ref.shape:
                    raise AssertionError(f"{row} {label}: got {out.dtype} {tuple(out.shape)}")
                err, rel = (out - ref).abs().max().item(), _rel(out, ref)
                ms, plain_ms = time_ms(fused), time_ms(plain, 20 if B == 4 else 3)
                lib_ms = time_ms(library)
                dev, lib_dev = graph_ms(fused), graph_ms(library)
                bd = bound(nbytes(ops_in, out), {"bf16": prods})
                share = prods / PEAK["bf16"] * 1e3 / dev
                tag = f"{h}x{h} {label}"
                print(f"kernel {row} {KERNELS[row]['name']} [{tag}] B={B}: max|err|={err:.3e} "
                      f"rel={rel:.3e} (bound {TRAIN_GEMM_BOUND:.0e}) ms={ms:.4f} "
                      f"plain_f32_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bd[0]:.4f} "
                      f"({'bytes' if bd[1] >= bd[2] else 'operations'}); device {dev:.4f} ms "
                      f"({share:.1%} of the bf16 peak), library {lib_dev:.4f} "
                      f"({verdict(dev, lib_dev)})", flush=True)
                _record(results if B == 4 else batch_results, row, tag, err, rel, ms, plain_ms,
                        bd, lib_ms, graph_ms=dev, library_graph_ms=lib_dev, bf16_peak_share=share)
                s = sums.setdefault(row, [0.0, 0.0, 0.0])
                s[0], s[1], s[2] = s[0] + dev, s[1] + lib_dev, s[2] + prods
                if not np.isfinite(rel) or rel > TRAIN_GEMM_BOUND:
                    raise AssertionError(f"{row} {tag} B={B}: rel err {rel:.3e} > "
                                         f"{TRAIN_GEMM_BOUND:.0e}")
        for row, (dev, lib_dev, prods) in sums.items():
            print(f"sum {row} B={B}: device {dev:.4f} ms ({prods / PEAK['bf16'] * 1e3 / dev:.1%} "
                  f"of the bf16 peak), library {lib_dev:.4f} ms ({verdict(dev, lib_dev)}) "
                  f"[{card_line()}]", flush=True)


def gn_bwd_composition(dpre, v, stats, gamma, groups: int, mask, keep: float):
    """K7's GN backward as PyTorch calls on NCHW tensors, the yardstick of
    gn_silu_bwd (never used by the port): the SiLU (and dropout) backward
    elementwise, then aten.native_group_norm_backward."""
    sc, sh, mean, rstd = stats
    b, c, h, w = v.shape
    y = v * sc[:, :, None, None] + sh[:, :, None, None]
    s = torch.sigmoid(y)
    d = dpre if mask is None else dpre * (mask * (1.0 / keep))
    dy = d * (s * (1.0 + y * (1.0 - s)))
    return torch.ops.aten.native_group_norm_backward(dy, v, mean, rstd, gamma, b, c, h * w,
                                                     groups, [True, True, True])


def gumm_flips(got, ref, floor: float):
    """(largest difference in bf16 ulps of ref among the values that differ
    by more than ``floor``, share of values that differ at all): GN2's bf16
    gumm against the plain version's. Where o = rstd * (dy * gamma - m1 -
    yhat * m2) cancels to near zero, f32 last bits of the group means move
    it by several ulps of itself; ``floor`` (GN_BWD_BOUND of max|o|) is the
    f32 outputs' own bound."""
    diff = (got.float() - ref.float()).abs()
    big = diff > floor
    steps = bf16_steps(got, ref)
    return (steps[big].max().item() if big.any() else 0.0), (diff > 0).float().mean().item()


def check_gn_bwd(results: dict, batch_results: dict, batches=(4, 128)):
    """K7's GroupNorm(+SiLU) backward alone (gn_bwd_kernel) at every training
    block shape: GN2's form on Cout (the dropout mask, g's sums, dtemb,
    gumm in bf16) and GN1's on Cin (plus the skip's dx, or r * g for the
    identity skip), against its plain version on the same f32 inputs, the
    same bits on repeat, with device time (CUDA graph), its bound (every
    input read once, every output written once), the share of the bound and
    the composition's device time (gn_bwd_composition); B=4 in the kernels
    line, B=128 (the training batch) in the sums. At the 32x32 GN1 sites of
    256 and 384 channels, also the other plan: a 16-CTA cluster that holds
    the whole sample."""
    from gddim_torch.ops import resblock, resblock_bwd

    r = 2 ** -0.5
    for B in batches:
        res = results if B == batches[0] else batch_results
        inp = Inputs(12)
        tot = {"dev": 0.0, "bound": 0.0, "lib": 0.0}
        for h, cin, cout in SHAPES["K6"]:
            for c, gn2 in ((cout, True), (cin, False)):
                g = inp.g
                act = lambda: torch.randn((B, h, h, c), generator=g, device="cuda")  # noqa: E731
                groups = min(c // 4, 32)
                v, dpre, other = act() + 0.2, act(), act()
                gamma, beta = inp.vec(c, 1.0), inp.vec(c)
                stats = resblock.gn_stats_reference(v, groups, 1e-6, gamma, beta)
                mask = (torch.rand((B, h, h, c), generator=g, device="cuda") < 0.9).to(torch.int8)
                if gn2:
                    kw = dict(mask=mask, keep_prob=0.9, extra=other, out_bf16=True)
                    form = f"GN2 {c}, mask, g's sums, dtemb"
                else:
                    kw = dict(add=other, add_scale=1.0 if cin != cout else r)
                    form = f"GN1 {c}, + {'the skip dx' if cin != cout else 'r * g'}"
                fused = lambda kw=kw, plan=None: resblock_bwd.gn_silu_bwd(  # noqa: E731
                    dpre, v, *stats, gamma, num_groups=groups, plan=plan, **kw)
                plain = lambda kw=kw: resblock_bwd.gn_silu_bwd_reference(  # noqa: E731
                    dpre, v, *stats, gamma, num_groups=groups, **kw)
                nchw = [t.permute(0, 3, 1, 2).contiguous() for t in (dpre, v, mask)]
                library = lambda gn2=gn2, nchw=nchw: gn_bwd_composition(  # noqa: E731
                    nchw[0], nchw[1], stats, gamma, groups, nchw[2] if gn2 else None, 0.9)
                got, again = fused(), fused()
                torch.cuda.synchronize()
                want = plain()
                same = all(a is None or torch.equal(a, b2) for a, b2 in zip(got, again))
                rel, err, worst, share = 0.0, 0.0, 0.0, 0.0
                for name, a, w in zip(resblock_bwd.GnBwd._fields, got, want):
                    if w is None:
                        continue
                    if name == "out" and gn2:
                        worst, share = gumm_flips(a, w, KERNEL_BOUND["GN-bwd"]
                                                  * w.float().abs().max().item())
                    else:
                        rel = max(rel, _rel(a, w))
                        err = max(err, (a.float() - w.float()).abs().max().item())
                ms, plain_ms = time_ms(fused), time_ms(plain, 20 if B == 4 else 3)
                dev, lib_dev = graph_ms(fused), graph_ms(library)
                bd = bound(nbytes(dpre, v, stats, gamma, mask if gn2 else None, other, got),
                           {"f32": 20 * v.numel()})
                plan = resblock.gn_bwd_plan(B, h, h, c)
                label = f"B={B} {h}x{h} {form}"
                print(f"kernel GN-bwd gn_silu_bwd [{label}]: {plan.ctas} CTAs a sample, "
                      f"{plan.held} of {plan.share} pixels held, {plan.smem} B; rel={rel:.3e} "
                      f"(bound {KERNEL_BOUND['GN-bwd']:.0e})"
                      + (f", gumm values that differ {share:.2e} (bound {BF16_FLIP_SHARE:.0e}), "
                         f"those beyond {KERNEL_BOUND['GN-bwd']:.0e} of max|o| at most "
                         f"{worst:.2f} ulps (bound 1)" if gn2 else "")
                      + f"; same bits on repeat: {same}; ms={ms:.4f} device ms={dev:.4f} "
                      f"plain_ms={plain_ms:.4f} bound_ms={bd[0]:.4f} (bytes; "
                      f"{bd[0] / dev:.1%} of it); composition device ms={lib_dev:.4f} "
                      f"({verdict(dev, lib_dev)})", flush=True)
                _record(res, "GN-bwd", label, err, rel, ms, plain_ms, bd, time_ms(library),
                        graph_ms=dev, library_graph_ms=lib_dev, bound_share=bd[0] / dev,
                        gumm_flips=share if gn2 else None)
                tot["dev"] += dev
                tot["bound"] += bd[0]
                tot["lib"] += lib_dev
                if not (same and np.isfinite(rel) and rel <= KERNEL_BOUND["GN-bwd"]
                        and worst <= 1 and share <= BF16_FLIP_SHARE):
                    raise AssertionError(f"GN-bwd {label}: rel {rel:.3e}, gumm {worst} ulps on "
                                         f"{share:.2e}, repeat {same}")
                if h == 32 and c in (256, 384) and not gn2:
                    # the other way to take the largest samples: a 16-CTA
                    # (non-portable) cluster that holds the whole sample
                    alt = resblock.gn_bwd_plan(B, h, h, c, ctas=16, held=64)
                    out_alt = fused(plan=alt)
                    torch.cuda.synchronize()
                    ok = all(a is None or _rel(a, w) <= KERNEL_BOUND["GN-bwd"]
                             for a, w in zip(out_alt, want))
                    alt_dev = graph_ms(lambda: fused(plan=alt))
                    print(f"  GN-bwd other plan [{label}]: {alt.ctas} CTAs holding the whole "
                          f"sample ({alt.smem} B a CTA): device ms={alt_dev:.4f} against "
                          f"{dev:.4f} ({plan.ctas} CTAs, {plan.held} of {plan.share} pixels "
                          f"held, the rest read again); within bound: {ok}", flush=True)
                    if not ok:
                        raise AssertionError(f"GN-bwd {label}: the 16-CTA plan disagrees")
                del v, dpre, other, mask, got, again, want, nchw
        print(f"sum GN-bwd B={B}: {2 * len(SHAPES['K6'])} cases, device {tot['dev']:.4f} ms, "
              f"bound {tot['bound']:.4f} ms ({tot['bound'] / tot['dev']:.1%} of it), "
              f"composition device {tot['lib']:.4f} ms ({verdict(tot['dev'], tot['lib'])}) "
              f"[{card_line()}]", flush=True)


def time_train_blocks(card: str, batches=(4, 16, 64, 128)):
    """K6 and K7 device ms a call (CUDA graph of 20 calls) at every training
    block shape and batch, and their share of the bf16 peak; only the
    wrappers both trees have, so a parent's checkout runs it too."""
    from gddim_torch.ops import resblock, resblock_bwd

    inp = Inputs(1)
    for B in batches:
        tot = {"K6": [0.0, 0], "K7": [0.0, 0]}
        for h, cin, cout in SHAPES["K6"]:
            args, mask, g = train_block_inputs(inp, B, h, cin, cout)
            kw = dict(keep_prob=0.9, num_groups1=min(cin // 4, 32),
                      num_groups2=min(cout // 4, 32))
            runs = {"K6": lambda: resblock.fused_resblock_train(*args, mask, **kw),
                    "K7": lambda: resblock_bwd.fused_resblock_train_grads(*args, mask, g, **kw)}
            line = []
            for k, fn in runs.items():
                dev = graph_ms(fn)
                prods = block_ops(k, B, h, cin, cout, cin != cout)["bf16"]
                tot[k][0] += dev
                tot[k][1] += prods
                line.append(f"{k} {dev:.4f} ms ({prods / PEAK['bf16'] * 1e3 / dev:.1%})")
            print(f"time train blocks [{h}x{h} {cin}->{cout}] B={B}: device " + ", ".join(line),
                  flush=True)
            del args, mask, g
        print(f"sum train blocks B={B}: device " + ", ".join(
            f"{k} {ms:.4f} ms ({p / PEAK['bf16'] * 1e3 / ms:.1%} of the bf16 peak)"
            for k, (ms, p) in tot.items()) + f" [{card}]", flush=True)


# kernels of K6 and K7 by name in a trace (both trees' names)
TRAIN_BLOCK_KERNELS = ("block_gemm_kernel", "block_splitk", "wgrad_kernel", "rowsum_kernel",
                       "prepass_kernel", "gn_prepass_kernel", "round_kernel", "gn_bwd_kernel",
                       "gn_stats_kernel")


def profile_train_step(card: str, train_step, state, images, label: str):
    """One traced training step (loss, backward, Adam): host enqueue, device
    time, idle share, the kernels that take the time, and K6/K7's share
    (TRAIN_BLOCK_KERNELS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    train_step(state, images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, images)
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total, busy = sum(ms for _, ms, _ in dev), busy_ms(prof)
    print(f"profile train step B={images.shape[1]} ({label}) [{card}]: wall {traced:.3f} ms, "
          f"host enqueue {enqueue:.3f} ms, device {total:.3f} ms in {sum(n for *_, n in dev)} "
          f"kernels (busy {busy:.3f} ms, their union), idle share {1 - busy / traced:.3f}",
          flush=True)
    for key, ms, n in sorted(dev, key=lambda r: -r[1])[:15]:
        print(f"  {ms:9.3f} ms {n:6d}x {key[:110]}", flush=True)
    blocks = 0.0
    for name in TRAIN_BLOCK_KERNELS:
        hit = [(m, n) for key, m, n in dev if name in key and not (
            name == "prepass_kernel" and "gn_prepass_kernel" in key)]
        blocks += sum(m for m, _ in hit)
        print(f"  {name}: {sum(m for m, _ in hit):.3f} ms in {sum(n for _, n in hit)} launches",
              flush=True)
    print(f"  K6 + K7 kernels: {blocks:.3f} ms of {total:.3f}", flush=True)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])[:10]
    print("  host, by self CPU time (traced): " + "; ".join(
        f"{key[:40]} {ms:.1f} ms {n}x" for key, ms, n in host), flush=True)
    return total


def phase_eval_span(card: str, batch: int = 64):
    """The CLD eval at ``batch`` with transition_impl 'full' (bench.py's
    path), bf16 then int8 static (calibrated on the card), in the order a,
    b, b, a, each traced twice: kernels, device time as their sum and as the
    union of their intervals (busy_ms), and GN2's pre-pass and the block
    GEMM's totals. Uses only what a parent's checkout has too (copy this
    file there to run it on the parent)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gddim_torch.cli import build_model, calibrate_int8
    from gddim_torch.configs import get_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.wrappers import make_cld_eps_fn

    config = get_config("cld/accr_dcifar10")
    config.model.transition_impl = "full"
    config.model.conv_impl = "fused_int8"
    model = build_model(config, "cuda", None, seed=0)
    calibrate_int8(config, model, seed=0)
    eps_apply = make_cld_eps_fn(CLD.from_config(config))
    u, t = eps_inputs(batch)
    for name, int8 in (("bf16", False), ("int8", True), ("int8", True), ("bf16", False)):
        model.int8 = int8
        for _ in range(3):
            eps_apply(model, u, t)
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                eps_apply(model, u, t)
                torch.cuda.synchronize()
            dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            pre = [(m, n) for k, m, n in dev if "gn_prepass_kernel" in k]
            print(f"span {name} B={batch} full [{card}]: kernels {sum(n for *_, n in dev)}, sum "
                  f"{sum(m for _, m, _ in dev):.3f} ms, union {busy_ms(prof):.3f} ms; "
                  f"gn_prepass_kernel {sum(m for m, _ in pre):.3f} ms in {sum(n for _, n in pre)};"
                  f" block_gemm_kernel {sum(m for k, m, _ in dev if 'block_gemm_kernel' in k):.3f}"
                  f" ms", flush=True)
    del model


# The blur layer-wise paths' kernels by name, in a parent's trace and in this
# tree's: K11 int8 on the int8 block GEMM (+ block_splitk_s32_kernel), K12 on
# gn_apply_kernel, K11 bf16 on conv3x3_wgmma_kernel (+ its split sums), K1
# (the Triton gn_silu_kernel, or csrc/groupnorm.cu's of the same name)
BLUR_SPAN_KERNELS = {"K11-int8": ("conv3x3_s8_kernel", "s8_splitk_kernel", "block_gemm_kernel",
                                  "block_splitk"),
                     "K12": ("gn_silu_amax_kernel", "gn_silu_quant_kernel", "gn_apply_kernel"),
                     "K11": ("conv3x3_wgmma_kernel", "wgmma_splitk_kernel"),
                     "K1": ("gn_silu_kernel",)}


def phase_blur_span(card: str, batches=(64, 16)):
    """One blur/ddpm_deep_cifar10 eval through the layer-wise 'int8' path
    (conv_impl 'int8': K12 into K11 int8 in every residual block) and the
    'pallas' path (K1 into K11 bf16) at each batch, traced twice: its
    kernels, device time as their sum and as the union of their intervals,
    and the totals of BLUR_SPAN_KERNELS (K11 int8, K12, K11, K1); then K11
    int8 and K12 alone (time_layer_kernels). Uses only what a parent's
    checkout has too (copy this file there to run it on the parent)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gddim_torch.cli import build_model
    from gddim_torch.configs import get_config
    from gddim_torch.math.blur import BlurSDE
    from gddim_torch.models.wrappers import make_blur_yeps_fn

    config = get_config("blur/ddpm_deep_cifar10")
    config.model.conv_impl = "int8"
    model = build_model(config, "cuda", None, seed=0)
    yeps = make_blur_yeps_fn(BlurSDE.from_config(config))
    for batch, layer in ((b, layer) for b in batches for layer in ("int8", "pallas")):
        model.layer = layer
        u, t = eps_inputs(batch)
        y = u[..., 0]
        for _ in range(3):
            yeps(model, y, t)
        torch.cuda.synchronize()
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                yeps(model, y, t)
                torch.cuda.synchronize()
            dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            parts = []
            for name, keys in BLUR_SPAN_KERNELS.items():
                hit = [(k, m, n) for k, m, n in dev if any(p in k for p in keys)]
                parts.append(f"{name} {sum(m for _, m, _ in hit):.3f} ms in "
                             f"{sum(n for *_, n in hit)} ("
                             + ", ".join(f"{k[:40]} {n}x" for k, _, n in hit) + ")")
            print(f"span blur {layer} B={batch} [{card}]: kernels {sum(n for *_, n in dev)}, sum "
                  f"{sum(m for _, m, _ in dev):.3f} ms, union {busy_ms(prof):.3f} ms; "
                  + "; ".join(parts), flush=True)
    del model
    time_layer_kernels(card)


def time_layer_kernels(card: str, batches=(4, 16, 64)):
    """K11 int8 at its 13 shapes (beside the bare int8 block GEMM on the same
    operands) and K12 at its 11 sites (bf16 and f32 x) alone, device ms (CUDA
    graph) at each batch, with the int8 peak's or the bytes bound's share,
    through the op-level calls a parent's checkout has too, on the same
    seeded inputs in either tree. No check: the kernels phase holds both
    kernels to their plain versions."""
    import inspect

    from gddim_torch.ops import conv3x3, groupnorm, resblock as rb

    packed = "w_kmajor" in inspect.signature(conv3x3.conv3x3_pallas_int8).parameters
    for batch in batches:
        inp = Inputs(13)
        k11, bare, ops, rows = 0.0, 0.0, 0, []
        for h, cin, cout in SHAPES["K11"]:
            x8, sx = conv3x3.quantize_per_sample(inp.act(batch, h, h, cin))
            w8, sw = conv3x3.quantize_weight_per_channel(inp.w(3, 3, cin, cout))
            bias, wk = inp.vec(cout), rb.pack_int8_weight((w8, sw))[0]
            kw = dict(w_kmajor=wk) if packed else {}
            ms = graph_ms(lambda: conv3x3.conv3x3_pallas_int8(x8, w8, sw, sx, bias, **kw))
            k11, bare = k11 + ms, bare + graph_ms(lambda: rb.int8_conv_gemm(x8, wk))
            ops += 2 * batch * h * h * 9 * cin * cout
            rows.append(f"{h}x{h} {cin}->{cout} {ms:.4f}")
        print(f"alone K11-int8 B={batch} [{card}]: 13 shapes device {k11:.4f} ms "
              f"({ops / PEAK['int8'] * 1e3 / k11:.1%} of the int8 peak), the bare int8 GEMM "
              f"{bare:.4f} ms; " + ", ".join(rows), flush=True)
        for dtype in (torch.bfloat16, torch.float32):
            k12, bd, rows = 0.0, 0.0, []
            for h, c in SHAPES["K12"]:
                x = inp.act(batch, h, h, c).to(dtype)
                gs, gb = inp.vec(c, 1.0), inp.vec(c)
                ms = graph_ms(lambda: groupnorm.group_norm_silu_quant(x, gs, gb, 32))
                k12 += ms
                bd += 1e3 * (nbytes(x, gs, gb) + x.numel() + 4 * batch) / HBM
                rows.append(f"{h}x{h}x{c} {ms:.4f}")
            print(f"alone K12 {str(dtype).split('.')[-1]} B={batch} [{card}]: 11 sites device "
                  f"{k12:.4f} ms, bytes bound {bd:.4f} ms ({bd / k12:.1%}); " + ", ".join(rows),
                  flush=True)


def phase_bits(save: str, ref: str | None):
    """What GN2's pre-pass and the per-sample int8 quantizer make, through
    the blocks that consume them, on seeded inputs: one eps evaluation at
    B=4 and 64 (transition_impl 'full', bf16, int8 static and int8 per
    sample: all 76 GN2 pre-passes of an eval, every site and every sampling
    mode), K6's forward at every training shape (B=4; the pre-pass's
    training form), the blur layer-wise 'int8' eval at B=4 and 64, and K12
    at its 11 sites (B=4), saved to ``save``; with ``ref`` (the file of
    another tree, e.g. the parent's), each tensor bit for bit against it.
    Uses only what a parent's checkout has too."""
    from gddim_torch.cli import build_model, calibrate_int8
    from gddim_torch.configs import get_config
    from gddim_torch.math.blur import BlurSDE
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.wrappers import make_blur_yeps_fn, make_cld_eps_fn
    from gddim_torch.ops import groupnorm, resblock

    config = get_config("cld/accr_dcifar10")
    config.model.transition_impl = "full"
    config.model.conv_impl = "fused_int8"
    model = build_model(config, "cuda", None, seed=0)
    calibrate_int8(config, model, seed=0)
    eps_apply = make_cld_eps_fn(CLD.from_config(config))
    out = {}
    for batch in (4, 64):
        u, t = eps_inputs(batch)
        for name, int8 in (("bf16", False), ("int8", True)):
            model.int8 = int8
            out[f"eps {name} B={batch}"] = eps_apply(model, u, t)
        qscales, model.qscales = model.qscales, {}
        out[f"eps int8 per-sample B={batch}"] = eps_apply(model, u, t)
        model.qscales = qscales
    del model
    inp = Inputs(21)
    for h, cin, cout in SHAPES["K6"]:
        args, mask, _ = train_block_inputs(inp, 4, h, cin, cout)
        kw = dict(keep_prob=0.9, num_groups1=min(cin // 4, 32), num_groups2=min(cout // 4, 32))
        out[f"K6 {h}x{h} {cin}->{cout}"] = resblock.fused_resblock_train(*args, mask, **kw)
    config = get_config("blur/ddpm_deep_cifar10")
    config.model.conv_impl = "int8"
    model = build_model(config, "cuda", None, seed=0)
    yeps = make_blur_yeps_fn(BlurSDE.from_config(config))
    for batch in (4, 64):
        u, t = eps_inputs(batch)
        out[f"blur int8 B={batch}"] = yeps(model, u[..., 0], t)
    del model
    for h, c in SHAPES["K12"]:
        q, qs = groupnorm.group_norm_silu_quant(inp.act(4, h, h, c), inp.vec(c, 1.0),
                                                inp.vec(c), 32)
        out[f"K12 {h}x{h}x{c} q"], out[f"K12 {h}x{h}x{c} qs"] = q, qs
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, save)
    print(f"bits: {len(out)} tensors saved to {save}", flush=True)
    if ref:
        want = torch.load(ref)
        differ = [k for k, v in out.items() if not torch.equal(v.cpu(), want[k])]
        print(f"bits: the same bits as {ref}: {len(out) - len(differ)} of {len(out)}; "
              f"differ: {differ}", flush=True)
        if differ:
            raise AssertionError(f"bits differ from {ref}: {differ}")


def phase_gn_bwd_plans(card: str, batch: int = 128):
    """K7's GN backward at every GN site of the training shapes, each form,
    under every cluster size and a few held counts (the whole share where it
    fits, and what 113, 74 and 54 KB hold): device ms against the bound, the
    plan gn_bwd_plan picks marked *."""
    from gddim_torch.ops import resblock as rb, resblock_bwd as rbw

    g = torch.Generator(device="cuda").manual_seed(0)
    seen = set()
    for h, cin, cout in SHAPES["K6"]:
        for c, gn2 in ((cout, True), (cin, False)):
            if (h, c, gn2) in seen:
                continue
            seen.add((h, c, gn2))
            v, dpre, other = (torch.randn((batch, h, h, c), generator=g, device="cuda")
                              for _ in range(3))
            groups = min(c // 4, 32)
            gamma, beta = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
            stats = rb.gn_stats_reference(v, groups, 1e-6, gamma, beta)
            mask = (torch.rand((batch, h, h, c), generator=g, device="cuda") < 0.9).to(torch.int8)
            kw = (dict(mask=mask, keep_prob=0.9, extra=other, out_bf16=True) if gn2
                  else dict(add=other, add_scale=1.0))
            hw, default = h * h, rb.gn_bwd_plan(batch, h, h, c)
            bd = 1e3 * (nbytes(dpre, v, other, mask if gn2 else None)
                        + v.numel() * (2 if gn2 else 4)) / HBM
            line = []
            for ctas in rb.GN_BWD_CLUSTERS:
                if ctas > hw or c % ctas:
                    continue
                share, most = -(-hw // ctas), rb._gn_bwd_most_held(c)
                helds = {min(share, most)} | {min(share, k) for k in (
                    rb._gn_bwd_most_held(c, cap) for cap in (113 * 1024, 74 * 1024, 54 * 1024))
                    if k > 0}
                for held in sorted(helds):
                    plan = rb.gn_bwd_plan(batch, h, h, c, ctas=ctas, held=held)
                    ms = graph_ms(lambda plan=plan: rbw.gn_silu_bwd(
                        dpre, v, *stats, gamma, num_groups=groups, plan=plan, **kw))
                    line.append(f"{ctas}/{held}{'*' if plan == default else ''} "
                                f"{plan.smem // 1024}K {ms:.4f} ({bd / ms:.0%})")
            print(f"plans GN{'2' if gn2 else '1'} {h}x{h}x{c} B={batch} bound {bd:.4f} ms "
                  f"[{card}]: " + "; ".join(line), flush=True)
            del v, dpre, other, mask


def synthetic_stream(config, seed: int = 11):
    """Endless scaled batches of the synthetic corpus on the card, shaped
    (n_jitted_steps, batch, 32, 32, C): the training iterator of
    get_dataset with no data_dir, drawn from ``seed``."""
    from gddim_torch.data.pipelines import get_data_scaler, get_dataset

    config = copy.deepcopy(config)
    config.seed, config.data.data_dir = seed, ""
    train_iter, _ = get_dataset(config, additional_dim=int(config.training.n_jitted_steps),
                                prefetch=False)
    scaler = get_data_scaler(config)
    for batch in train_iter:
        yield torch.from_numpy(scaler(batch["image"])).to("cuda")


def phase_train_time(card: str):
    """K6 and K7 device ms at every training shape and B=4/16/64/128, then one
    traced B=128 step (fused_attn off) and 5 timed steps: img/s, peak memory.
    Uses only what a parent tree with data/pipelines.py has too."""
    from gddim_torch.configs import train_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model
    from gddim_torch.train.losses import make_cld_loss_fn
    from gddim_torch.train.state import create_train_state
    from gddim_torch.train.step import make_train_step

    time_train_blocks(card)
    config = train_config("cld/accr_dcifar10")
    n_steps, batch = int(config.training.n_jitted_steps), int(config.training.batch_size)
    model = seeded_model(config, seed=0, device="cuda").train()
    model.fused_attn = False
    loss_fn = make_cld_loss_fn(CLD.from_config(config), train=True)
    batches = next(synthetic_stream(config))
    state = create_train_state(config, model, torch.Generator(device="cuda").manual_seed(3))
    train_step = make_train_step(loss_fn)
    profile_train_step(card, train_step, state, batches[:1], "kernel path")
    for _ in range(2):
        loss, sec, peak = _timed_steps(state, train_step, batches)
        print(f"train_time kernel path: {n_steps} steps B={batch} {sec:.3f} s, "
              f"{n_steps * batch / sec:.2f} img/s, loss {loss:.5f}, peak {peak:.2f} GiB [{card}]",
              flush=True)


# The loss-curve A/B of K7 (train_ab): the kernel path's and the plain
# path's per-step losses over TRAIN_AB_STEPS Adam steps from the same weights,
# data, t, z and dropout masks, compared as means over windows of
# TRAIN_AB_WINDOW steps. On an H100 (B=128) the window means parted by at
# most 1.7e-4 (single steps 1.9e-4) while the loss fell from 1.37 to 1.04;
# the bound leaves about 6x
TRAIN_AB_STEPS = 200
TRAIN_AB_WINDOW = 20
TRAIN_AB_BOUND = 1e-3


def phase_train_ab(card: str, steps: int = TRAIN_AB_STEPS):
    """Two training runs of ``steps`` Adam steps at the config's batch on the
    synthetic stream, the kernel path (K6/K7, the config's attention) and
    conv_impl 'plain' (model.fused off), the same seeds; fails if a window
    mean of the loss differs by more than TRAIN_AB_BOUND of the plain one."""
    from gddim_torch.configs import train_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model
    from gddim_torch.train.losses import make_cld_loss_fn
    from gddim_torch.train.state import create_train_state
    from gddim_torch.train.step import make_train_step

    config = train_config("cld/accr_dcifar10")
    batch = int(config.training.batch_size)
    curves = {}
    for name, fused in (("kernel", True), ("plain", False)):
        model = seeded_model(config, seed=0, device="cuda").train()
        model.fused = fused
        loss_fn = make_cld_loss_fn(CLD.from_config(config), train=True,
                                   reduce_mean=config.training.reduce_mean)
        stream = synthetic_stream(config)
        state = create_train_state(config, model, torch.Generator(device="cuda").manual_seed(3))
        train_step = make_train_step(loss_fn)
        losses = []
        t0 = time.perf_counter()
        while len(losses) < steps:
            for images in next(stream)[:, None]:
                if len(losses) < steps:
                    losses.append(float(train_step(state, images)["loss"]))
        wall = time.perf_counter() - t0
        curves[name] = np.asarray(losses)
        print(f"train_ab {name} path: {steps} steps B={batch} {wall:.1f} s, loss first "
              f"{losses[0]:.5f} last {losses[-1]:.5f}, mean of the last {TRAIN_AB_WINDOW} "
              f"{np.mean(losses[-TRAIN_AB_WINDOW:]):.5f} [{card}]", flush=True)
        del model, state, train_step
        torch.cuda.empty_cache()
    k, p = (curves[n].reshape(-1, TRAIN_AB_WINDOW).mean(1) for n in ("kernel", "plain"))
    part = np.abs(k - p) / np.abs(p)
    step = np.abs(curves["kernel"] - curves["plain"]) / np.abs(curves["plain"])
    print(f"train_ab: window means (kernel / plain) "
          + ", ".join(f"{a:.5f}/{b:.5f}" for a, b in zip(k, p)), flush=True)
    print(f"train_ab: windows of {TRAIN_AB_WINDOW} steps part by at most {part.max():.3e} "
          f"(bound {TRAIN_AB_BOUND:.0e}; window {int(part.argmax())}); single steps by at most "
          f"{step.max():.3e}, median {np.median(step):.3e}", flush=True)
    if not np.isfinite(part).all() or part.max() > TRAIN_AB_BOUND:
        raise AssertionError(f"train_ab: the loss curves part by {part.max():.3e} > "
                             f"{TRAIN_AB_BOUND:.0e}")


def check_attention(results, q, k, v, ops: dict, tol: float):
    """K8 on q/k/v of one dtype against the plain version on the same inputs,
    beside scaled_dot_product_attention in that dtype."""
    from gddim_torch.ops import attention

    (b, s_, c), dt = q.shape, str(q.dtype).split(".")[-1]
    label = f"{dt} B={b} S={s_} C={c}"
    fused = lambda: attention.flash_attention(q, k, v)  # noqa: E731
    plain = lambda: attention.attention_xla(q, k, v)  # noqa: E731
    out = fused()
    torch.cuda.synchronize()
    ref = plain()
    if out.dtype != q.dtype or out.shape != q.shape:
        raise AssertionError(f"K8 {label}: got {out.dtype} {tuple(out.shape)}")
    err, rel = (out.float() - ref.float()).abs().max().item(), _rel(out, ref)
    ms, plain_ms = time_ms(fused), time_ms(plain)
    # (B, 1, S, C) views: one head, so that SDPA may take its fused backends
    sdpa = lambda: F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])  # noqa: E731
    library_ms = time_ms(sdpa)
    dev_ms, library_dev_ms = graph_ms(fused), graph_ms(sdpa)
    bd = bound(nbytes(q, k, v, out), ops)
    print(f"kernel K8 flash_attention [{label}]: max|err|={err:.3e} rel={rel:.3e} "
          f"(bound {tol:.0e}) ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
          f"({verdict(ms, library_ms)}) bound_ms={bd[0]:.4f} "
          f"({'bytes' if bd[1] >= bd[2] else 'operations'}); device (CUDA graph) "
          f"ms={dev_ms:.4f} sdpa_ms={library_dev_ms:.4f} ({verdict(dev_ms, library_dev_ms)})",
          flush=True)
    _record(results, "K8", label, err, rel, ms, plain_ms, bd, library_ms=library_ms,
            graph_ms=dev_ms, library_graph_ms=library_dev_ms)
    if not np.isfinite(rel) or rel > tol:
        raise AssertionError(f"K8 {label}: rel err {rel:.3e} > {tol:.0e}")


def phase_layer_kernels(results: dict, batch_results: dict, B: int = 4,
                        batches=(4, 16, 64)):
    """K11 (bf16 and int8) and K12 at every shape of the layer-wise paths,
    and K1 without SiLU at the attention shapes beside F.group_norm; K11
    int8 and K12 at each of ``batches`` (B's rows in the kernels line, the
    others in batch_results) with device time."""
    from gddim_torch.ops import conv3x3, groupnorm

    inp = Inputs(3)
    for h, cin, cout in SHAPES["K11"]:
        check_conv(results, inp.act(B, h, h, cin), inp.w(3, 3, cin, cout),
                   f"{h}x{h} {cin}->{cout}", B)
    # K11 bf16 at the layer-wise sampling paths' batches too
    for batch in (16, 64):
        for h, cin, cout in SHAPES["K11"]:
            check_conv(results, inp.act(batch, h, h, cin), inp.w(3, 3, cin, cout),
                       f"B={batch} {h}x{h} {cin}->{cout}", batch)
    for batch in batches:
        res = results if batch == B else batch_results
        for h, cin, cout in SHAPES["K11"]:
            check_conv_int8(res, inp, batch, h, cin, cout)
        for h, c in SHAPES["K12"]:
            for dtype in (torch.bfloat16, torch.float32):
                check_k12(res, inp, batch, h, c, dtype)
    # sums past 2^24 (the exact int32 split-K; f32 partials would round
    # them) with a scalar activation scale: the split 4x4 512->256 and the
    # unsplit 32x32 384->128
    for h, cin, cout in ((4, 512, 256), (32, 384, 128)):
        check_conv_int8(batch_results, inp, B, h, cin, cout, large=True)
    print_layer_sums(results, batch_results)
    for h, c in SHAPES["K1_attn"]:
        label = f"{h}x{h}x{c} no silu"
        x, gs, gb = inp.act(B, h, h, c), inp.vec(c, 1.0), inp.vec(c)
        kw = dict(num_groups=32, eps=1e-6, apply_silu=False)
        gs16, gb16, xc = gs.to(x.dtype), gb.to(x.dtype), x.permute(0, 3, 1, 2)
        _check_kernel(results, "K1", label, lambda: groupnorm.group_norm_silu(x, gs, gb, **kw),
                      lambda: groupnorm.group_norm_silu_reference(x.float(), gs, gb, **kw),
                      (x, gs, gb), {"f32": 8 * x.numel()},
                      library_ms=time_ms(lambda: F.group_norm(xc, 32, gs16, gb16, 1e-6)), B=B)


def check_conv_int8(res, inp, B: int, h: int, cin: int, cout: int, large: bool = False):
    """K11 int8 on the int8 block GEMM at one shape, bit-identical to its exact
    plain version (float64 sums rounded once to f32, the dequantization's
    f32 operations), with its device time and int8-peak share beside the
    bare int8 GEMM's on the same operands. large: every sum past 2^24
    (positive operands near 127) and a scalar activation scale."""
    from gddim_torch.ops import conv3x3, resblock as rb

    label = f"B={B} {h}x{h} {cin}->{cout}" + (" sums>2^24 scalar scale" if large else "")
    if large:
        x8 = torch.randint(100, 128, (B, h, h, cin), generator=inp.g, device="cuda",
                           dtype=torch.int8)
        w8 = torch.randint(100, 128, (3, 3, cin, cout), generator=inp.g, device="cuda",
                           dtype=torch.int8)
        sw = 1e-4 * (1.0 + torch.rand((cout,), generator=inp.g, device="cuda"))
        sx = torch.tensor(3.7e-3, device="cuda")
    else:
        x8, sx = conv3x3.quantize_per_sample(inp.act(B, h, h, cin))
        w8, sw = conv3x3.quantize_weight_per_channel(inp.w(3, 3, cin, cout))
    bias = inp.vec(cout)
    wk = rb.pack_int8_weight((w8, sw))[0]
    plan = rb.s8_tile_plan(B, h, h, cin, 0, cout)
    fused = lambda: conv3x3.conv3x3_pallas_int8(x8, w8, sw, sx, bias, w_kmajor=wk)  # noqa: E731
    plain = lambda: conv3x3.conv3x3_int8_reference(x8, w8, sw, sx, bias)  # noqa: E731
    rb.block_launches(reset=True)
    out = fused()
    torch.cuda.synchronize()
    gemms = rb.block_launches(kernels=("block_gemm_kernel<int8>",))["block_gemm_kernel<int8>"]
    ref = plain()
    top = conv3x3.conv3x3_int8_exact(x8, w8).abs().max().item() if large else None
    exact = out.dtype == torch.bfloat16 and torch.equal(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    ops = {"int8": 2 * B * h * h * 9 * cin * cout}
    ms, plain_ms = time_ms(fused), time_ms(plain, 5 if B == 4 else 1)
    dev = device_share(ops, graph_ms(fused))
    bare = graph_ms(lambda: rb.int8_conv_gemm(x8, wk))
    bd = bound(nbytes(x8, wk, sw, sx, bias, out), ops)
    print(f"kernel K11-int8 conv3x3_pallas_int8 [{label}]: bit-identical to its exact plain "
          f"version: {exact} (max|err| {err:.3e}; bound {KERNEL_BOUND['K11-int8']:.0e})"
          + (f", largest |sum| {top:.0f} (2^24 = {2 ** 24})" if large else "")
          + f"; {plan.splits} splits, {gemms} block_gemm_kernel<int8> launch; ms={ms:.4f} "
          f"device ms={dev['graph_ms']:.4f} ({dev['int8_peak_share']:.1%} of the int8 peak), "
          f"bare int8 GEMM device ms={bare:.4f}; plain_ms={plain_ms:.4f} bound_ms={bd[0]:.4f}",
          flush=True)
    _record(res, "K11-int8", label, err, err / ref.float().abs().max().item(), ms, plain_ms, bd,
            bare_graph_ms=bare, **dev)
    if not exact or err > KERNEL_BOUND["K11-int8"] or gemms != 1 or (large and top < 2 ** 24):
        raise AssertionError(f"K11-int8 {label}: max|err| {err:.3e}, {gemms} GEMM launches, "
                             f"largest sum {top}")


def check_k12(res, inp, B: int, h: int, c: int, dtype):
    """K12 at one site against its plain version (scales within
    K12_SCALE_BOUND, int8 values at most one step apart on at most
    K12_FLIP_SHARE of them), its route (one gn_apply_kernel launch where
    gn_apply_ctas says so, else the GN statistics and the int8 pre-pass),
    device time and share of its bytes bound."""
    from gddim_torch.ops import groupnorm, resblock as rb

    dt = "f32" if dtype == torch.float32 else "bf16"
    label = f"B={B} {h}x{h}x{c} {dt}"
    x = inp.act(B, h, h, c).to(dtype) if dtype == torch.bfloat16 else \
        torch.randn((B, h, h, c), generator=inp.g, device="cuda")
    gs, gb = inp.vec(c, 1.0), inp.vec(c)
    fused = lambda: groupnorm.group_norm_silu_quant(x, gs, gb, 32)  # noqa: E731
    plain = lambda: groupnorm.group_norm_silu_quant_reference(x, gs, gb, 32)  # noqa: E731
    rb.block_launches(reset=True)
    q, qs = fused()
    torch.cuda.synchronize()
    routes = rb.block_launches(kernels=("gn_apply_kernel", "gn_stats_kernel",
                                        "prepass_kernel<int8>"))
    ctas = rb.gn_apply_ctas(h, h, c, dtype == torch.float32)
    want = ({"gn_apply_kernel": 1, "gn_stats_kernel": 0, "prepass_kernel<int8>": 0} if ctas
            else {"gn_apply_kernel": 0, "gn_stats_kernel": 1, "prepass_kernel<int8>": 1})
    q_ref, qs_ref = plain()
    if q.dtype != torch.int8 or q.shape != x.shape or qs.shape != (B,):
        raise AssertionError(f"K12 {label}: got {q.dtype} {tuple(q.shape)}, {tuple(qs.shape)}")
    deq, deq_ref = (a.float() * b[:, None, None, None] for a, b in ((q, qs), (q_ref, qs_ref)))
    err = (deq - deq_ref).abs().max().item()
    rel = err / deq_ref.abs().max().item()
    scale_rel = ((qs - qs_ref).abs() / qs_ref).max().item()
    step = (q.int() - q_ref.int()).abs()
    steps, share = step.max().item(), (step > 0).float().mean().item()
    ms, plain_ms, dev_ms = time_ms(fused), time_ms(plain), graph_ms(fused)
    bd = bound(nbytes(x, gs, gb, q, qs), {"f32": 12 * x.numel()})
    print(f"kernel K12 group_norm_silu_quant [{label}]: dequantized max|err|={err:.3e} "
          f"rel={rel:.3e} (bound {KERNEL_BOUND['K12']:.0e}), scales rel={scale_rel:.3e} "
          f"(bound {K12_SCALE_BOUND:.0e}), int8 values one step apart: {share:.2e} (bound "
          f"{K12_FLIP_SHARE:.0e}), largest step {steps}; route {ctas} CTAs a sample, launches "
          f"{routes}; ms={ms:.4f} device ms={dev_ms:.4f} ({bd[0] / dev_ms:.1%} of its bound) "
          f"plain_ms={plain_ms:.4f} bound_ms={bd[0]:.4f}", flush=True)
    _record(res, "K12", label, err, rel, ms, plain_ms, bd, scale_rel=scale_rel,
            flip_share=share, graph_ms=dev_ms)
    if not (np.isfinite(rel) and rel <= KERNEL_BOUND["K12"] and scale_rel <= K12_SCALE_BOUND
            and steps <= 1 and share <= K12_FLIP_SHARE and routes == want):
        raise AssertionError(f"K12 {label}: rel {rel:.3e}, scales {scale_rel:.3e}, "
                             f"steps {steps}, share {share:.2e} over bounds; launches {routes}, "
                             f"expected {want}")


def print_layer_sums(*results: dict):
    """K11 int8 (beside the bare int8 GEMM) and K12 (by dtype) summed by
    batch: eager and device ms, bound, and the int8 peak's or the bound's
    share of the device time."""
    groups = {}
    for kernel in ("K11-int8", "K12"):
        for r in (r for res in results for r in res.get(kernel, {}).get("shapes", [])):
            words = r["shape"].split()
            if "sums>2^24" in words:
                continue
            key = " ".join([kernel, words[0]] + ([words[-1]] if kernel == "K12" else []))
            g = groups.setdefault(key, dict(n=0, ms=0.0, dev=0.0, bare=0.0, bound=0.0, ops=0))
            g["n"] += 1
            for k, v in (("ms", "ms"), ("dev", "graph_ms"), ("bound", "bound_ms")):
                g[k] += r[v]
            g["bare"] += r.get("bare_graph_ms", 0.0)
            g["ops"] += r.get("int8_ops", 0)
    for key, g in groups.items():
        share = (f"{g['ops'] / PEAK['int8'] * 1e3 / g['dev']:.1%} of the int8 peak; bare int8 "
                 f"GEMM device {g['bare']:.4f} ms" if key.startswith("K11")
                 else f"{g['bound'] / g['dev']:.1%} of its bound")
        print(f"sum {key}: {g['n']} shapes, eager {g['ms']:.4f} ms, device {g['dev']:.4f} ms, "
              f"bound {g['bound']:.4f} ms, {share}", flush=True)


def check_conv(results, x, w, label: str, B: int):
    """K11 bf16 on x (B, H, W, Cin) and w (3, 3, Cin, Cout) against its f32
    plain version, beside F.conv2d on the same NHWC bytes (cuDNN through a
    channels_last view) and its bound."""
    from gddim_torch.ops import conv3x3

    products = 2 * x.shape[0] * x.shape[1] * x.shape[2] * x.shape[3] * 9 * w.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    fused = lambda: conv3x3.conv3x3_pallas(x, w)  # noqa: E731
    library = lambda: F.conv2d(xc, wc, padding=1)  # noqa: E731
    dev_ms, library_dev_ms = graph_ms(fused), graph_ms(library)
    _check_kernel(results, "K11", label, fused, lambda: conv3x3.conv3x3_reference(x, w), (x, w),
                  {"bf16": products}, library_ms=time_ms(library), B=B, graph_ms=dev_ms,
                  library_graph_ms=library_dev_ms)
    print(f"  K11 [{label}] device time (CUDA graph): kernel {dev_ms:.4f} ms, F.conv2d "
          f"{library_dev_ms:.4f} ms ({verdict(dev_ms, library_dev_ms)}); "
          f"{products / PEAK['bf16'] * 1e3 / dev_ms:.1%} of the bf16 peak", flush=True)


def counters():
    from gddim_torch.ops import attention, attnblock, conv3x3, groupnorm, resblock, resblock_bwd

    return {"K1": groupnorm.group_norm_silu, "K2": resblock.fused_resblock,
            "K3": resblock.fused_resblock_pair, "K4": resblock.fused_resblock_tail,
            "K5": attnblock.fused_attnblock, "K6": resblock.fused_resblock_train,
            "K7": resblock_bwd.fused_resblock_train_grads, "K8": attention.flash_attention,
            "K2-int8": resblock.fused_resblock_int8, "K3-int8": resblock.fused_resblock_pair_int8,
            "K4-int8": resblock.fused_resblock_tail_int8,
            "K5-int8": attnblock.fused_attnblock_int8, "K11": conv3x3.conv3x3_pallas,
            "K11-int8": conv3x3.conv3x3_pallas_int8, "K12": groupnorm.group_norm_silu_quant,
            "K9": resblock.fused_resblock_transition,
            "K9-int8": resblock.fused_resblock_transition_int8,
            "K10": attnblock.fused_attnblock_train}


# kernels launched inside a C call (a block's convs), counted in C where each
# is launched: row -> kernel of ops/resblock.py:block_launches
DEVICE_COUNTED = {"S8-GEMM": "block_gemm_kernel<int8>", "S8-prepass": "prepass_kernel<int8>",
                  "BF16-GEMM": "block_gemm_kernel<bf16>", "BF16-prepass": "prepass_kernel<bf16>",
                  "K5-core": "attention_wgmma_kernel", "GN-stats": "gn_stats_kernel",
                  "GN-apply": "gn_apply_kernel", "train-GEMM": "block_gemm_kernel<bf16, train>",
                  "wgrad": "wgrad_kernel",
                  "GN-bwd": "gn_bwd_kernel", "GN2-prepass": "gn_prepass_kernel"}


def reset_counts():
    from gddim_torch.ops import resblock

    for fn in counters().values():
        fn.launches = 0
    resblock.block_launches(reset=True)


def read_counts():
    from gddim_torch.ops import resblock

    counts = {k: fn.launches for k, fn in counters().items()}
    device = resblock.block_launches()
    # a parent's checkout may count fewer kernels in C (phase train_time)
    return {**counts, **{k: device.get(name, 0) for k, name in DEVICE_COUNTED.items()}}


def eps_inputs(batch: int = 4):
    """The eps phases' (u, t): seeded u, t = 0.5."""
    g = torch.Generator(device="cuda").manual_seed(1)
    u = torch.randn((batch, 32, 32, 3, 2), generator=g, device="cuda")
    return u, torch.full((batch,), 0.5, device="cuda")


def launches_of(keys):
    """The counts of ``keys``; raises if a kernel outside them launched."""
    counts = read_counts()
    stray = {k: n for k, n in counts.items() if k not in keys and n}
    if stray:
        raise AssertionError(f"kernels of another path launched: {stray}")
    return {k: counts[k] for k in keys}


def phase_eps(config):
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model
    from gddim_torch.models.wrappers import make_cld_eps_fn

    model = seeded_model(config, seed=0, device="cuda")
    eps_apply = make_cld_eps_fn(CLD.from_config(config))
    u, t = eps_inputs()
    reset_counts()
    got = eps_apply(model, u, t)
    torch.cuda.synchronize()
    counts = launches_of(PER_EVAL)
    model.fused, model.dtype = False, torch.float32
    ref = eps_apply(model, u, t)
    model.fused, model.dtype = True, torch.bfloat16
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"eps B=4 t=0.5: kernel path (bf16) vs plain path (f32) rel={rel:.3e} "
          f"(bound {EPS_BOUND:.0e}); launches {counts}", flush=True)
    if not np.isfinite(rel) or rel > EPS_BOUND:
        raise AssertionError(f"eps rel err {rel:.3e} > {EPS_BOUND:.0e}")
    if counts != PER_EVAL:
        raise AssertionError(f"launch counts {counts} != {PER_EVAL}")
    check_temb_rows(model, card_line())
    # the layer-wise paths of the same network (conv_impl 'pallas' and 'int8')
    for impl, per_eval in (("pallas", PER_EVAL_PALLAS), ("int8", PER_EVAL_LAYER_INT8)):
        model.layer = impl
        reset_counts()
        got = eps_apply(model, u, t)
        torch.cuda.synchronize()
        counts = launches_of(per_eval)
        key = f"{impl}_vs_f32"
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        print(f"eps B=4 t=0.5: layer-wise '{impl}' path (bf16) vs plain path (f32) rel={rel:.3e} "
              f"(bound {EPS_LAYER_BOUND[key]:.0e}); launches {counts}", flush=True)
        if not np.isfinite(rel) or rel > EPS_LAYER_BOUND[key]:
            raise AssertionError(f"'{impl}' eps rel err {rel:.3e} > {EPS_LAYER_BOUND[key]:.0e}")
        if counts != per_eval:
            raise AssertionError(f"'{impl}' launch counts {counts} != {per_eval}")
    model.layer = None
    return model


def sample_round(config, model, folder, batch: int, seed: int) -> Path:
    """One round of ``batch`` samples through run_lib's sampling loop (as the
    CLI's sampling mode writes them), written anew; its samples_0.npz."""
    from gddim_torch import run_lib

    (path,) = run_lib.sampling_from_fn(config, run_lib.build_sampling_fn(config), model,
                                       folder, batch, batch, seed=seed, is_continue=False)
    return path


def _run_samples(config, model, batch: int, per_eval: dict):
    """One warm run (seed 7), then the counted NFE run from seed 8 through the
    CLI's sampling function: (samples, v, wall seconds, launch counts)."""
    nfe = int(config.sampling.nfe)
    with tempfile.TemporaryDirectory() as tmp:
        sample_round(config, model, tmp, batch, seed=7)  # warm
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = sample_round(config, model, tmp, batch, seed=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_of(per_eval)
        with np.load(path) as f:
            samples, v, nfe_rec = f["samples"], f.get("v"), int(f["nfe"])
    if samples.shape != (batch, 32, 32, 3) or nfe_rec != nfe or (v is not None
                                                                 and not np.isfinite(v).all()):
        raise AssertionError(f"bad samples {samples.shape} nfe={nfe_rec}")
    expected = {k: n * nfe for k, n in per_eval.items()}
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != {expected}")
    return samples, wall, counts


def _compare_samples(ref, samples, bounds: dict, what: str):
    """Pixel correlation, mean and max |dx| of uint8 samples against ref's:
    (their line, whether they are within ``bounds``)."""
    a, b = ref.astype(np.float64) / 255.0, samples.astype(np.float64) / 255.0
    corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    mean_dx, max_dx = float(np.abs(a - b).mean()), float(np.abs(a - b).max())
    ok = (corr >= bounds["corr"] and mean_dx <= bounds["mean_dx"]
          and max_dx <= bounds.get("max_dx", 1.0))
    return (f"against {what}: pixel corr {corr:.5f} (bound >= {bounds['corr']}), mean|dx| "
            f"{mean_dx:.5f} (bound {bounds['mean_dx']}), max|dx| {max_dx:.4f}, mean "
            f"{b.mean():.4f} (theirs {a.mean():.4f})"), ok


def _sample_line(label, config, batch, wall, card, counts, cmp=None):
    """Print one NFE run's line; raise when its comparison ``cmp`` (from
    _compare_samples) is out of bounds."""
    text, ok = cmp or ("", True)
    print(f"sample {label} NFE={config.sampling.nfe} B={batch}: wall {wall:.3f} s, "
          f"{batch / wall:.2f} img/s [{card}] (information only); launches {counts}"
          + (f"; {text}" if text else ""), flush=True)
    if not ok:
        raise AssertionError(f"sample {label}: {text} over bounds")


def run_k9(config, model, batch: int, card: str, per_eval: dict, ref, label: str):
    """The same NFE=50 run with model.transition_impl 'full' (K9) against the
    K4 path's samples ``ref`` of the same seed; returns the launch counts."""
    model.transition = "full"
    try:
        samples, wall, counts = _run_samples(config, model, batch, per_eval)
    finally:
        model.transition = "tail"
    _sample_line(f"{label} transition_impl=full", config, batch, wall, card, counts,
                 _compare_samples(ref, samples, SAMPLE_K9_BOUND,
                                  "the K4 path's samples of the same seed"))
    return counts


def phase_sample(config, model, batch: int, card: str):
    samples, wall, counts = _run_samples(config, model, batch, PER_EVAL)
    _sample_line("deis-2", config, batch, wall, card, counts)
    k9 = run_k9(config, model, batch, card, PER_EVAL_FULL, samples, "deis-2")
    counts.update({k: n for k, n in k9.items() if k not in counts})
    return counts, samples


def phase_int8(config, samples_bf16, batch: int, card: str):
    """The int8 path as a user runs it (conv_impl fused_int8, scales calibrated
    on the card), against the bf16 kernel path and the f32 plain path."""
    from gddim_torch.cli import build_model, calibrate_int8
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.wrappers import make_cld_eps_fn

    config = copy.deepcopy(config)
    config.model.conv_impl = "fused_int8"
    model = build_model(config, "cuda", None, seed=0)
    seconds = calibrate_int8(config, model, seed=0)
    sites = sum(len(v) for v in model.qscales.values())
    print(f"int8 calibration: {len(model.qscales)} blocks, {sites} sites, batch 8, order-0 NFE 12 "
          f"on the card in {seconds:.3f} s", flush=True)

    eps_apply = make_cld_eps_fn(CLD.from_config(config))
    u, t = eps_inputs()
    reset_counts()
    got = eps_apply(model, u, t)
    torch.cuda.synchronize()
    counts = launches_of(PER_EVAL_INT8)
    qscales, model.qscales = model.qscales, {}
    dynamic = eps_apply(model, u, t)
    model.qscales, model.int8 = qscales, False
    bf16 = eps_apply(model, u, t)
    model.fused, model.dtype = False, torch.float32
    f32 = eps_apply(model, u, t)
    model.fused, model.int8, model.dtype = True, True, torch.bfloat16
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
    errs = dict(static_vs_bf16=rel(got, bf16), static_vs_f32=rel(got, f32),
                dynamic_vs_f32=rel(dynamic, f32), bf16_vs_f32=rel(bf16, f32))
    print("eps B=4 t=0.5 int8 path: " + ", ".join(
        f"{k} {v:.3e}" + (f" (bound {EPS_INT8_BOUND[k]:.2g})" if k in EPS_INT8_BOUND else "")
        for k, v in errs.items()) + f"; launches {counts}", flush=True)
    bad = {k: v for k, v in errs.items() if k in EPS_INT8_BOUND
           and not (np.isfinite(v) and v <= EPS_INT8_BOUND[k])}
    if bad:
        raise AssertionError(f"int8 eps over bounds: {bad}")
    if counts != PER_EVAL_INT8:
        raise AssertionError(f"int8 launch counts {counts} != {PER_EVAL_INT8}")

    samples, wall, counts = _run_samples(config, model, batch, PER_EVAL_INT8)
    _sample_line("int8 static deis-2", config, batch, wall, card, counts,
                 _compare_samples(samples_bf16, samples, SAMPLE_INT8_BOUND,
                                  "the bf16 samples of the same seed"))
    k9 = run_k9(config, model, batch, card, PER_EVAL_INT8_FULL, samples, "int8 static deis-2")
    counts.update({k: n for k, n in k9.items() if k not in counts})
    return counts


# blur NFE=50 runs of the blur phase, in order: (conv_impl, launches per eval,
# transition_impl); the last one, K9's int8 mode, is held against the
# 'fused_int8' (K4) samples, every other against the 'fused' ones
BLUR_PATHS = [("fused", PER_EVAL, "tail"), ("int8", PER_EVAL_LAYER_INT8, "tail"),
              ("fused_int8", PER_EVAL_INT8, "tail"), ("pallas", PER_EVAL_PALLAS, "tail"),
              ("fused_int8", PER_EVAL_INT8_FULL, "full")]


def phase_blur(batch: int, card: str):
    """blur/ddpm_deep_cifar10 order-0 NFE=50 sampling through the CLI's
    sampling function, one path after another from the same seed; each path
    warmed by an NFE=2 run first. Returns each kernel's launches from the
    first path that runs it."""
    from gddim_torch.cli import build_model, calibrate_int8
    from gddim_torch.configs import get_config

    launches, runs = {}, {}
    for impl, per_eval, transition in BLUR_PATHS:
        config = get_config("blur/ddpm_deep_cifar10")
        config.model.conv_impl = impl
        config.model.transition_impl = transition
        nfe = int(config.sampling.nfe)
        model = build_model(config, "cuda", None, seed=0)
        note = ""
        if impl == "fused_int8":
            seconds = calibrate_int8(config, model, seed=0)
            note = f"; calibrated {len(model.qscales)} blocks on the card in {seconds:.3f} s"
        warm = copy.deepcopy(config)
        warm.sampling.nfe = 2
        finite = []  # every network output of the run is finite
        hook = model.register_forward_hook(lambda m, i, out: finite.append(torch.isfinite(out).all()))
        with tempfile.TemporaryDirectory() as tmp:
            sample_round(warm, model, tmp, batch, seed=7)
            finite.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = sample_round(config, model, tmp, batch, seed=8)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launches_of(per_eval)
            with np.load(path) as f:
                samples, nfe_rec = f["samples"], int(f["nfe"])
        hook.remove()
        all_finite = len(finite) == nfe and bool(torch.stack(finite).all())
        line = (f"sample blur order-0 NFE={nfe_rec} B={batch} conv_impl={impl} "
                f"transition_impl={transition}: wall {wall:.3f} s, {batch / wall:.2f} img/s "
                f"[{card}] (information only){note}; launches {counts}; every eval finite: "
                f"{all_finite}")
        bad = []
        # K9's run against the K4 path's samples, every other against 'fused'
        ref = "fused_int8" if transition == "full" else "fused"
        if ref in runs:
            text, ok = _compare_samples(runs[ref], samples, SAMPLE_K9_BOUND if transition ==
                                        "full" else SAMPLE_INT8_BOUND,
                                        f"the '{ref}' samples of the same seed")
            line += "; " + text
            if not ok:
                bad.append(f"{text} over bounds")
        print(line, flush=True)
        expected = {k: n * nfe for k, n in per_eval.items()}
        if samples.shape != (batch, 32, 32, 3) or nfe_rec != nfe or not all_finite:
            bad.append(f"bad samples {samples.shape} nfe={nfe_rec} finite={all_finite}")
        if counts != expected:
            bad.append(f"launch counts {counts} != {expected}")
        if bad:
            raise AssertionError(f"blur {impl}: " + "; ".join(bad))
        launches.update({k: n for k, n in counts.items() if k not in launches})
        runs.setdefault(impl, samples)
        del model
    return launches


def busy_ms(prof) -> float:
    """Device busy time of a torch.profiler trace: the union of its kernels'
    intervals. A programmatic dependent launch (GN2's pre-pass after conv1,
    conv2 after the pre-pass) starts before the kernel before it ends and
    waits, so the kernels' own times, summed, count that overlap twice."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _profile(name: str, run, batch: int, card: str, evals: int):
    """Wall of ``run()`` (host clock to a synchronize, mean of ``evals``), and
    one traced run under torch.profiler: host enqueue, device time, idle
    share and the kernels that take the time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(evals):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / evals * 1e3
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(ms for _, ms, _ in dev)
    top = sorted(dev, key=lambda r: -r[1])[:12]
    busy = busy_ms(prof)
    print(f"profile {name} eval B={batch} [{card}]: wall {wall:.3f} ms (mean of {evals}); "
          f"traced eval: wall {traced:.3f} ms, host enqueue {enqueue:.3f} ms, device "
          f"{total:.3f} ms in {sum(n for *_, n in dev)} kernels (busy {busy:.3f} ms, their "
          f"union), idle share {1 - busy / traced:.3f}; launches "
          f"{({k: n for k, n in read_counts().items() if n})}", flush=True)
    for key, ms, n in top:
        print(f"  {ms:8.3f} ms {n:5d}x {key[:110]}", flush=True)
    for name in ("gn_apply_kernel", "gn_stats_kernel", "prepass_kernel", "gn_prepass_kernel",
                 "transition_resample_kernel"):
        # prepass_kernel: the int8 and bf16 pre-pass, not GN2's folding one
        hit = [(m, n) for key, m, n in dev if name in key and not (
            name == "prepass_kernel" and "gn_prepass_kernel" in key)]
        print(f"  {name}: {sum(m for m, _ in hit):.3f} ms in {sum(n for _, n in hit)} launches",
              flush=True)
    # replaced: the per-block GN affine and temb kernels of earlier versions,
    # and on the sampling path GN1's two launches (gn_stats_kernel,
    # transition_resample_kernel)
    gone = [key for key, *_ in dev if any(k in key for k in (
        "gn_affine_kernel", "temb_proj_kernel", "gn_stats_kernel", "transition_resample_kernel"))]
    if gone:
        raise AssertionError(f"replaced kernels in the trace: {gone}")


def phase_profile(config, batch: int, card: str, evals: int = 5):
    """Where one eval's time goes: the CLD bf16 and int8 static kernel paths,
    then the blur 'fused_int8' and layer-wise 'int8' and 'pallas' paths, each
    pair in the order a, b, b, a."""
    from gddim_torch.cli import build_model, calibrate_int8
    from gddim_torch.configs import get_config
    from gddim_torch.math.blur import BlurSDE
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.wrappers import make_blur_yeps_fn, make_cld_eps_fn

    config = copy.deepcopy(config)
    config.model.conv_impl = "fused_int8"
    model = build_model(config, "cuda", None, seed=0)
    calibrate_int8(config, model, seed=0)
    eps_apply = make_cld_eps_fn(CLD.from_config(config))
    u, t = eps_inputs(batch)
    for name, int8 in (("bf16", False), ("int8", True), ("int8", True), ("bf16", False)):
        model.int8 = int8
        _profile(name, lambda: eps_apply(model, u, t), batch, card, evals)
    for int8 in (False, True):  # the transitions through K4 and through K9
        model.int8 = int8
        for transition in ("tail", "full", "full", "tail"):
            model.transition = transition
            _profile(f"{'int8' if int8 else 'bf16'} transition_impl={transition}",
                     lambda: eps_apply(model, u, t), batch, card, evals)
    del model

    config = get_config("blur/ddpm_deep_cifar10")
    config.model.conv_impl = "fused_int8"
    model = build_model(config, "cuda", None, seed=0)
    calibrate_int8(config, model, seed=0)
    yeps = make_blur_yeps_fn(BlurSDE.from_config(config))
    y = u[..., 0]
    for layer in (None, "int8", "pallas", "pallas", "int8", None):
        model.layer = layer
        _profile(f"blur {'layer-wise ' + layer if layer else 'fused_int8'}",
                 lambda: yeps(model, y, t), batch, card, evals)


def phase_ab(config, card: str, batches=(16, 64), rounds: int = 5):
    """K9's A/B: CLD deis-2 NFE=50 img/s through run_lib's sampling loop
    with transition_impl 'tail' and 'full', bf16 ('fused') and int8 static
    ('fused_int8'), at each batch, ``rounds`` times in the order tail, full,
    full, tail (two pairs a round), each setting warmed first by an NFE=2
    run; then per cell the medians, the pairs 'full' won and the spread of
    the 'tail' runs (the distance between their quartiles)."""
    from gddim_torch.cli import build_model, calibrate_int8

    for impl in ("fused", "fused_int8"):
        cfg = copy.deepcopy(config)
        cfg.model.conv_impl = impl
        warm = copy.deepcopy(cfg)
        warm.sampling.nfe = 2
        model = build_model(cfg, "cuda", None, seed=0)
        if impl == "fused_int8":
            calibrate_int8(cfg, model, seed=0)
        for batch in batches:
            rates = {"tail": [], "full": []}
            with tempfile.TemporaryDirectory() as tmp:
                for transition in ("tail", "full"):
                    model.transition = transition
                    sample_round(warm, model, tmp, batch, seed=7)
                for _ in range(rounds):
                    for transition in ("tail", "full", "full", "tail"):
                        model.transition = transition
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        sample_round(cfg, model, tmp, batch, seed=8)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                        rates[transition].append(batch / wall)
                        print(f"ab CLD {impl} deis-2 NFE={cfg.sampling.nfe} B={batch} "
                              f"transition_impl={transition}: {batch / wall:.2f} img/s, wall "
                              f"{wall:.3f} s [{card}]", flush=True)
            tail, full = (np.array(rates[k]) for k in ("tail", "full"))
            q1, q3 = np.percentile(tail, [25, 75])
            print(f"ab CLD {impl} B={batch}: median img/s tail {np.median(tail):.2f}, full "
                  f"{np.median(full):.2f}; full won {int((full > tail).sum())} of {len(tail)} "
                  f"pairs; tail quartile spread {q3 - q1:.2f} [{card}]", flush=True)
        del model


def _loss_and_grads(model, loss_fn, images, t, z, seed):
    """One loss + backward; the dropout masks come from a generator seeded
    with ``seed``, so two paths draw the same masks."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for p in model.parameters():
        p.grad = None
    loss = loss_fn(model, images, gen, t=t, z=z)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads


def _timed_steps(state, train_step, batches):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info = train_step(state, batches)
    loss = float(info["loss"])
    torch.cuda.synchronize()
    return loss, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _check_train_step(loss_k, grads_k, loss_p, grads_p, label: str) -> None:
    """One loss + backward of a kernel path against the all-plain path on the
    same t, z and masks: loss, gradient norm, each tensor on its own scale."""
    norm = lambda gs: torch.linalg.vector_norm(torch.stack([v.norm() for v in gs.values()]))  # noqa: E731
    norm_k, norm_p = norm(grads_k).item(), norm(grads_p).item()
    top = {n: v.abs().max().item() for n, v in grads_p.items()}
    largest = max(top.values())
    keys = [n for n in grads_p if n.endswith(".k.bias")]
    key_err = max((grads_k[n] - grads_p[n]).abs().max().item() for n in keys) / (LEAF_FLOOR * largest)
    rels, l2 = {}, {}
    for n in grads_p:
        if n not in keys:
            d = grads_k[n] - grads_p[n]
            rels[n] = d.abs().max().item() / top[n]
            l2[n] = (d.norm() / grads_p[n].norm()).item()
    errs = dict(loss=abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
                grad_norm=abs(norm_k - norm_p) / norm_p, key_bias=key_err)
    print(f"train {label}: loss kernel {loss_k.item():.6f} plain {loss_p.item():.6f} "
          f"rel={errs['loss']:.3e} (bound {TRAIN_BOUND['loss']:.0e}); grad norm kernel "
          f"{norm_k:.5f} plain {norm_p:.5f} rel={errs['grad_norm']:.3e} "
          f"(bound {TRAIN_BOUND['grad_norm']:.0e}); {len(grads_p)} gradient tensors", flush=True)
    print(f"  attention key biases (exact gradient zero): {len(keys)}, plain share of the "
          f"largest gradient up to {max(top[n] for n in keys) / largest:.2e}, error against "
          f"{LEAF_FLOOR:.0e} of it {key_err:.3e} (bound {TRAIN_BOUND['key_bias']:.0e})", flush=True)
    for tier, pick in (("", lambda n: top[n] >= DEEP_SHARE * largest),
                       ("deep_", lambda n: top[n] < DEEP_SHARE * largest)):
        band = [n for n in rels if pick(n)]
        if not band:  # a narrow model may have no deep tensors
            errs[f"worst_{tier}tensor"] = errs[f"worst_{tier}tensor_l2"] = 0.0
            continue
        w, w2 = max(band, key=rels.get), max(band, key=l2.get)
        errs[f"worst_{tier}tensor"], errs[f"worst_{tier}tensor_l2"] = rels[w], l2[w2]
        print(f"  {len(band)} tensors with a largest gradient {'at least' if not tier else 'under'} "
              f"{DEEP_SHARE:.0e} of the largest (down to {min(top[n] for n in band) / largest:.1e}): "
              f"worst {w} rel={rels[w]:.3e} (bound {TRAIN_BOUND[f'worst_{tier}tensor']:.2g}), "
              f"worst L2 {w2} {l2[w2]:.3e} (bound {TRAIN_BOUND[f'worst_{tier}tensor_l2']:.2g})",
              flush=True)
    bad = {k: v for k, v in errs.items() if not np.isfinite(v) or v > TRAIN_BOUND[k]}
    if bad:
        raise AssertionError(f"train step ({label}): kernel path vs plain path over bounds: {bad}")


def _train_main_path(config, model, n_steps: int, batch: int, per_step: dict, label: str):
    """n_steps Adam steps of ``model`` through run_lib.train (the CLI's train
    mode) on the synthetic corpus, counted from 0."""
    from gddim_torch import run_lib

    config = copy.deepcopy(config)
    config.seed, config.training.n_iters, config.training.batch_size = 3, n_steps, batch
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run_lib.train(config, tmp, "cuda", model=model)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_of(per_step)
    finite = all(torch.isfinite(p).all().item() for p in model.parameters())
    print(f"train {n_steps} Adam steps B={batch} through gddim_torch.run_lib.train ({label}): "
          f"{wall:.3f} s with data and the meta checkpoint's write; launches {counts}; "
          f"params finite: "
          f"{finite}", flush=True)
    expected = {k: n * n_steps for k, n in per_step.items()}
    if counts != expected:
        raise AssertionError(f"train launch counts ({label}) {counts} != {expected}")
    if not finite or state.step != n_steps:
        raise AssertionError(f"train ({label}): non-finite parameters or missing steps")
    return state, counts


def phase_train(card: str):
    from gddim_torch.configs import train_config
    from gddim_torch.math.cld import CLD
    from gddim_torch.models.init import seeded_model
    from gddim_torch.train.losses import make_cld_loss_fn
    from gddim_torch.train.step import make_train_step

    config = train_config("cld/accr_dcifar10")
    n_steps, batch = int(config.training.n_jitted_steps), int(config.training.batch_size)
    model = seeded_model(config, seed=0, device="cuda").train()
    sde = CLD.from_config(config)
    loss_fn = make_cld_loss_fn(sde, train=True)
    batches = next(synthetic_stream(config))
    g = torch.Generator(device="cuda").manual_seed(5)
    t = 1e-5 + (sde.T - 1e-5) * torch.rand((batch,), generator=g, device="cuda")
    z = torch.randn((batch, 32, 32, 3, 2), generator=g, device="cuda")

    # one loss + backward, the kernel path (K10 off, then on) vs the all-plain
    # path, same t, z and masks
    model.fused = False
    loss_p, grads_p = _loss_and_grads(model, loss_fn, batches[0], t, z, seed=9)
    model.fused = True
    for fused_attn in (False, True):
        model.fused_attn = fused_attn
        loss_k, grads_k = _loss_and_grads(model, loss_fn, batches[0], t, z, seed=9)
        _check_train_step(loss_k, grads_k, loss_p, grads_p,
                          f"B={batch} training.fused_attn={fused_attn}")
        del grads_k
    del grads_p

    # the main path: n_jitted_steps Adam steps through the CLI's train function,
    # with the config's setting, then with training.fused_attn on
    model.fused_attn = bool(config.training.fused_attn)
    state, counts = _train_main_path(config, model, n_steps, batch,
                                     PER_STEP_K10 if model.fused_attn else PER_STEP,
                                     f"training.fused_attn={model.fused_attn}")
    k10 = copy.deepcopy(config)
    k10.training.fused_attn = not model.fused_attn
    model.fused_attn = k10.training.fused_attn
    # only the counts: a second optimizer state left alive would add its
    # Adam moments and EMA copy to the peaks measured below
    other = _train_main_path(k10, model, n_steps, batch,
                             PER_STEP_K10 if model.fused_attn else PER_STEP,
                             f"training.fused_attn={model.fused_attn}")[1]
    counts.update({k: n for k, n in other.items() if k not in counts})

    # where one step's time goes (K10 off)
    train_step = make_train_step(loss_fn)
    model.fused, model.fused_attn = True, False
    profile_train_step(card, train_step, state, batches[:1], "kernel path, K10 off")
    # throughput and peak memory: the kernel path with K10 off and on, and the
    # plain path, for information
    runs = [("kernel", True, False), ("kernel, K10", True, True), ("plain", False, False),
            ("plain", False, False), ("kernel, K10", True, True), ("kernel", True, False)]
    for name, fused, fused_attn in runs:
        model.fused, model.fused_attn = fused, fused_attn
        loss, sec, peak = _timed_steps(state, train_step, batches)
        if not np.isfinite(loss):
            raise AssertionError(f"train: non-finite loss {loss} ({name})")
        print(f"train {name} path: {n_steps} steps B={batch} {sec:.3f} s, "
              f"{n_steps * batch / sec:.2f} img/s, loss {loss:.5f}, peak {peak:.2f} GiB [{card}] "
              f"(information only)", flush=True)
    model.fused, model.fused_attn = True, bool(config.training.fused_attn)
    return counts


# The samplers phase: each CLD sampler beside deis (the sample phase's) at
# NFE=50 through build_sampling_fn, bf16 ('fused') and int8 ('fused_int8',
# static scales), the transitions through K9 (the config's 'full'); (label,
# sampling overrides)
SAMPLER_RUNS = [("order0", dict(method="order0")),
                ("order0 is_em", dict(method="order0", is_em=True)),
                ("hybdeis-2", dict(method="hybdeis")), ("mldeis-2", dict(method="mldeis")),
                ("ldeis-2", dict(method="ldeis")),
                ("sdeis-2 lambda=1", dict(method="sdeis", lambda_coef=1.0)),
                ("em lambda=1", dict(method="em", lambda_coef=1.0)), ("sscs", dict(method="sscs"))]
# Each kernel-path run (and blur deis's) against the f32 plain path's
# samples from the same u0 and the same normals (one generator seed on the
# card); measured on an H100: bf16 corr >= 0.99784, mean|dx| <= 0.00108
# (the worst of the CLD methods, ode and blur deis), so bf16 is held at
# about 3x (1 - corr <= 0.006, mean|dx| <= 0.003); int8 static >= 0.98144,
# <= 0.00928, held at the int8 and blur sample gates (SAMPLE_INT8_BOUND)
SAMPLER_BF16_BOUND = {"corr": 0.994, "mean_dx": 0.003, "max_dx": 1.0}
# the ode sampler's batch; solve_ivp at the config's rtol and atol (1e-5):
# nfe 333 in 6.6-8.1 s bf16 on an H100
ODE_BATCH = 4
# blur training with model.fused_train off: the stride-1 and pair blocks'
# unfused layers, K1 for their GN1 and GN2 beside K1 in the transitions,
# attention and norm_out; K8 in attention
PER_STEP_UNFUSED_BLOCKS = {"K1": PER_STEP["K1"] + 2 * TRAIN_BLOCKS, "K8": PER_STEP["K8"]}


def _uint8(x):
    return np.clip(x.float().cpu().numpy() * 255.0, 0, 255).astype(np.uint8)


def _sample_run(config, model, batch: int, seed: int, per_eval: dict):
    """One run of gddim_torch.cli.build_sampling_fn(config) from a generator
    seeded ``seed`` on the card (so two runs of one seed draw the same u0
    and normals): (uint8 samples, wall seconds, nfe, launch counts). Raises
    unless every network output and the samples are finite and the launches
    are nfe x per_eval ({} for the plain path: no kernel)."""
    from gddim_torch.cli import build_sampling_fn

    sample_fn = build_sampling_fn(config)
    finite = []
    hook = model.register_forward_hook(lambda m, i, out: finite.append(torch.isfinite(out).all()))
    try:
        generator = torch.Generator(device="cuda").manual_seed(seed)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, v, nfe = sample_fn(generator, model, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        hook.remove()
    counts = launches_of(per_eval)
    ok = (len(finite) == nfe and bool(torch.stack(finite).all()) and bool(torch.isfinite(x).all())
          and (v is None or bool(torch.isfinite(v).all())))
    if x.shape != (batch, 32, 32, 3) or not ok:
        raise AssertionError(f"{config.sampling.method}: bad samples {tuple(x.shape)}, "
                             f"{len(finite)} evals for nfe={nfe}, all finite: {ok}")
    expected = {k: n * nfe for k, n in per_eval.items()}
    if counts != expected:
        raise AssertionError(f"{config.sampling.method}: launch counts {counts} != {expected}")
    return _uint8(x), wall, nfe, counts


def _plain(model):
    """Switch the model to the all-plain f32 path; returns the undo."""
    fused, dtype = model.fused, model.dtype
    model.fused, model.dtype = False, torch.float32

    def undo():
        model.fused, model.dtype = fused, dtype

    return undo


def _kernel_models(config, batch: int):
    """The config's seeded model (bf16 'fused') and its 'fused_int8' twin with
    static scales calibrated on the card, each warmed by an NFE=2 run."""
    from gddim_torch.cli import build_model, calibrate_int8

    config8 = copy.deepcopy(config)
    config8.model.conv_impl = "fused_int8"
    model, model8 = (build_model(c, "cuda", None, seed=0) for c in (config, config8))
    seconds = calibrate_int8(config8, model8, seed=0)
    for c, m in ((config, model), (config8, model8)):
        warm = copy.deepcopy(c)
        warm.sampling.nfe = 2
        _sample_run(warm, m, batch, 7, PER_EVAL_FULL if m is model else PER_EVAL_INT8_FULL)
    return config8, model, model8, seconds


def _sampler_line(label, tag, nfe, batch, wall, card, counts, cmp):
    text, ok = cmp
    print(f"{label} {tag} NFE={nfe} B={batch}: wall {wall:.3f} s, {batch / wall:.2f} img/s "
          f"[{card}] (information only); launches {counts}; {text}", flush=True)
    if not ok:
        raise AssertionError(f"{label} {tag}: {text} over bounds")


def phase_samplers(card: str, batch: int):
    """The CLD samplers beside deis on cld/accr_dcifar10 (seeded weights):
    SAMPLER_RUNS at NFE=50 and ``batch``, then ode at ODE_BATCH; each on the
    f32 plain path, then bf16 and int8 static (ode: bf16) through the
    kernels from the same seed, held against the plain samples. Returns each
    kernel's launches from the first run that launches it."""
    from gddim_torch.configs import get_config

    config = get_config("cld/accr_dcifar10")
    config8, model, model8, seconds = _kernel_models(config, batch)
    print(f"samplers: int8 static scales calibrated on the card in {seconds:.3f} s", flush=True)
    launches = {}
    what = "the f32 plain path's samples from the same u0 and normals"
    for label, over in SAMPLER_RUNS:
        cfgs = [copy.deepcopy(c) for c in (config, config8)]
        for c in cfgs:
            for k, v in over.items():
                setattr(c.sampling, k, v)
        undo = _plain(model)
        ref, wall, nfe, _ = _sample_run(cfgs[0], model, batch, 8, {})
        undo()
        print(f"sampler {label} f32 plain NFE={nfe} B={batch}: wall {wall:.3f} s, "
              f"{batch / wall:.2f} img/s [{card}] (information only)", flush=True)
        for tag, c, m, per_eval, bound in (
                ("bf16", cfgs[0], model, PER_EVAL_FULL, SAMPLER_BF16_BOUND),
                ("int8 static", cfgs[1], model8, PER_EVAL_INT8_FULL, SAMPLE_INT8_BOUND)):
            samples, wall, nfe, counts = _sample_run(c, m, batch, 8, per_eval)
            _sampler_line(f"sampler {label}", tag, nfe, batch, wall, card, counts,
                          _compare_samples(ref, samples, bound, what))
            launches.update({k: n for k, n in counts.items() if k not in launches})
    ode = copy.deepcopy(config)
    ode.sampling.method = "ode"
    tol = f"rtol {ode.sampling.rtol:g} atol {ode.sampling.atol:g} {ode.sampling.ode_method}"
    undo = _plain(model)
    ref, wall, nfe, _ = _sample_run(ode, model, ODE_BATCH, 8, {})
    undo()
    print(f"sampler ode ({tol}) f32 plain: nfe {nfe}, {wall:.3f} s [{card}]", flush=True)
    samples, wall, nfe, counts = _sample_run(ode, model, ODE_BATCH, 8, PER_EVAL_FULL)
    _sampler_line(f"sampler ode ({tol})", "bf16", nfe, ODE_BATCH, wall, card, counts,
                  _compare_samples(ref, samples, SAMPLER_BF16_BOUND, what))
    return launches


def phase_blur_deis(card: str, batch: int):
    """blur/ddpm_deep_cifar10 frequency-space deis (order 2, NFE=50, B=batch)
    through build_sampling_fn: the f32 plain path, then 'fused' and
    'fused_int8' (static scales calibrated on the card; the transitions
    'full') from the same seed; every eval finite, nfe x the per-eval
    launches, 'fused' against the plain samples (SAMPLER_BF16_BOUND) and
    'fused_int8' against 'fused' and the plain samples (SAMPLE_INT8_BOUND,
    as the blur phase holds its int8 runs)."""
    from gddim_torch.configs import get_config

    config = get_config("blur/ddpm_deep_cifar10")
    config.sampling.method = "deis"
    config8, model, model8, seconds = _kernel_models(config, batch)
    undo = _plain(model)
    ref, wall, nfe, _ = _sample_run(config, model, batch, 8, {})
    undo()
    order = config.sampling.deis_order
    print(f"blur deis-{order} f32 plain NFE={nfe} B={batch}: wall {wall:.3f} s, "
          f"{batch / wall:.2f} img/s [{card}] (information only)", flush=True)
    launches, runs = {}, {}
    for tag, c, m, per_eval in (("fused", config, model, PER_EVAL_FULL),
                                ("fused_int8", config8, model8, PER_EVAL_INT8_FULL)):
        samples, wall, nfe, counts = _sample_run(c, m, batch, 8, per_eval)
        note = f"calibrated on the card in {seconds:.3f} s; " if tag == "fused_int8" else ""
        bound = SAMPLE_INT8_BOUND if tag == "fused_int8" else SAMPLER_BF16_BOUND
        cmp = [_compare_samples(ref, samples, bound, "the f32 plain path's samples")]
        if "fused" in runs:
            cmp.append(_compare_samples(runs["fused"], samples, SAMPLE_INT8_BOUND,
                                        "the 'fused' samples of the same seed"))
        _sampler_line(f"blur deis-{order}", f"conv_impl={tag} transition_impl=full", nfe, batch,
                      wall, card, counts, ("; ".join(t for t, _ in cmp),
                                           all(ok for _, ok in cmp)))
        if note:
            print(f"blur deis-{order} fused_int8: {note.rstrip('; ')}", flush=True)
        runs[tag] = samples
        launches.update({k: n for k, n in counts.items() if k not in launches})
    return launches


def phase_blur_train(card: str):
    """blur/ddpm_deep_cifar10 training in f32 at the config's batch (128),
    dropout 0.1, seeded weights: one loss + backward with model.fused_train
    on (K6/K7) and off (the stride-1 blocks' unfused layers, K1 for their
    GroupNorms), each
    against the all-plain path on the same t, z and dropout masks; then
    training.n_jitted_steps Adam steps through gddim_torch.run_lib's train
    loop with each setting (launch counts per step, finite parameters),
    and img/s and peak memory of both, in turns on, off, off, on."""
    from gddim_torch.configs import train_config
    from gddim_torch.math.blur import BlurSDE
    from gddim_torch.models.init import seeded_model
    from gddim_torch.train.losses import make_blur_loss_fn
    from gddim_torch.train.step import make_train_step

    config = train_config("blur/ddpm_deep_cifar10")
    n_steps, batch = int(config.training.n_jitted_steps), int(config.training.batch_size)
    model = seeded_model(config, seed=0, device="cuda").train()
    sde = BlurSDE.from_config(config)
    loss_fn = make_blur_loss_fn(sde, train=True)
    batches = next(synthetic_stream(config))
    g = torch.Generator(device="cuda").manual_seed(5)
    t = sde.sample_t((batch,), g, "cuda")
    z = torch.randn((batch, 32, 32, 3), generator=g, device="cuda")

    model.fused = False
    loss_p, grads_p = _loss_and_grads(model, loss_fn, batches[0], t, z, seed=9)
    model.fused = True
    for fused_train in (True, False):
        model.fused_train = fused_train
        loss_k, grads_k = _loss_and_grads(model, loss_fn, batches[0], t, z, seed=9)
        _check_train_step(loss_k, grads_k, loss_p, grads_p,
                          f"blur B={batch} model.fused_train={fused_train}")
        del grads_k
    del grads_p

    counts, state = {}, None
    for fused_train, per_step in ((True, PER_STEP), (False, PER_STEP_UNFUSED_BLOCKS)):
        cfg = copy.deepcopy(config)
        cfg.model.fused_train = model.fused_train = fused_train
        run_state, run_counts = _train_main_path(cfg, model, n_steps, batch, per_step,
                                                 f"blur model.fused_train={fused_train}")
        state = state or run_state  # the first one's optimizer state only
        del run_state
        counts.update({k: n for k, n in run_counts.items() if k not in counts})
    train_step = make_train_step(loss_fn)
    for fused_train in (True, False, False, True):
        model.fused_train = fused_train
        loss, sec, peak = _timed_steps(state, train_step, batches)
        if not np.isfinite(loss):
            raise AssertionError(f"blur train: non-finite loss {loss} (fused_train={fused_train})")
        print(f"train blur model.fused_train={fused_train}: {n_steps} steps B={batch} "
              f"{sec:.3f} s, {n_steps * batch / sec:.2f} img/s, loss {loss:.5f}, peak "
              f"{peak:.2f} GiB [{card}] (information only)", flush=True)
    model.fused_train = bool(config.model.fused_train)
    return counts


# The run_lib phase: the run harness at full width on a seeded CIFAR-10
# fixture in its pickle layout (5 train batches and a test batch of
# RUN_LIB_IMAGES images each), through gddim_torch.cli as a user calls it.
# The test split holds n_jitted_steps x B = 640 images at least: the
# training loop's first get_dataset call makes an eval iterator of that
# batch, as the JAX loop's does
RUN_LIB_IMAGES = 768
RUN_LIB_EVAL_BATCHES = 4  # eval.max_eval_batches of the eval mode
RUN_LIB_BATCH, RUN_LIB_SAMPLE_BATCH, RUN_LIB_NFE = 128, 16, 50


def write_cifar_fixture(root: Path, n: int = RUN_LIB_IMAGES, seed: int = 0) -> Path:
    """CIFAR-10's python layout: data_batch_1..5 and test_batch, each a pickled
    {b'data': (n, 3072) uint8 rows (CHW), b'labels': [...]}, seeded."""
    import pickle

    rng = np.random.default_rng(seed)
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f, protocol=2)
    return root


def _cpu_clone(sd: dict) -> dict:
    return {k: {n: t.detach().cpu().clone() for n, t in v.items()} if isinstance(v, dict)
            else v.detach().cpu().clone() if torch.is_tensor(v) else v for k, v in sd.items()}


def _state_diffs(a: dict, b: dict) -> list:
    """The entries of two TrainState.state_dict()s that are not bit-equal."""
    bad = [k for k in set(a) ^ set(b)]
    for k in set(a) & set(b):
        if isinstance(a[k], dict):
            bad += [f"{k}.{n}" for n in set(a[k]) | set(b[k])
                    if n not in a[k] or n not in b[k] or not torch.equal(a[k][n], b[k][n])]
        elif torch.is_tensor(a[k]):
            bad += [] if torch.equal(a[k], b[k]) else [k]
        elif a[k] != b[k]:
            bad.append(k)
    return sorted(bad)


def _sum_counts(*parts) -> dict:
    """{kernel: n * per} summed over (n, per-call table) parts."""
    out: dict = {}
    for n, per in parts:
        for k, v in per.items():
            out[k] = out.get(k, 0) + n * v
    return out


def _files(folder: Path) -> dict:
    return {p.name: (p.stat().st_mtime_ns, p.read_bytes()) for p in sorted(folder.iterdir())}


def phase_run_lib(card: str):
    """The run harness on the card at full width (cld/accr_dcifar10, f32
    training and eval, bf16 sampling), in a temporary directory, through the CLI:
    train 20 steps (B=128, n_jitted_steps 5; log 5, eval, snapshots and
    preemption checkpoints 10, samples 10 at B=16 NFE=50), resume to 30
    (restored bit for bit), sampling from snapshot 2 (2 rounds of 16) and
    again (nothing rewritten), fid_stats and fid (proxy extractor), eval of
    snapshots 1-2 and again (read back from eval_meta.json), a full-width
    legacy export restored bit for bit that samples the snapshot's bits, and
    InceptionV3 (fid2015, seeded weights) at B=64. Launches counted per run
    and held to the per-step and per-eval tables. Returns the counts."""
    from gddim_torch import cli, run_lib
    from gddim_torch.checkpoints import legacy
    from gddim_torch.checkpoints.manager import CheckpointManager
    from gddim_torch.configs import get_config
    from gddim_torch.evals import features, inception

    events: list = []  # (what, seconds, bytes)
    seen: dict = {}

    class Timed(CheckpointManager):
        """The loop's manager, timed; the last meta save's and the restored
        state kept on the host for the bit check."""

        def save_meta(self, step, state):
            t0 = time.perf_counter()
            path = super().save_meta(step, state)
            event("save_meta", step, t0, path)
            if step == seen.get("keep_step"):
                seen["saved"] = _cpu_clone(state.state_dict())
            return path

        def save_snapshot(self, snapshot_id, state):
            t0 = time.perf_counter()
            path = super().save_snapshot(snapshot_id, state)
            event("save_snapshot", snapshot_id, t0, path)
            return path

        def restore_latest_meta(self, template):
            t0 = time.perf_counter()
            state, step = super().restore_latest_meta(template)
            if step:
                event("restore_meta", step, t0)
                seen["restored"], seen["restored_step"] = _cpu_clone(state.state_dict()), step
            return state, step

        def restore_snapshot(self, snapshot_id, template):
            t0 = time.perf_counter()
            state = super().restore_snapshot(snapshot_id, template)
            event("restore_snapshot", snapshot_id, t0)
            return state

    def event(what: str, n: int, t0: float, path=None):
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        size = path.stat().st_size if path else 0
        events.append((what, sec))
        print(f"run_lib {what} {n}: {sec:.3f} s" + (f", {size / 2**30:.3f} GiB" if path else "")
              + f" [{card}]", flush=True)

    def expect(label: str, parts) -> dict:
        """The launches of the run just made against the tables' sum."""
        want = _sum_counts(*parts)
        got = launches_of(want)
        print(f"run_lib {label}: launches {got}", flush=True)
        if got != want:
            raise AssertionError(f"run_lib {label}: launch counts {got} != {want}")
        reset_counts()
        return got

    def cli_run(*argv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["--device", "cuda", *argv])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    counts: dict = {}
    real_manager = run_lib.CheckpointManager
    run_lib.CheckpointManager = Timed
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            data = write_cifar_fixture(tmp / "cifar10")
            work, stats = tmp / "run", tmp / "stats.npz"
            sb, nfe = RUN_LIB_SAMPLE_BATCH, RUN_LIB_NFE
            common = ["--set", f"data.data_dir={data}", "--set", f"eval.stats_path={stats}",
                      "--set", f"eval.batch_size={sb}", "--set", f"eval.num_samples={2 * sb}",
                      "--set", f"sampling.nfe={nfe}"]
            train = ["--mode", "train", "--workdir", str(work), "--batch", str(RUN_LIB_BATCH),
                     "--set",
                     "training.n_jitted_steps=5", "--set", "training.log_freq=5", "--set",
                     "training.eval_freq=10", "--set", "training.snapshot_freq=10", "--set",
                     "training.snapshot_freq_for_preemption=10", "--set",
                     "training.snapshot_freq_for_sampling=10", "--set",
                     f"training.snapshot_sampling_batch={sb}", *common]
            # 1. train 20 steps: 4 calls, evals and samples (f32) at 10 and 20
            reset_counts()
            seen["keep_step"] = 20
            wall = cli_run(*train, "--steps", "20")
            seen["keep_step"] = None
            counts.update(expect("train 20 steps", [(20, PER_STEP), (2 + 2 * nfe, PER_EVAL_F32)]))
            records = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
            ips = [round(r["train/imgs_per_sec"], 2) for r in records if "train/imgs_per_sec" in r]
            saved = seen.pop("saved")
            snaps = CheckpointManager(work).snapshot_steps()
            samples_dirs = sorted(p.name for p in (work / "samples").iterdir())
            print(f"run_lib train 20 steps B={RUN_LIB_BATCH}: {wall:.2f} s with 2 evals, 2 sample "
                  f"grids, 5 checkpoint saves (and 2 host copies of the state for the resume "
                  f"check); loop img/s at steps 5/10/15/20 {ips} [{card}]; "
                  f"snapshots {snaps}, {samples_dirs}", flush=True)
            if snaps != [1, 2] or samples_dirs != ["iter_10", "iter_20"] or len(ips) != 4:
                raise AssertionError(f"run_lib train: files {snaps} {samples_dirs}, logs {ips}")
            # 2. resume to 30: restored from the meta checkpoint of step 20
            n_records = len(records)
            wall = cli_run(*train, "--steps", "30")
            counts.update(expect("resume to 30", [(10, PER_STEP), (1 + nfe, PER_EVAL_F32)]))
            diffs = _state_diffs(saved, seen.pop("restored"))
            del saved
            later = [json.loads(x) for x in (work / "metrics.jsonl").read_text().splitlines()]
            resumed = [r["step"] for r in later[n_records:] if "train/score_loss" in r]
            print(f"run_lib resume to 30: from meta step {seen['restored_step']}, logged steps "
                  f"{resumed}, {wall:.2f} s; tensors or generator not bit-equal to the saved "
                  f"state: {diffs or 'none'}", flush=True)
            if diffs or seen["restored_step"] != 20 or resumed != [25, 30]:
                raise AssertionError(f"run_lib resume: {diffs} {seen['restored_step']} {resumed}")
            # 3. sampling from snapshot 2: 2 rounds of 16 (bf16 'fused'); again: nothing
            res = tmp / "samples_ckpt2"
            sample = ["--mode", "sampling", "--workdir", str(work), "--ckpt", "2",
                      "--result_folder", str(res), *common]
            wall = cli_run(*sample)
            counts.update(expect("sampling --ckpt 2", [(2 * nfe, PER_EVAL_FULL)]))
            before = _files(res)
            wall2 = cli_run(*sample)
            expect("sampling --ckpt 2 again", [])
            print(f"run_lib sampling --ckpt 2: {sorted(before)} in {wall:.2f} s (restore, 2 x "
                  f"NFE={nfe} B={sb}); again {wall2:.2f} s, files unchanged: "
                  f"{_files(res) == before}", flush=True)
            if sorted(before) != ["samples_0.npz", "samples_1.npz"] or _files(res) != before:
                raise AssertionError(f"run_lib sampling: {sorted(before)}")
            # 4. scores with the proxy extractor
            wall = cli_run("--mode", "fid_stats", "--workdir", str(work), *common)
            wall2 = cli_run("--mode", "fid", "--workdir", str(work), "--result_folder", str(res),
                            *common)
            with np.load(res / "report.npz") as z:
                report = {k: z[k].item() for k in z.files}
            print(f"run_lib fid_stats {wall:.2f} s, fid {wall2:.2f} s: {report}", flush=True)
            if not all(np.isfinite(report[k]) for k in ("fid_proxy", "IS_proxy", "kid_proxy")):
                raise AssertionError(f"run_lib fid: {report}")
            # 5. eval of snapshots 1-2 under the training config (f32 loss and
            # samples, as the loop's); again: read back
            evaluate = ["--mode", "eval", "--workdir", str(work), "--set", "eval.begin_ckpt=1",
                        "--set", "eval.end_ckpt=2", "--set", "eval.enable_sampling=True",
                        "--set", f"eval.max_eval_batches={RUN_LIB_EVAL_BATCHES}", *common,
                        "--set", f"eval.num_samples={sb}"]
            wall = cli_run(*evaluate)
            counts.update(expect("eval snapshots 1-2", [
                (2 * (RUN_LIB_EVAL_BATCHES + nfe), PER_EVAL_F32)]))
            meta = (work / "eval" / "eval_meta.json").read_text()
            real_restore = run_lib.restore_state

            def refuse(*a, **k):
                raise AssertionError("eval restored a checkpoint eval_meta.json holds")

            run_lib.restore_state = refuse
            try:
                wall2 = cli_run(*evaluate)
            finally:
                run_lib.restore_state = real_restore
            expect("eval again", [])
            same = (work / "eval" / "eval_meta.json").read_text() == meta
            print(f"run_lib eval: {wall:.2f} s, {json.loads(meta)}; again {wall2:.2f} s, "
                  f"eval_meta.json unchanged: {same}", flush=True)
            if not same or sorted(json.loads(meta)) != ["1", "2"]:
                raise AssertionError("run_lib eval: eval_meta.json changed or incomplete")
            # 6. the legacy layout at full width: export snapshot 2, restore the file
            config = get_config("cld/accr_dcifar10")
            config.eval.num_samples = config.eval.batch_size = sb
            config.sampling.nfe = nfe
            _, state = run_lib.restore_state(config, 2, work, "cuda")
            t0 = time.perf_counter()
            path = legacy.export_legacy_checkpoint(tmp / "checkpoint_legacy", state)
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, state2 = run_lib.restore_state(config, path, device="cuda")
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            sd, sd2 = state.state_dict(), state2.state_dict()
            diffs = [k for k in ("params", "ema", "mu", "nu")
                     for n in sd[k] if not torch.equal(sd[k][n], sd2[k][n])]
            diffs += [k for k in ("step", "count") if sd[k] != sd2[k]]
            del state, state2, sd, sd2
            reset_counts()
            (legacy_round,) = run_lib.sample_data(config, str(path), tmp / "legacy_samples",
                                                  device="cuda")
            counts.update(expect("sampling from the legacy file", [(nfe, PER_EVAL_FULL)]))
            with np.load(legacy_round) as a, np.load(res / "samples_0.npz") as b:
                same = {k: bool(np.array_equal(a[k], b[k])) for k in b.files}
            print(f"run_lib legacy: {path.stat().st_size / 2**30:.3f} GiB written in "
                  f"{write_s:.2f} s, read into a state in {read_s:.2f} s [{card}]; not bit-equal: "
                  f"{diffs or 'none'}"
                  f"; its samples against snapshot 2's (seed {config.seed}): {same}", flush=True)
            if diffs or not all(same.values()):
                raise AssertionError(f"run_lib legacy: {diffs} {same}")
    finally:
        run_lib.CheckpointManager = real_manager
    for what in ("save_meta", "save_snapshot", "restore_meta", "restore_snapshot"):
        sec = [s for w, s in events if w == what]
        print(f"run_lib {what}: {len(sec)} in {sum(sec):.2f} s, {min(sec):.3f}-{max(sec):.3f} s "
              f"each [{card}]", flush=True)
    # InceptionV3 (fid2015) on seeded weights at B=64
    net = inception.InceptionV3(inception.random_state_dict(np.random.default_rng(0), 1008),
                                "fid2015").to("cuda").eval()
    extractor = features.FeatureExtractor("inception_fid2015", net, 2048, 1008)
    imgs = np.random.default_rng(1).integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)
    features.run_features(extractor, imgs, batch_size=64)  # warm
    t0 = time.perf_counter()
    pools, logits = features.run_features(extractor, imgs, batch_size=64)
    sec = time.perf_counter() - t0
    finite = bool(np.isfinite(pools).all() and np.isfinite(logits).all())
    print(f"run_lib InceptionV3 fid2015 B=64: {sec * 1e3:.1f} ms with the host copies, pool_3 "
          f"{pools.shape}, logits {logits.shape}, finite {finite} [{card}]", flush=True)
    if not finite or pools.shape != (64, 2048) or logits.shape != (64, 1008):
        raise AssertionError("run_lib InceptionV3: bad features")
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description="smoke run of gddim_torch on one CUDA card")
    # opt-in phases: profile, ab, train_time (K6/K7 device time and a traced
    # B=128 step; a parent's checkout runs it too), train_gemms (the training
    # GEMMs alone, as the kernels phase runs them), gn_bwd and gn2_prepass
    # (K7's GN backward and GN2's pre-pass alone, likewise), gn_bwd_plans
    # (the GN backward under every cluster plan), eval_span (the B=64 eval's
    # device time and GN2's pre-pass; a parent's checkout runs it too), bits
    # (outputs behind GN2's pre-pass, saved and held against another tree's),
    # train_ab (the loss curves), blur_span (the blur layer-wise int8 and
    # pallas evals' device time, K11 int8's, K12's, K11's and K1's; a
    # parent's checkout runs it too), f32_time (K2-K5/K9 on f32 activations
    # at every shape, B=4/16/64, beside F.conv2d) and f32_span (the traced
    # f32 B=64 eval), k1_time (K1 at its sites, B=4/16/64, beside
    # F.group_norm; --k1-save / --k1-ref hold two trees' outputs), each of the
    # three on a parent's checkout too
    parser.add_argument("--phases", default="build,kernels,eps,gates,sample,int8,blur,samplers,"
                        "blur_deis,f32,train,blur_train,run_lib")
    parser.add_argument("--batch", type=int, default=16, help="sampling batch")
    parser.add_argument("--bits", default=None, help="phase bits: the file to save to")
    parser.add_argument("--bits-ref", default=None, help="phase bits: another tree's file")
    parser.add_argument("--k1-save", default=None, help="phase k1_time: save K1's outputs here")
    parser.add_argument("--k1-ref", default=None,
                        help="phase k1_time: another tree's K1 outputs to hold them against")
    args = parser.parse_args(argv)
    phases = set(args.phases.split(","))

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    root = Path(__file__).resolve().parent
    if not (root / "gddim_torch").is_dir():
        raise SystemExit(f"chip_smoke: no gddim_torch package in {root}")
    sys.path.insert(0, str(root))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from gddim_torch import _build
    from gddim_torch.configs import get_config
    from gddim_torch.ops import groupnorm

    t0 = time.perf_counter()
    _build.library()
    x = torch.zeros((1, 4, 4, 128), device="cuda", dtype=torch.bfloat16)
    groupnorm.group_norm_silu(x, torch.ones(128, device="cuda"), torch.zeros(128, device="cuda"))
    torch.cuda.synchronize()
    print(f"build: nvcc {_build.build_seconds:.1f} s, total with K1's first launch "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    results: dict = {}  # the kernels line's (B=4)
    batch_results: dict = {}  # the int8 blocks and the bare GEMM at other batches
    if "kernels" in phases:
        phase_kernels(results, batch_results)
        phase_s8_kernels(results, batch_results)
        phase_bf16_kernels(results, batch_results)
        phase_train_kernels(results, batch_results)
        phase_layer_kernels(results, batch_results)
        phase_transition_kernels(results, batch_results)
        phase_attn_train_kernels(results)
        phase_f32_activations()
        phase_attn_kernels(results, card)
        phase_gn_kernels(results, batch_results)
        phase_gn_apply_kernels(results, batch_results)
        phase_gn2_prepass_kernels(results, batch_results)
        report_gn_routes()
        print_sums(results, batch_results)
        print_block_sums(results, batch_results)
    config = get_config("cld/accr_dcifar10")
    # the transitions through K1, the FIR passes and K4: the path each phase's
    # K9 run (run_k9) is held against
    config.model.transition_impl = "tail"
    model = phase_eps(config) if "eps" in phases else None
    if "gates" in phases:
        phase_gates(card)
    # each path's launches, counted from 0 just before it runs: the bf16
    # sampling path, then the int8 one and the training one for their kernels
    counts, samples = {}, None
    if "sample" in phases:
        if model is None:
            from gddim_torch.models.init import seeded_model

            model = seeded_model(config, seed=0, device="cuda")
        counts, samples = phase_sample(config, model, args.batch, card)
    del model
    if "int8" in phases:
        if samples is None:
            raise SystemExit("chip_smoke: the int8 phase compares with the sample phase's output")
        int8_counts = phase_int8(config, samples, args.batch, card)
        counts.update({k: n for k, n in int8_counts.items() if k not in counts})
    if "blur" in phases:
        blur_counts = phase_blur(args.batch, card)
        counts.update({k: n for k, n in blur_counts.items() if k not in counts})
    if "samplers" in phases:
        sampler_counts = phase_samplers(card, args.batch)
        counts.update({k: n for k, n in sampler_counts.items() if k not in counts})
    if "blur_deis" in phases:
        blur_deis_counts = phase_blur_deis(card, args.batch)
        counts.update({k: n for k, n in blur_deis_counts.items() if k not in counts})
    if "f32" in phases:
        f32_counts = phase_f32(card, args.batch)
        counts.update({k: n for k, n in f32_counts.items() if k not in counts})
    if "f32_time" in phases:
        phase_f32_time(card)
    if "f32_span" in phases:
        trace_f32_eval(card, 64)
    if "k1_time" in phases:
        phase_k1_time(card, args.k1_save, args.k1_ref)
    if "profile" in phases:
        phase_profile(config, args.batch, card)
    if "ab" in phases:
        phase_ab(config, card)
    if "train" in phases:
        train_counts = phase_train(card)
        counts.update({k: n for k, n in train_counts.items() if k not in counts})
    if "blur_train" in phases:
        blur_train_counts = phase_blur_train(card)
        counts.update({k: n for k, n in blur_train_counts.items() if k not in counts})
    if "run_lib" in phases:
        run_lib_counts = phase_run_lib(card)
        counts.update({k: n for k, n in run_lib_counts.items() if k not in counts})
    if "train_gemms" in phases and "kernels" not in phases:
        check_train_gemms({}, {})
    if "gn_bwd" in phases and "kernels" not in phases:
        check_gn_bwd({}, {})
    if "gn_bwd_plans" in phases:
        phase_gn_bwd_plans(card)
    if "eval_span" in phases:
        phase_eval_span(card)
    if "blur_span" in phases:
        phase_blur_span(card)
    if "bits" in phases:
        phase_bits(args.bits or "bits.pt", args.bits_ref)
    if "gn2_prepass" in phases and "kernels" not in phases:
        phase_gn2_prepass_kernels({}, {})
    if "train_time" in phases:
        phase_train_time(card)
    if "train_ab" in phases:
        phase_train_ab(card)
    if phases >= {"kernels", "sample", "int8", "blur", "train"}:
        missing = [k for k in KERNELS if counts.get(k, 0) == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: {missing}")
        print(json.dumps({"kernels": [
            dict(**KERNELS[k], launches=counts[k], max_abs_err=results[k]["max_abs_err"],
                 max_rel_err=results[k]["max_rel_err"], ms=results[k]["ms"],
                 plain_ms=results[k]["plain_ms"], bound_ms=results[k]["bound_ms"],
                 bound_by="bytes" if results[k]["bytes_ms"] >= results[k]["ops_ms"]
                 else "operations",
                 library_ms=results[k]["library_ms"], shapes=results[k]["shapes"])
            for k in KERNELS
        ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
