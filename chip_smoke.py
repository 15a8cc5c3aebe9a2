#!/usr/bin/env python3
"""Smoke check of the PyTorch port (``glfusion_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises and the exit code is
nonzero:

  env     torch and CUDA versions, the card's name and power limit; TF32 is
          switched off for matmuls and cuDNN, for every comparison below.
  build   nvcc builds the port's CUDA kernels (``tpavi_fused.cu``,
          ``stem_fused.cu``) and g++ the native NIfTI decoder
          (``nifti_reader.cpp``) from the checkout's sources, in parallel;
          with g++ and zlib's header on the machine the decoder must
          build and load.
  kernel  the TPAVI kernel against its plain PyTorch version (relative max
          and norm error) at small,
          ragged, N <= C', C' > 1024 and serving shapes, float32 and
          bfloat16, on contiguous and on strided (split-projection)
          operands, with its contraction order, its time and each stage's,
          the plain version's, two cuBLAS yardsticks' and the card's bound;
          against the float64 naive chain at the serving shape in float32
          and at both clip shapes in bfloat16; at ``temporal``'s (1, 94 080,
          1024), in split K, against the float64 reassociated chain in
          both types.
  kernel_backward  the TPAVI kernel's autograd backward at the train
          shapes (8, 40 and 48, 2352, 1024) against autograd of the plain
          version: dθ, dφ, dg.
  stem    the five fused-stem kernels against the plain (cuDNN) stem at
          B = 8, 40 and 48, 112², C = 64, float32 and bfloat16: pooled output,
          batch mean and variance, all five gradients, eval output;
          ``stem_bwd2``'s own dW, db and dx partials against its plain
          version; the dx reduce pass against its plain version; two runs
          of ``stem_bwd2`` with its reduce pass, and of the fused stem's
          backward, bitwise equal; a per-view run with three views' own
          weights; each kernel's time, bound and the plain version's
          time.
  serve   the full-width flagship (``Config().model`` with
          ``use_pallas_fusion=True``, random weights from seed 0) serves four
          NIfTI clips through ``ClipPipeline``, each at its true frame
          count (40, 40, 27; 40 at 160²); the masks and the kernel's launch
          count are checked, and a 112² and the 160² clip are held against
          the plain-torch naive and reassociated attention orders.
  http    the same pipeline behind ``http_serve`` on 127.0.0.1: /healthz,
          /predict for the four clips (masks equal to ``ClipPipeline``'s
          bit for bit, latency per request), a malformed body's 400.
  export  the same model as a ``torch.export`` program (K1 as the
          registered op), saved, then loaded in a fresh process that
          imports no model code: its masks at 27 and 40 frames equal the
          live path's bit for bit; export, save and load times, bytes and
          K1's launches in the loaded program.
  profile where one serving forward's device time goes (torch.profiler);
          printed before the serve line.
  aspp    the ASPP's clipped-tap form against its plain dilated
          convolutions on the card, at the f4 of 112² and 160² clips
          (28², 40²), float32 and bfloat16: output, input and weight
          gradients; both forms timed.
  train   the full-width flagship trains through ``Trainer`` with the TPAVI
          kernel and a ``FusedIEKDStem`` in every view on a small synthetic
          corpus (one epoch of a few steps), then validates; launch counts,
          finite losses, s/step, peak memory, a profiled step and the
          validation Dice; one step through the kernels held against the
          same step through the plain versions, on a state and batch fixed
          before the epoch (``step_verdict``); the saved checkpoint loads
          back. Its ``native`` line: whether the NIfTI decoder built (the
          g++ version), every corpus file read by one batched native read
          and by the pure reader, equal bit for bit, both timed, and when
          ``Trainer``'s warm-up thread ended against the first step.
  temporal  the float32 flagship with ``temporal``: one epoch, K1 at
          (1, 94 080, 1024) in the cycle pass, s/step, peak memory, the
          step check with reassociated plain paths.
  cps     the CPS twin, float32 with remat, fused stems and K1 in both
          networks: one epoch, finite losses, launches, s/step, peak.
  checkify  one epoch each without and with ``checkify`` (off, on, on,
          off: its s/step cost), then an epoch with one NaN pixel, which
          must raise JAX's message before the epoch returns.
  train_bf16  the same flagship in JAX bench.py's recorded configuration,
          bfloat16 with remat, trains one epoch through ``Trainer`` in each
          form of the cycle pass (the plain step, ``cycle_light``,
          ``fuse_passes``): launch counts, finite losses, s/step, peak
          memory; a profiled plain step and one step held against the plain
          versions at a bfloat16 tolerance.
  lifecycle  the training lifecycle and the output modes on the float32
          flagship with the kernels: U trains 2 epochs, three reruns the
          same again (the noise yardstick), S is stopped in epoch 0 and R resumes it in
          a fresh ``Trainer``; R's seeds, crops and cycle draws equal U's,
          and R's weights lie within ``resume_agreement`` of U's, which a
          resume with Adam's moments zeroed must fail; the sweep over U's
          epochs, ``--torch-ckpt`` on U's last file, infer, visual and
          serve on R's weights; checkpoint size, save, load and sweep
          times, clips/s and the disk's peak.
  variants  the flagship's eight ablations, float32 with K1 and the fused
          stems: each trains 2 steps through ``Trainer`` and runs an eval
          forward; K1's calls a step (4, 2 or 0 by the branches it runs)
          and the stems' launches asserted per variant; K1 in situ in
          ``fg_bg``, ``conv_merge`` and ``local_only``; in
          ``early_fusion`` the stem's dx and ``early_mix``'s gradient
          against the plain stem on the step's tensors; the eval forward
          against the plain stems and the reassociated order; s/step and
          peak memory per variant.
  mesh    two ranks share the card over gloo (the script starts itself
          twice as ``--mesh-rank``, as a launcher would: ``PMI_SIZE``,
          ``PMI_RANK``): the full-width float32 flagship with K1 and the
          fused stems takes one step through ``Trainer`` at (data 2),
          (model 2) and with ``temporal`` at (data 2), on a global batch
          of 4 frames and a 24-frame clip a view; rank 0 then runs one
          process's step on the same batch and state. The gradients and
          the BN running statistics within ``step_verdict`` of one
          process's plain path (its second paths' noise, ``STEP_TOL``),
          the weights against Adam's update of the summed gradients, the
          replicated leaves bit for bit equal on both ranks, K1 and the
          stems launched and held in situ in the ranks, the (1, 2)
          checkpoint restored by one process bit for bit; each rank's
          peak memory, the step's seconds and one process's.
  zoo     the segmentation zoo (``--model``: the U-Net family, the
          multi-view U-Nets, UTNet, CEN, the 3-D ResUNet) at ``Config()``
          widths, float32: each trains 2 steps through ``Trainer``, then an
          eval forward is timed and counted (``utils/profiling.py``) and
          held against its float64 twin on the card; res3dunet's loss with
          and without its deep-supervision maps; the six library
          segmenters (``models/segmentation.py``) at full width, batch 8
          of 112² frames (a reference and three supports for the
          multi-frame two), each eval forward timed, counted, its peak
          memory read and held against its float64 twin, one line each,
          and one train forward and backward of the multi-frame model
          (finite gradients, four BatchNorm updates of its backbone);
          K1's and the stems' launch counts unmoved by the phase.
  regression  the mPAP regressors (``--reg-model``: Resnet50PAH,
          R(2+1)D-18, TimeSformer, Resnet50PFS) at full width, float32, 3
          views of 48 frames at 112², batch 8: each trains one epoch of 2
          steps through ``RegressionTrainer`` on a 24-patient synthetic
          corpus (s/step, peak memory), ``evaluate()`` (finite scores), an
          eval forward timed, counted and held against its float64 twin on
          the card, and a checkpoint restored by a fresh trainer bit for
          bit; one line a model; K1's and the stems' launch counts unmoved.

The last lines are the kernels' record, the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks, dense: float32 outside the tensor cores,
# bfloat16 tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# temporal's cycle pass: a 40-frame clip's 3 views of 28² tokens, one batch
TEMPORAL_N = 40 * 3 * 28 * 28
KERNEL_SHAPES = [  # (B, N, C'), dtypes
    ((2, 75, 32), ("float32",)),
    ((2, 192, 128), ("float32",)),
    ((4, 300, 1024), ("float32", "bfloat16")),   # N <= C': (θφᵀ)g order
    ((2, 192, 1536), ("float32", "bfloat16")),   # C' > 1024
    ((40, 2352, 1024), ("float32", "bfloat16")),  # 112² clips
    ((48, 2352, 1024), ("float32", "bfloat16")),  # fused passes: 8 + 40
    ((40, 4800, 1024), ("float32", "bfloat16")),  # 160² clips
    ((1, TEMPORAL_N, 1024), ("float32", "bfloat16")),  # temporal's clip
]
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}  # max|y-ref| / max|ref|
# ‖y-ref‖ / ‖ref‖. In bfloat16 the max above is set by flips of the output's
# own rounding; the norm tells a float32 intermediate (the hi/lo pair) from
# one rounded to bfloat16 (both readings in PERF.md, K1 at every shape)
KERNEL_NORM_TOL = {"float32": 2e-6, "bfloat16": 5e-4}
SERVE_SHAPE = (40, 2352, 1024)
# held against the float64 chain: the serving shape in float32, both clip
# shapes in bfloat16 (where the intermediate's precision shows), and
# temporal's in both (there in the reassociated order: the naive map of
# 94 080² would take 71 GB in float64)
NAIVE64 = {(SERVE_SHAPE, "float32"), ((40, 2352, 1024), "bfloat16"),
           ((40, 4800, 1024), "bfloat16"), ((1, TEMPORAL_N, 1024), "float32"),
           ((1, TEMPORAL_N, 1024), "bfloat16")}
# float32 ‖y-ref‖ / ‖ref‖ against the float64 chain where stage 1 runs in
# split K (N > 2·SPLIT_K), with the unsplit kernel as its control, which
# must exceed it: at (1, 94 080, 1024) split K reads 1.28e-6, the unsplit
# kernel 5.52e-6 (PERF.md, K1 at temporal's shape). In bfloat16 both read
# 1.66e-3, the output's own rounding, so this check is float32's alone.
SPLIT_F64_NORM_TOL = 2.5e-6
CLIPS = [("c0", 112, 40), ("c1", 112, 40), ("c2", 112, 27), ("c3", 160, 40)]
# the plain paths form the naive N×N attention map up to this N
NAIVE_MAX_N = 8192
# the TPAVI kernel's train shapes: the supervised pass (8 frames), the
# cycle pass (40-frame clips) and the fused pass (both), 3 views of 28²
# tokens, C' = 1024
K1_TRAIN_SHAPES = [(8, 2352, 1024), (40, 2352, 1024), (48, 2352, 1024)]
K1_GRAD_TOL = 1e-4  # max|d − ref| / max|ref|, float32
# the stem at the train step's batches: 8 supervised frames, 40 clip
# frames, 48 in a fused pass
STEM_BATCHES = (8, 40, 48)
STEM_HW, STEM_C = 112, 64
STEM_TOL = {  # relative max error of the output and the statistics, and
    # relative norm error of the gradients; bf16 holds one output rounding
    "float32": {"out": 1e-4, "stat": 1e-5, "grad": 1e-3},
    "bfloat16": {"out": 1e-2, "stat": 1e-5, "grad": 1e-2},
}
# train phase: 4 synthetic patients (2 train, 1 val, 1 test), each train
# patient repeated 16 times an epoch → 4 steps of batch 8
TRAIN_PATIENTS, TRAIN_REPEAT = 4, 16
# relative; see step_verdict and in_situ_verdict. float32: three second
# plain paths; tensors of fewer than 64 elements against their module's
# weight gradient; each K1 call of the step at the kernel phase's norm
# limit, each stem call's gradients within 10× their own second paths'
# noise + 1e-5
STEP_TOL = {"loss": 1e-4, "grad": 1e-3, "noise": 10, "noise_paths": 3,
            "small": 64, "kernel": KERNEL_NORM_TOL["float32"], "stem": 1e-5}
# bfloat16 (one rounding is 2⁻⁸ relative, and any two summation orders
# round some near-tied sums apart): each loss and gradient within 10× the
# largest of three second plain paths' own differences + 1e-2 (PERF.md
# section 2), the third through the fused stem's plain version with K1's
# bfloat16 hi/lo intermediate; every tensor against itself. The heads'
# last conv biases are read before their last rounding
# (``exact_bias_sums``)
STEP_TOL_BF16 = {"loss": 1e-2, "loss_noise": 10, "grad": 1e-2, "noise": 10,
                 "noise_paths": 3, "small": 1,
                 "kernel": KERNEL_NORM_TOL["bfloat16"],
                 "stem": STEM_TOL["bfloat16"]["grad"]}
# a conv computing in bfloat16 whose bias has fewer elements than this
# (the heads' last convs: one a class, and the centerness head's one) has
# its bias gradient read as the float64 sum of its output's cotangent.
# Autograd rounds that sum once to one bfloat16 number, so paths land on
# the same value or whole ulps (0.4–0.8 %) apart, and a second path that
# lands on the plain path's value reads a noise of exactly 0 (PERF.md
# section 6, PR 17)
EXACT_BIAS_ELEMENTS = 64
# the ASPP check: f4 of a 40-frame clip at 112² (28²) and 160² (40²), the
# clipped-tap form against plain dilated convolutions; relative norm of
# the output and of every gradient. The gradients pass train-mode BNs and
# ReLUs, whose gates at zero flip between summation orders (float32:
# measured up to 1.3e-3 on a branch's BN bias, PERF.md section 6)
ASPP_CASES = [(40, 28), (40, 40)]
ASPP_TOL = {"float32": {"out": 1e-4, "grad": 1e-2},
            "bfloat16": {"out": 2e-2, "grad": 5e-2}}
# train_bf16: JAX bench.py's recorded configuration (bfloat16, remat) in
# each form of the cycle pass, one epoch each on the train phase's corpus
BF16_VARIANTS = (("plain", {}), ("cycle_light", {"cycle_light": True}),
                 ("fuse_passes", {"fuse_passes": True}))
# lifecycle: each tensor of the resumed run R within 10× the largest of
# its reruns' relative-norm differences from the uninterrupted run U, + this
# floor; bitwise where every rerun is. A rerun (U′) is U again: cuDNN's
# choices and atomics in PyTorch's own CUDA backward ops make two runs
# differ. Three reruns, because a tensor of one element (each view's
# centerness bias) has one noise draw a rerun: for Gaussian noise the
# ratio of two such draws exceeds 10 in 6.3 % of runs, R's against the
# largest of three in 0.08 % (PERF.md section 6; measured: against each of
# one run's three reruns alone R's worst ratio read 2.55, 0.56 and 0.27,
# against the largest 0.16). The restore itself is checked bit for bit
# (``state_diff``)
RESUME_NOISE, RESUME_FLOOR, RESUME_RERUNS = 10, 1e-6, 3
# variants: the flagship's ablations, VARIANT_STEPS steps each on the train
# phase's corpus (train_repeat VARIANT_REPEAT: 2 train patients × 8 = 16
# frames, 2 batches of 8); K1's calls a step, 2 passes × the attentions
# each variant runs (JAX glfusion.py:233-259); K1 held in situ in these
VARIANT_STEPS, VARIANT_REPEAT = 2, 8
VARIANT_K1 = {"cyc_nofusion": 4, "conv_merge": 4, "fg_bg": 4,
              "global_only": 2, "global_only_cyc_nofusion": 2,
              "local_only": 2, "early_fusion": 0, "late_fusion": 0}
VARIANT_IN_SITU_K1 = ("fg_bg", "conv_merge", "local_only")
# zoo: the segmentation zoo's twenty architectures at Config() widths, each
# VARIANT_STEPS steps on the train phase's corpus (train_repeat
# VARIANT_REPEAT), then one eval forward held against the same module in
# float64 on the card within ZOO_TOL in relative norm
ZOO_ARCHS = ("unet", "unet:plain", "unet:r2", "unet:att", "unet:r2att",
             "multiview_unet", "utnet", "cen", "res3dunet",
             "avs_baseline", "avs_transfusion", "avs_model17",
             "avs_pred_endecoder", "legacy:none", "legacy:channel_transformer",
             "legacy:tpavi", "legacy:model18", "legacy:model20",
             "legacy:decouple", "legacy:mlp_concat")
ZOO_TOL = 1e-4
# the parameters no loss reaches (CEN's ensemble logits, B2ResNet's second
# layer3/layer4 fork): Adam moves them on the L2 term alone, as optax does
ZOO_OUTSIDE_LOSS = ("net.alpha", "layer3_2_", "layer4_2_")
# regression: the four --reg-model names at JAX's full-width defaults,
# float32, on a synthetic corpus of REG_PATIENTS patients (16 train: 2 steps
# of 8 an epoch, 3 val), 3 views, crop 112², 48 frames; each eval forward
# held against its float64 twin on the card within REG_TOL
# the library segmenters (models/segmentation.py): the ctors, at their
# defaults (ResNet-50, ASPP 256), on batch 8 of 112² frames
SEGMENTERS = ("deeplabv3_resnet50", "deeplabv3_resnet50_iekd",
              "deeplabv3_resnet50_iekd_project",
              "deeplabv3_resnet50_iekd_maxmod", "deeplabv3_resnet50_mltfrm",
              "deeplabv3_resnet50_mltfrm_spatatt")
SEG_BATCH, SEG_HW, SEG_SUPPORTS = 8, 112, 3
REG_ARCHS = ("resnet50pah", "r2plus1d", "timesformer", "resnet50pfs")
REG_PATIENTS, REG_STEPS, REG_TOL = 24, 2, 1e-4
# infer against serve: a voxel's mask may differ only where the clip's
# logit there lies this close to the threshold 0
MASK_FLIP_LOGIT = 1e-3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` launches, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def kernel_error(torch, theta, phi, g):
    """The kernel against its plain version: (max|y-ref|, that / max|ref|,
    ‖y-ref‖ / ‖ref‖)."""
    from glfusion_tpu_torch.ops.tpavi_fused import (fused_dot_nonlocal,
                                                    fused_dot_nonlocal_plain)

    y = fused_dot_nonlocal(theta, phi, g)
    torch.cuda.synchronize()
    ref = fused_dot_nonlocal_plain(theta, phi, g).float()
    check(y.dtype == theta.dtype and y.shape == theta.shape,
          f"kernel output {y.dtype} {tuple(y.shape)}")
    diff = y.float() - ref
    abs_err = diff.abs().max().item()
    return (abs_err, abs_err / ref.abs().max().item(),
            (diff.norm() / ref.norm()).item())


def naive64_error(torch, theta, phi, g) -> dict:
    """The kernel against the chain (θφᵀ/N)·g in float64, independent of
    the plain version: ``rel`` = max|y-ref| / max|ref| and ``norm`` =
    ‖y-ref‖ / ‖ref‖. Naive where the N×N map is small (N ≤ NAIVE_MAX_N),
    else θ(φᵀg)/N in float64. Where stage 1 runs in split K, also the
    unsplit kernel's readings (``unsplit_rel``, ``unsplit_norm``): the
    control of the split-K gate."""
    from glfusion_tpu_torch.ops import tpavi_fused
    from glfusion_tpu_torch.ops.tpavi_fused import (fused_dot_nonlocal,
                                                    fused_dot_nonlocal_naive)

    t, p, gg = (x.double() for x in (theta, phi, g))
    n = t.shape[-2]
    if n <= NAIVE_MAX_N:
        ref = fused_dot_nonlocal_naive(t, p, gg)
    else:
        ref = torch.bmm(t, torch.bmm(p.transpose(1, 2), gg)) / n
    del t, p, gg

    def errors(y):
        d = y.double() - ref
        return ((d.abs().max() / ref.abs().max()).item(),
                (d.norm() / ref.norm()).item())

    out = dict(zip(("rel", "norm"), errors(fused_dot_nonlocal(theta, phi,
                                                              g))))
    if tpavi_fused.reassociated(n, theta.shape[-1]) and (
            n > 2 * tpavi_fused.SPLIT_K):
        split_k = tpavi_fused.SPLIT_K
        tpavi_fused.SPLIT_K = n  # stage 1 in one pass over the N tokens
        try:
            y = fused_dot_nonlocal(theta, phi, g)
        finally:
            tpavi_fused.SPLIT_K = split_k
        out["unsplit_rel"], out["unsplit_norm"] = errors(y)
    return out


def kernel_phase(torch):
    from glfusion_tpu_torch.ops import tpavi_fused
    from glfusion_tpu_torch.ops.tpavi_fused import (fused_dot_nonlocal,
                                                    fused_dot_nonlocal_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = {}
    failures = []  # every shape's line is printed before any check raises
    for (b, n, c), dtypes in KERNEL_SHAPES:
        for dt_name in dtypes:
            dt = getattr(torch, dt_name)
            tol, norm_tol = KERNEL_TOL[dt_name], KERNEL_NORM_TOL[dt_name]
            theta, phi, g = (torch.randn(b, n, c, device="cuda",
                                         generator=gen).to(dt)
                             for _ in range(3))
            abs_err, rel_err, norm_err = kernel_error(torch, theta, phi, g)
            # the eval path's operands: strided views of one (B, N, 3C')
            # projection, passed with their row stride 3C'
            split = torch.randn(b, n, 3 * c, device="cuda",
                                generator=gen).to(dt).split(c, dim=-1)
            _, strided_rel_err, strided_norm_err = kernel_error(torch, *split)
            del split
            f64 = {}
            if ((b, n, c), dt_name) in NAIVE64:
                f64 = naive64_error(torch, theta, phi, g)
            where = f"kernel {(b, n, c)} {dt_name}"
            split_tol = (SPLIT_F64_NORM_TOL if "unsplit_norm" in f64
                         and dt_name == "float32" else None)
            for what, err, limit in (
                    ("relative error", rel_err, tol),
                    ("relative norm error", norm_err, norm_tol),
                    ("strided operands: relative error", strided_rel_err,
                     tol),
                    ("strided operands: relative norm error",
                     strided_norm_err, norm_tol),
                    ("against the float64 chain: relative error",
                     f64.get("rel"), tol),
                    ("split K against the float64 chain: relative norm "
                     "error", f64.get("norm"), split_tol)):
                if limit is not None and err is not None and not (
                        math.isfinite(err) and err <= limit):
                    failures.append(f"{where}, {what} {err} > {limit}")
            if split_tol is not None and not f64["unsplit_norm"] > split_tol:
                failures.append(
                    f"{where}, control: the unsplit kernel's relative norm "
                    f"error against the float64 chain "
                    f"{f64['unsplit_norm']} passes the split-K limit "
                    f"{split_tol}")
            reps = 10
            kernel_ms = time_ms(torch, lambda: fused_dot_nonlocal(
                theta, phi, g), reps)
            # each stage alone (these launches are not counted)
            order, stage1, stage2, _ = tpavi_fused.stages(theta, phi, g)
            stage1_ms = time_ms(torch, stage1, reps)
            stage2_ms = time_ms(torch, stage2, reps)
            plain_ms = time_ms(torch, lambda: fused_dot_nonlocal_plain(
                theta, phi, g), reps)
            # cuBLAS in the input type, in both orders: yardsticks only, the
            # port never calls them. The library's time is the faster. (In
            # bfloat16 cuBLAS rounds the intermediate, which the kernel
            # keeps as a hi/lo pair.)
            bmm_ms = None  # the naive map does not fit above NAIVE_MAX_N
            if n <= NAIVE_MAX_N:
                bmm_ms = time_ms(torch, lambda: torch.bmm(
                    torch.bmm(theta, phi.transpose(1, 2)) / n, g), reps)
            reassoc_ms = time_ms(torch, lambda: torch.bmm(
                theta, torch.bmm(phi.transpose(1, 2), g)) / n, reps)
            # The function needs two products in the cheaper order:
            # 4·B·N·C'·min(N, C') FLOP (the naive order, 4·B·N²·C', is
            # printed beside it).
            peak = PEAK_FLOPS[dt_name]
            t_ops = 4 * b * n * c * min(n, c) / peak * 1e3
            t_bytes = 4 * b * n * c * theta.element_size() / PEAK_BYTES * 1e3
            rec = {
                "shape": [b, n, c], "dtype": dt_name,
                "rel_err": rel_err, "max_abs_err": abs_err,
                "norm_err": norm_err, "strided_rel_err": strided_rel_err,
                "strided_norm_err": strided_norm_err,
                "naive64_rel_err": f64.get("rel"),
                "naive64_norm_err": f64.get("norm"),
                "unsplit_naive64_rel_err": f64.get("unsplit_rel"),
                "unsplit_naive64_norm_err": f64.get("unsplit_norm"),
                "split_f64_norm_tol": split_tol,
                "tol": tol, "norm_tol": norm_tol, "order": order,
                "kernel_ms": kernel_ms, "stage1_ms": stage1_ms,
                "stage2_ms": stage2_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "naive_order_bound_ms": max(4 * b * n * n * c / peak * 1e3,
                                            t_bytes),
                "plain_ms": plain_ms,
                "library_ms": min(t for t in (bmm_ms, reassoc_ms)
                                  if t is not None),
                "bmm_ms": bmm_ms, "reassoc_ms": reassoc_ms,
            }
            records[((b, n, c), dt_name)] = rec
            emit("kernel", **rec)
            del theta, phi, g
            torch.cuda.empty_cache()
    check(not failures, "; ".join(failures))
    return records


def randomize_(torch, model, seed: int = 0) -> None:
    """Seeded random weights, BN running stats and LayerNorm affines. Both
    TPAVI W_z BNs get a nonzero scale and bias: at their zero init the
    attention output would be multiplied by 0 and never reach the masks."""
    nn = torch.nn
    gen = torch.Generator().manual_seed(seed)

    def uniform(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=gen) * (hi - lo) + lo)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * math.sqrt(2.0 / fan_in))
                if m.bias is not None:
                    uniform(m.bias, -0.05, 0.05)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                uniform(m.weight, 0.5, 1.0)
                uniform(m.bias, -0.1, 0.1)
                uniform(m.running_mean, -0.1, 0.1)
                uniform(m.running_var, 0.5, 1.5)
            elif isinstance(m, nn.LayerNorm):
                uniform(m.weight, 0.8, 1.2)
                uniform(m.bias, -0.1, 0.1)
    for attn in (model.global_attn, model.local_attn):
        check(bool((attn.W_z[1].weight != 0).all()),
              "W_z BN scale must be nonzero")


def write_clips(tmp: Path, views, seed: int = 0):
    """Synthetic uint8 clips, one (1, H, W, T) NIfTI file per view."""
    import numpy as np

    from glfusion_tpu_torch.data.nifti import write_nifti

    rs = np.random.RandomState(seed)
    clips = []
    for cid, hw, t in CLIPS:
        yy, xx = np.mgrid[:hw, :hw]
        paths = {}
        for v in views:
            # a bright blob drifting over noise, so the masks vary
            cy, cx = rs.uniform(0.3, 0.7, 2) * hw
            frames = []
            for f in range(t):
                r2 = (yy - cy - f * 0.3) ** 2 + (xx - cx) ** 2
                img = 200 * np.exp(-r2 / (2 * (hw / 8) ** 2))
                frames.append(img + rs.uniform(0, 55, (hw, hw)))
            vol = np.stack(frames, -1)[None].astype(np.uint8)
            p = tmp / f"{cid}_v{v}.nii.gz"
            write_nifti(p, vol)
            paths[v] = str(p)
        clips.append((cid, paths))
    return clips


def serve_phase(torch):
    """Serving (``ClipPipeline``, then ``http`` and ``export`` on the same
    model and clips); returns K1's launches on these paths."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        return _serve(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _serve(torch, tmp: Path):
    import numpy as np

    from glfusion_tpu_torch.config import Config
    from glfusion_tpu_torch.models import GlobalAndLocal
    from glfusion_tpu_torch.ops.tpavi_fused import fused_dot_nonlocal
    from glfusion_tpu_torch.serve import ClipPipeline

    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                use_pallas_fusion=True))
    model = GlobalAndLocal(cfg.model)
    randomize_(torch, model, seed=0)
    pipe = ClipPipeline(cfg, model, depth=2, threads=2)  # default device: cuda
    check(pipe.device.type == "cuda", f"pipeline on {pipe.device}")
    views = list(cfg.model.views)

    clips = write_clips(tmp, views)
    t0 = time.perf_counter()
    decoded = {cid: pipe.decode_paths((cid, paths))[1]
               for cid, paths in clips}
    decode_s = time.perf_counter() - t0  # all clips, one thread
    # warm-up at both spatial sizes (cuDNN picks its algorithms)
    for hw in sorted({hw for _, hw, _ in CLIPS}):
        pipe.predict_one(np.zeros(
            (len(views), cfg.data.clip_length, hw, hw, 1), np.float32))
    torch.cuda.synchronize()

    # ---- the main path, counted; the frames each forward ran
    ran = []
    hook = model.register_forward_pre_hook(
        lambda mod, args: ran.append(args[0].shape[1]))
    torch.cuda.reset_peak_memory_stats()
    fused_dot_nonlocal.launches = 0
    t0 = time.perf_counter()
    served, yield_s = [], []
    for item in pipe.predict_paths(clips):
        served.append(item)
        yield_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_dot_nonlocal.launches
    peak = torch.cuda.max_memory_allocated()
    hook.remove()

    check(ran == [t for _, _, t in CLIPS],
          f"forwards ran {ran} frames, not the clips' true lengths")
    check([cid for cid, _ in served] == [cid for cid, _, _ in CLIPS],
          "clip order")
    frames = 0
    for (cid, masks), (_, hw, t) in zip(served, CLIPS):
        check(masks.dtype == np.uint8
              and masks.shape == (len(views), t, hw, hw, cfg.model.num_classes),
              f"{cid}: masks {masks.dtype} {masks.shape}")
        check(set(np.unique(masks)) <= {0, 1}, f"{cid}: mask values")
        frames += t
    check(launches == 2 * len(CLIPS),
          f"kernel launches {launches} != 2 per clip x {len(CLIPS)}")

    # ---- timing and agreement (launches here are not counted)
    images, _ = pipe._trim_clip(decoded["c0"])
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: model(x), reps=3, warmup=1)
        x160 = torch.from_numpy(pipe._trim_clip(decoded["c3"])[0]).cuda()
        fwd_ms_160 = time_ms(torch, lambda: model(x160), reps=1, warmup=0)
        del x160
        t0 = time.perf_counter()
        host, event = pipe._enqueue(images)
        t1 = time.perf_counter()
        pipe._fetch(host, event, CLIPS[0][2])
        stages = {"enqueue": t1 - t0, "wait_and_fetch":
                  time.perf_counter() - t1}  # host seconds, one clip
    re_cfg = dataclasses.replace(cfg.model, use_pallas_fusion=False)
    model_re = GlobalAndLocal(re_cfg)
    model_re.load_state_dict(model.state_dict())
    model_re = model_re.cuda().eval()
    # the first 112² clip and the 160² clip, whose kernel calls see
    # N = 2352 and N = 4800 on the eval path's strided operands
    agreement = {}
    for i in (0, 3):
        cid, _, t_true = CLIPS[i]
        agreement[cid] = clip_agreement(
            torch, model, model_re, pipe._trim_clip(decoded[cid])[0],
            served[i][1], t_true)
    with torch.inference_mode():
        x27 = torch.from_numpy(pipe._trim_clip(decoded["c2"])[0]).cuda()
        fwd_ms_27 = time_ms(torch, lambda: model(x27), reps=3, warmup=1)
        del x27
        profile_phase(torch, lambda: model(x))
    emit("serve", clips=len(served), frames=frames, wall_s=wall,
         clips_per_s=len(served) / wall, frames_per_s=frames / wall,
         view_frames_per_s=frames * len(views) / wall,
         yield_s=yield_s, decode_s_all_clips=decode_s,
         enqueue_stage_s=stages,
         forward_ms_median_112=fwd_ms, forward_ms_160=fwd_ms_160,
         forward_ms_27_frames=fwd_ms_27, true_length=True,
         max_memory_allocated=peak,
         kernel_launches=launches, agreement=agreement)
    masks = dict(served)
    return (launches + http_phase(torch, pipe, clips, masks)
            + export_phase(torch, cfg, model, decoded, masks))


def clip_agreement(torch, model, model_re, images, served_masks,
                   t_true: int) -> dict:
    """One clip through the kernel path, the naive order (plain torch) and
    the reassociated model: f4 within 1e-4 of the naive order, mask logits
    within 1e-3 of the reassociated order, uint8 masks (direct and served)
    differing only where |logit| is within that error."""
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        out_k = model(x)
        for attn in (model.global_attn, model.local_attn):
            attn.attn_impl = "naive"
        out_n = model(x)
        for attn in (model.global_attn, model.local_attn):
            attn.attn_impl = "pallas"
        out_r = model_re(x)
    for k, v in out_k.items():
        check(bool(torch.isfinite(v).all()), f"{k} not finite")
    f4_err = {}
    for k in ("f4_global", "f4_local"):
        f4_err[k] = ((out_k[k] - out_n[k]).abs().max()
                     / out_n[k].abs().max()).item()
        check(f4_err[k] <= 1e-4,
              f"{k}: kernel vs naive relative error {f4_err[k]}")
    logit_k, logit_r = out_k["mask"], out_r["mask"]
    mask_abs = (logit_k - logit_r).abs().max().item()
    mask_rel = mask_abs / logit_r.abs().max().item()
    check(mask_rel <= 1e-3, f"mask vs reassoc relative error {mask_rel}")
    differ = (logit_k > 0) != (logit_r > 0)
    check(bool((logit_k[differ].abs() <= mask_abs).all()),
          "uint8 masks differ at a pixel whose |logit| exceeds the error")
    served_t = torch.from_numpy(served_masks).cuda().bool()
    differ_pipe = (logit_k[:, :t_true] > 0) != served_t
    pipe_logit_max = float(logit_k[:, :t_true][differ_pipe].abs().max()) \
        if bool(differ_pipe.any()) else 0.0
    check(pipe_logit_max <= mask_abs,
          f"pipeline masks differ from the direct forward at |logit| "
          f"{pipe_logit_max} > {mask_abs}")
    return {"f4_rel_err_vs_naive": f4_err,
            "mask_rel_err_vs_reassoc": mask_rel,
            "mask_abs_err_vs_reassoc": mask_abs,
            "mask_pixels_differing": int(differ.sum()),
            "mask_foreground": float((logit_k > 0).float().mean()),
            "pipeline_pixels_differing": int(differ_pipe.sum()),
            "pipeline_differing_max_logit": pipe_logit_max}


def _http(port: int, path: str, body=None):
    """(status, JSON) of one request to the endpoint on 127.0.0.1."""
    import urllib.error
    import urllib.request

    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_phase(torch, pipe, clips, served) -> int:
    """The serve phase's pipeline behind ``http_serve.make_http_server`` on
    127.0.0.1 (a free port): ``/healthz``, then ``/predict`` with each
    clip's NIfTI files; every view's masks must equal ``ClipPipeline``'s
    bit for bit, and a malformed body must give 400. Returns K1's
    launches."""
    import base64
    import threading

    import numpy as np

    from glfusion_tpu_torch.data.nifti import parse_nifti_bytes
    from glfusion_tpu_torch.http_serve import make_http_server
    from glfusion_tpu_torch.ops.tpavi_fused import fused_dot_nonlocal

    views = list(pipe.cfg.model.views)
    server = make_http_server(pipe, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        code, health = _http(port, "/healthz")
        check(code == 200 and health["status"] == "ok"
              and health["views"] == views, f"/healthz {code} {health}")
        bodies = [{"views": {v: base64.b64encode(Path(p).read_bytes())
                             .decode() for v, p in paths.items()}}
                  for _, paths in clips]
        fused_dot_nonlocal.launches = 0
        latency = []
        for (cid, _), body in zip(clips, bodies):
            t0 = time.perf_counter()
            code, resp = _http(port, "/predict", body)
            latency.append(time.perf_counter() - t0)
            check(code == 200, f"/predict {cid}: {code} {resp}")
            want = served[cid]
            check(resp["frames"] == want.shape[1], f"{cid}: frames")
            for vi, v in enumerate(views):
                got = parse_nifti_bytes(base64.b64decode(resp["masks"][v]))
                check(np.array_equal(np.transpose(got, (3, 1, 2, 0)),
                                     want[vi]),
                      f"{cid} view {v}: endpoint masks differ from "
                      f"ClipPipeline's")
        launches = fused_dot_nonlocal.launches
        check(launches == 2 * len(clips), f"http: K1 launched {launches}")
        code, resp = _http(port, "/predict", b"not json")
        check(code == 400 and resp.get("error"), f"malformed body: {code}")
    finally:
        server.shutdown()
        server.server_close()
    emit("http", requests=len(clips), latency_s=latency,
         latency_s_median=statistics.median(latency),
         frames=[served[cid].shape[1] for cid, _ in clips],
         kernel_launches=launches, bad_request_status=code)
    return launches


_EXPORT_LOADER = """
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from glfusion_tpu_torch.ops import tpavi_fused
from glfusion_tpu_torch.utils.model_export import load_serving_forward
import_s = time.perf_counter() - t0
t0 = time.perf_counter()
fwd, meta = load_serving_forward(sys.argv[1])
load_s = time.perf_counter() - t0
ms = {}
for name in sys.argv[3:]:
    x = np.load(f"{sys.argv[2]}/{name}.npy")
    t0 = time.perf_counter()
    y = fwd(x).cpu().numpy()  # the copy waits for the forward
    ms[name] = (time.perf_counter() - t0) * 1e3
    np.save(f"{sys.argv[2]}/{name}.out.npy", y)
print(json.dumps({
    "import_s": import_s, "load_s": load_s, "forward_ms_first": ms,
    "launches": tpavi_fused.fused_dot_nonlocal.launches,
    "models_imported": sorted(m for m in sys.modules
                              if m.startswith("glfusion_tpu_torch.models")),
    "device": meta["device"]}))
"""


def export_phase(torch, cfg, model, decoded, served) -> int:
    """The serve phase's model exported with ``torch.export`` (K1 as the
    registered op) on the card and saved; a subprocess that imports only
    the kernel's op and ``utils/model_export.py`` loads it and runs the
    27- and 40-frame clips, whose masks must equal the live path's bit
    for bit. Returns K1's launches in the loaded program."""
    import numpy as np

    from glfusion_tpu_torch.utils.model_export import (export_serving_forward,
                                                       save_exported)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_export_"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep = export_serving_forward(cfg, model)
        export_s = time.perf_counter() - t0
        k1_nodes = sum(1 for n in ep.graph.nodes
                       if "fused_dot_nonlocal" in str(n.target))
        check(k1_nodes == 2, f"export: {k1_nodes} K1 nodes in the graph")
        t0 = time.perf_counter()
        meta = save_exported(ep, str(tmp / "exp"), cfg)
        save_s = time.perf_counter() - t0
        del ep
        names = ["c2", "c0"]  # 27 and 40 frames, 112²
        for name in names:
            np.save(tmp / f"{name}.npy", decoded[name])
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", _EXPORT_LOADER, str(tmp / "exp"),
             str(tmp), *names], cwd=ROOT, capture_output=True, text=True,
            timeout=900, env={**os.environ, "PYTHONPATH": str(ROOT)})
        process_s = time.perf_counter() - t0
        check(res.returncode == 0, f"export loader failed:\n"
              f"{res.stderr[-3000:]}")
        info = json.loads(res.stdout.strip().splitlines()[-1])
        check(info["models_imported"] == [],
              f"the loader imported {info['models_imported']}")
        check(info["launches"] == 2 * len(names),
              f"the loaded program launched K1 {info['launches']} times")
        equal = {}
        for name in names:
            got = np.load(tmp / f"{name}.out.npy")
            want = served[name]
            equal[name] = bool(got.shape == want.shape
                               and np.array_equal(got, want))
            check(equal[name], f"export {name}: masks differ from the live "
                  f"path's ({int((got != want).sum())} of {want.size})")
        emit("export", export_s=export_s, save_s=save_s,
             artifact_bytes=meta["serialized_bytes"],
             loader_process_s=process_s, **info,
             frames={n: decoded[n].shape[1] for n in names},
             bitwise_equal=equal, meta=meta)
        return info["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _category(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("ffma_gemm", "wgmma_gemm")):
        return "tpavi_kernel"
    if any(k in low for k in ("stats_kernel", "norm_pool_kernel",
                              "bwd1_kernel", "bwd2_kernel",
                              "dx_reduce_kernel")):
        return "stem_kernels"
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad", "implicit",
                              "winograd", "cudnn")):
        return "convolution"
    if "gemm" in low or "cutlass" in low:
        return "matmul"
    return "other"


def profile_phase(torch, fn, phase: str = "profile") -> dict:
    """Where one call of ``fn``'s device time goes (torch.profiler): device
    ms by category, the idle share of the wall, the top kernels. ``fn`` is
    run once before, untraced."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat: dict = {}
    for e in kernels:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    device_ms = sum(by_cat.values())
    check(device_ms > 0, f"{phase}: the profiler saw no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    rec = dict(wall_ms=wall_ms, device_ms=device_ms,
               idle_share=max(0.0, 1 - device_ms / wall_ms),
               device_ms_by_category=by_cat,
               top_kernels=[{"name": e.key[:100],
                             "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in top])
    emit(phase, **rec)
    return rec


def rel_max(a, ref) -> float:
    """max|a − ref| / max|ref| in float32."""
    a, ref = a.float(), ref.float()
    return ((a - ref).abs().max() / ref.abs().max()).item()


def rel_norm(a, ref) -> float:
    """‖a − ref‖ / ‖ref‖ in float32 (0 when both are 0)."""
    a, ref = a.float(), ref.float()
    den = ref.norm().item()
    num = (a - ref).norm().item()
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def kernel_backward_phase(torch) -> dict:
    """The TPAVI kernel's autograd backward (the reassociated products of
    ``_FusedDotNonlocal.backward``) against autograd of the plain naive
    chain, at the train step's shapes, float32."""
    from glfusion_tpu_torch.ops.tpavi_fused import (fused_dot_nonlocal,
                                                    fused_dot_nonlocal_plain)

    gen = torch.Generator(device="cuda").manual_seed(2)
    records = {}
    for b, n, c in K1_TRAIN_SHAPES:
        ops = [torch.randn(b, n, c, device="cuda", generator=gen)
               .requires_grad_(True) for _ in range(3)]
        dy = torch.randn(b, n, c, device="cuda", generator=gen)
        got = torch.autograd.grad(fused_dot_nonlocal(*ops), ops, dy)
        want = torch.autograd.grad(fused_dot_nonlocal_plain(*ops), ops, dy)
        torch.cuda.synchronize()
        errs = {name: rel_max(g, w) for name, g, w in
                zip(("dtheta", "dphi", "dg"), got, want)}
        for name, e in errs.items():
            check(e <= K1_GRAD_TOL, f"K1 backward {(b, n, c)} {name}: "
                  f"relative error {e} > {K1_GRAD_TOL}")
        y = fused_dot_nonlocal(*ops)
        bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            y, ops, dy, retain_graph=True), reps=5, warmup=1)
        rec = {"shape": [b, n, c], "dtype": "float32", "rel_err": errs,
               "tol": K1_GRAD_TOL, "backward_ms": bwd_ms}
        records[(b, n, c)] = rec
        emit("kernel_backward", **rec)
        del ops, dy, got, want, y
        torch.cuda.empty_cache()
    return records


def _stem_inputs(torch, gen, b, dt):
    c = STEM_C
    x = torch.rand(b, 1, STEM_HW, STEM_HW, device="cuda",
                   generator=gen).to(dt)
    w = torch.randn(c, 1, 7, 7, device="cuda", generator=gen) * 0.2
    bias = torch.randn(c, device="cuda", generator=gen) * 0.1
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    beta = torch.randn(c, device="cuda", generator=gen) * 0.1
    return [x, w, bias, gamma, beta]


def stem_check(torch, inputs, dy, tol) -> dict:
    """The four kernels (through ``fused_stem_train`` and its backward, and
    ``fused_stem_eval``) against the plain stem on the same inputs."""
    from glfusion_tpu_torch.experiments.stem_fused import (
        fused_stem_eval, fused_stem_eval_plain, fused_stem_train,
        fused_stem_train_plain)

    ins_k = [t.detach().clone().requires_grad_(True) for t in inputs]
    ins_p = [t.detach().clone().requires_grad_(True) for t in inputs]
    out, mean, var = fused_stem_train(*ins_k)
    out_p, mean_p, var_p = fused_stem_train_plain(*ins_p)
    check(out.dtype == inputs[0].dtype and out.shape == out_p.shape
          and out.is_contiguous(), f"stem output {out.dtype} "
          f"{tuple(out.shape)}")
    (out.float() * dy.float()).sum().backward()
    (out_p.float() * dy.float()).sum().backward()
    ev = fused_stem_eval(inputs[0], *inputs[1:], mean_p, var_p)
    ev_p = fused_stem_eval_plain(inputs[0], *inputs[1:], mean_p, var_p)
    torch.cuda.synchronize()
    err = {"out": rel_max(out, out_p), "mean": rel_max(mean, mean_p),
           "var": rel_max(var, var_p), "eval_out": rel_max(ev, ev_p),
           "max_abs_out": (out.float() - out_p.float()).abs().max().item()}
    for name, a, p in zip(("x", "weight", "bias", "gamma", "beta"), ins_k,
                          ins_p):
        err["d" + name] = rel_norm(a.grad, p.grad)
        err["max_abs_d" + name] = (a.grad.float() - p.grad.float()).abs() \
            .max().item()
    err["max_abs_stats"] = max((mean - mean_p).abs().max().item(),
                               (var - var_p).abs().max().item())
    # train BN cancels the conv-bias gradient to noise: held against the
    # scale of the weight gradient instead
    err["dbias_abs_over_dweight"] = ((ins_k[2].grad - ins_p[2].grad).norm()
                                     / ins_p[1].grad.norm()).item()
    limits = {"out": tol["out"], "eval_out": tol["out"], "mean": tol["stat"],
              "var": tol["stat"], "dx": tol["grad"], "dweight": tol["grad"],
              "dgamma": tol["grad"], "dbeta": tol["grad"],
              "dbias_abs_over_dweight": tol["grad"]}
    for k, lim in limits.items():
        check(math.isfinite(err[k]) and err[k] <= lim,
              f"stem {k}: error {err[k]} > {lim}")
    return err


def same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(-1).view(torch.uint8),
                            b.contiguous().view(-1).view(torch.uint8)))


def stem_determinism(torch, inputs, dy, chan) -> dict:
    """Two runs on the same inputs: ``stem_bwd2`` with its reduce pass (dx,
    and dW, db summed over the blocks), and the fused stem's whole backward
    (all five gradients). Each pair must have the same bits."""
    from glfusion_tpu_torch.experiments.stem_fused import (
        fused_stem_train, stem_bwd2, stem_dx_reduce)

    x, w = inputs[0], inputs[1]
    w49 = w.reshape(STEM_C, 49).contiguous()

    def kernels():
        dwp, dbp, dxp = stem_bwd2(x, w49, chan, dy)
        return stem_dx_reduce(dxp, STEM_HW), dwp.sum((0, 1)), dbp.sum((0, 1))

    def backward():
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fused_stem_train(*ins)[0], ins, dy)

    res = {}
    for name, fn in (("stem_bwd2", kernels), ("fused_stem_backward",
                                                backward)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        res[name] = all(same_bits(torch, u, v)
                        for u, v in zip(first, second))
    check(all(res.values()), f"stem: two runs differ: {res}")
    return res


def bwd2_partials_error(torch, x, w49, chan, dy, dwp, dbp, dxp) -> dict:
    """``stem_bwd2``'s own partials (dwp, dbp, dxp) against its plain
    version on the same inputs, in relative norm: dW, db, and the dx
    partials' rows inside the image (the kernel leaves the others
    unwritten)."""
    from glfusion_tpu_torch.experiments.stem_fused import (dx_slab_rows,
                                                           stem_bwd2_plain)

    pw, pb, px = stem_bwd2_plain(x, w49, chan, dy)
    inside = []
    for s in range(dxp.shape[1]):
        first, rows = dx_slab_rows(s, x.shape[2])
        inside.append((s, slice(rows.start - first, rows.stop - first)))
    dx_k, dx_p = (torch.cat([t[:, s, :, rows].flatten() for s, rows in inside])
                  for t in (dxp, px))
    return {"bwd2_dwp": rel_norm(dwp, pw), "bwd2_dbp": rel_norm(dbp, pb),
            "bwd2_dxp": rel_norm(dx_k, dx_p),
            "max_abs_bwd2": max((u - v).abs().max().item() for u, v in
                                ((dwp, pw), (dbp, pb), (dx_k, dx_p)))}


def stem_phase(torch) -> dict:
    import torch.nn.functional as F

    from glfusion_tpu_torch.experiments.stem_fused import (
        _chan, batch_moments, dx_slab_rows, fused_stem_eval,
        fused_stem_eval_plain, fused_stem_train, fused_stem_train_plain,
        geometry, stem_bwd1, stem_bwd2,
        stem_bwd2_plain, stem_dx_reduce, stem_dx_reduce_plain, stem_norm_pool,
        stem_stats)

    gen = torch.Generator(device="cuda").manual_seed(3)
    records = {}
    for b in STEM_BATCHES:
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            inputs = _stem_inputs(torch, gen, b, dt)
            hc, wc, hp, wp, slabs = geometry(STEM_HW, STEM_HW)
            dy = torch.randn(b, STEM_C, hp, wp, device="cuda",
                             generator=gen).to(dt)
            # each kernel alone, and the plain composites
            x, w, bias, gamma, beta = inputs
            w49 = w.reshape(STEM_C, 49).contiguous()
            mean, var = batch_moments(stem_stats(x, w49, _chan(
                STEM_C, x.device, bias)))
            inv = torch.rsqrt(var + 1e-5)
            a = gamma * inv
            chan = _chan(STEM_C, x.device, bias, a, beta, mean, inv)
            part = stem_bwd1(x, w49, chan, dy)
            n = b * hc * wc
            chan = _chan(STEM_C, x.device, bias, a, beta, mean, inv,
                         part[0].sum((0, 1)) / n, part[1].sum((0, 1)) / n)
            # K2d's own partials first, so that a fault in its dW or its
            # dx shows apart, before the whole stem's check
            dwp, dbp, dxp = stem_bwd2(x, w49, chan, dy)
            bwd2_err = bwd2_partials_error(torch, x, w49, chan, dy, dwp, dbp,
                                           dxp)
            limit = STEM_TOL[dt_name]["grad"]
            check(all(math.isfinite(bwd2_err[k]) and bwd2_err[k] <= limit
                      for k in ("bwd2_dwp", "bwd2_dbp", "bwd2_dxp")),
                  f"stem_bwd2 B = {b} {dt_name}: partials against its plain "
                  f"version {bwd2_err}, limit {limit}")
            err = stem_check(torch, inputs, dy, STEM_TOL[dt_name])
            err.update(bwd2_err)
            deterministic = stem_determinism(torch, inputs, dy, chan)
            dx = stem_dx_reduce(dxp, STEM_HW)
            dx_plain = stem_dx_reduce_plain(dxp, STEM_HW)
            torch.cuda.synchronize()
            err["max_abs_dx_reduce"] = (dx - dx_plain).abs().max().item()
            check(err["max_abs_dx_reduce"] == 0.0, "stem_dx_reduce: "
                  f"{err['max_abs_dx_reduce']} from its plain version")
            ms = {
                "stem_stats": time_ms(torch, lambda: stem_stats(x, w49, chan)),
                "stem_norm_pool": time_ms(
                    torch, lambda: stem_norm_pool(x, w49, chan)),
                "stem_bwd1": time_ms(torch, lambda: stem_bwd1(x, w49, chan,
                                                              dy)),
                "stem_bwd2": time_ms(torch, lambda: stem_bwd2(x, w49, chan,
                                                              dy)),
                "stem_dx_reduce": time_ms(
                    torch, lambda: stem_dx_reduce(dxp, STEM_HW)),
            }
            ins_p = [t.detach().clone().requires_grad_(True) for t in inputs]
            out_p = fused_stem_train_plain(*ins_p)[0]
            bwd_plain = time_ms(torch, lambda: torch.autograd.grad(
                out_p, ins_p, dy, retain_graph=True))
            plain_ms = {
                "stem_stats": time_ms(torch, lambda: torch.var_mean(
                    F.conv2d(x.float(), w, bias, padding=2), dim=(0, 2, 3),
                    unbiased=False)),
                "stem_norm_pool": time_ms(torch, lambda: fused_stem_eval_plain(
                    x, w, bias, gamma, beta, mean, var)),
                # the plain backward runs as one autograd graph: its time
                # stands beside stem_bwd1, which has no plain version alone
                "stem_bwd1": bwd_plain,
                "stem_bwd2": time_ms(torch, lambda: stem_bwd2_plain(
                    x, w49, chan, dy)),
                "stem_dx_reduce": time_ms(
                    torch, lambda: stem_dx_reduce_plain(dxp, STEM_HW)),
            }
            conv = 2 * b * hc * wc * STEM_C * 49
            isz = x.element_size()
            x_bytes, out_bytes = b * STEM_HW * STEM_HW * isz, \
                b * STEM_C * hp * wp * isz
            part = b * slabs * STEM_C * 4
            dx_bytes = b * STEM_HW * STEM_HW * 4
            # the partials the reduce pass reads: each slab's rows inside
            # the image, for every channel chunk; one add each
            partials = b * (STEM_C // 8) * STEM_HW * sum(
                len(dx_slab_rows(s, STEM_HW)[1]) for s in range(slabs))
            work = {  # (FLOP, bytes) the function of each kernel needs
                "stem_stats": (conv, x_bytes + 3 * part),
                "stem_norm_pool": (conv, x_bytes + out_bytes),
                "stem_bwd1": (conv, x_bytes + out_bytes + 2 * part),
                # z (for x̂ and the routing), dW and dx: three conv products
                "stem_bwd2": (3 * conv, x_bytes + out_bytes + dx_bytes
                              + part * 50),
                "stem_dx_reduce": (partials, 4 * partials + dx_bytes),
            }
            bound = {}
            for k, (flop, nbytes) in work.items():
                t_ops = flop / PEAK_FLOPS["float32"] * 1e3
                t_bytes = nbytes / PEAK_BYTES * 1e3
                bound[k] = (max(t_ops, t_bytes),
                            "operations" if t_ops >= t_bytes else "bytes")
            rec = {"batch": b, "dtype": dt_name, "hw": STEM_HW, "c": STEM_C,
                   "err": err, "tol": STEM_TOL[dt_name],
                   "deterministic": deterministic, "ms": ms,
                   "plain_ms": plain_ms,
                   "bound_ms": {k: v[0] for k, v in bound.items()},
                   "bound_by": {k: v[1] for k, v in bound.items()}}
            records[(b, dt_name)] = rec
            emit("stem", **rec)
            del inputs, dy, ins_p, out_p, dwp, dbp, dxp, dx, dx_plain
            torch.cuda.empty_cache()

    # per view, each with its own weights, as the flagship runs it: three
    # FusedIEKDStem modules, each held against the plain stem
    per_view = {}
    for v in ("1", "3", "4"):
        inputs = _stem_inputs(torch, gen, STEM_BATCHES[0], torch.float32)
        dy = torch.randn(STEM_BATCHES[0], STEM_C, 55, 55, device="cuda",
                         generator=gen)
        per_view[v] = stem_check(torch, inputs, dy, STEM_TOL["float32"])
    # a NaN pixel: the kernels' forward keeps it, as the plain stem does
    # (torch's relu and max_pool2d, JAX's maximum), in eval and in train
    x, w, bias, gamma, beta = inputs
    x = x.clone()
    x[0, 0, 40, 40] = float("nan")
    mean, var = x.new_zeros(STEM_C), x.new_ones(STEM_C)
    nan = {}
    for mode, got, want in (
            ("eval", fused_stem_eval(x, w, bias, gamma, beta, mean, var),
             fused_stem_eval_plain(x, w, bias, gamma, beta, mean, var)),
            ("train", fused_stem_train(x, w, bias, gamma, beta)[0],
             fused_stem_train_plain(x, w, bias, gamma, beta)[0])):
        nan[mode] = (int(torch.isnan(got).sum()),
                     int(torch.isnan(want).sum()))
        # every NaN of the kernels' where the plain stem has one (cuDNN's
        # algorithm may spread it further)
        check(nan[mode][0] > 0 and bool((torch.isnan(got)
                                         <= torch.isnan(want)).all()),
              f"stem {mode}: NaN outputs (kernels, plain) {nan[mode]}")
    emit("stem_per_view", views=per_view, nan_outputs=nan)
    return records


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _second_stem_classes(torch):
    """(PlainFusedStem, TapwiseStem, ReversedTapwiseStem): the plain
    paths' stems."""
    nn, F = torch.nn, torch.nn.functional
    from glfusion_tpu_torch.experiments import stem_fused, stem_module

    class PlainFusedStem(stem_module.FusedIEKDStem):
        """``FusedIEKDStem`` through the kernels' plain versions: the same
        arithmetic (x in its type, float32 weights and z) on cuDNN."""

        def forward(self, x):
            kernels = (stem_module.fused_stem_train,
                       stem_module.fused_stem_eval)
            stem_module.fused_stem_train = stem_fused.fused_stem_train_plain
            stem_module.fused_stem_eval = stem_fused.fused_stem_eval_plain
            try:
                return super().forward(x)
            finally:
                (stem_module.fused_stem_train,
                 stem_module.fused_stem_eval) = kernels

    class TapwiseStem(nn.Sequential):
        """The plain IEKD stem with its conv summed tap by tap (49
        multiply-adds, another order than cuDNN's, first to last or last
        to first) in float32: a second plain path."""

        reverse = False

        def __init__(self, c):
            super().__init__(nn.Conv2d(1, c, 7, padding=2),
                             nn.BatchNorm2d(c))

        def forward(self, x):
            conv, bn = self[0], self[1]
            h, w = x.shape[2] - 2, x.shape[3] - 2
            xp = F.pad(x.float(), (2, 2, 2, 2))
            z = conv.bias.view(1, -1, 1, 1).expand(x.shape[0], -1, h, w)
            taps = [(i, j) for i in range(7) for j in range(7)]
            for i, j in reversed(taps) if self.reverse else taps:
                z = torch.addcmul(z, conv.weight[:, 0, i, j].view(
                    1, -1, 1, 1), xp[:, :, i:i + h, j:j + w])
            return F.max_pool2d(F.relu(bn(z)), 3, 2, 1)

    class ReversedTapwiseStem(TapwiseStem):
        reverse = True

    return PlainFusedStem, TapwiseStem, ReversedTapwiseStem


def plain_attention(theta, phi, g, *, impl: str = "auto"):
    """The plain paths' attention: ``ops/nonlocal_attn.py``'s orders, but
    "naive" only where its N×N map is small (N ≤ NAIVE_MAX_N); above, the
    reassociated chain in float64, rounded once to float32 (another
    rounding of the same function). ``temporal``'s N = 94 080 would need a
    35 GB map. ``hilo``: the bfloat16 kernel's own rounding in plain
    products, its float32 intermediate kept as a bfloat16 hi/lo pair (hi
    = bf16(M), lo = bf16(M − hi); M = φᵀg, or θφᵀ where N ≤ C') and the
    two halves contracted into one float32 sum: the one rounding of K1's
    that no other plain path carries (about 2⁻¹⁷ of M, then flips of y's
    bfloat16 rounding)."""
    import torch

    from glfusion_tpu_torch.ops.nonlocal_attn import dot_nonlocal_attention

    n = theta.shape[-2]
    if impl == "hilo":
        f32, bf16 = torch.float32, torch.bfloat16
        t, p, gg = (x.to(f32) for x in (theta, phi, g))

        def hilo(m):  # (B, R, C) float32 → (B, R, 2C): [hi ‖ lo]
            hi = m.to(bf16)
            return torch.cat([hi, (m - hi.to(f32)).to(bf16)], -1).to(f32)

        if n > theta.shape[-1]:  # θ(φᵀg): M's rows are φ's channels
            m = hilo(torch.bmm(p.transpose(1, 2), gg).transpose(1, 2))
            return torch.bmm(torch.cat([t, t], -1), m.transpose(1, 2)) / n
        s = hilo(torch.bmm(t, p.transpose(1, 2)))  # (θφᵀ)g
        return torch.bmm(s, torch.cat([gg, gg], 1)) / n
    if impl != "naive" or n <= NAIVE_MAX_N:
        return dot_nonlocal_attention(theta, phi, g, impl=impl)
    t, p, gg = (x.double() for x in (theta, phi, g))
    return (torch.bmm(t, torch.bmm(p.transpose(1, 2), gg)) / n).float()


@contextlib.contextmanager
def exact_bias_sums(torch, model):
    """Within: for each conv of ``model`` computing in bfloat16 whose bias
    has fewer than ``EXACT_BIAS_ELEMENTS`` elements, the float64 sum of
    its output's cotangent over every call with a gradient (the bias
    gradient before autograd rounds it): ``{"<module>.bias": (C,)
    float64}``, filled by the backward."""
    sums, patched = {}, []
    for name, m in model.named_modules():
        if not (isinstance(m, torch.nn.modules.conv._ConvNd)
                and getattr(m, "compute_dtype", None) == torch.bfloat16
                and m.bias is not None
                and m.bias.numel() < EXACT_BIAS_ELEMENTS):
            continue

        def forward(x, m=m, key=f"{name}.bias"):
            y = type(m).forward(m, x)
            if y.requires_grad:
                dims = [0] + list(range(2, y.dim()))

                def add(dy):
                    s = dy.double().sum(dims)
                    sums[key] = sums[key] + s if key in sums else s
                y.register_hook(add)
            return y
        m.forward = forward
        patched.append(m)
    try:
        yield sums
    finally:
        for m in patched:
            del m.forward


def _step_run(torch, cfg, trainer, model, batch, impl, sample=0):
    """One train step of ``model`` (SGD at lr 0: the weights stay) under
    the generator and dropout seed of (epoch 1, step ``sample``); the
    attention in ``impl``. Returns (metrics, gradients); in bfloat16 the
    heads' last conv biases are read as ``exact_bias_sums``, their rounded
    gradients kept in the metrics' ``rounded_grads``."""
    from glfusion_tpu_torch.models import tpavi as tpavi_mod
    from glfusion_tpu_torch.train.step import make_train_step

    for attn in (model.global_attn, model.local_attn):
        attn.attn_impl = impl
    model.zero_grad(set_to_none=True)
    step = make_train_step(cfg, model,
                           torch.optim.SGD(model.parameters(), lr=0.0))
    saved = tpavi_mod.dot_nonlocal_attention
    tpavi_mod.dot_nonlocal_attention = plain_attention
    try:
        # the same step's generator and dropout seed for every path
        with exact_bias_sums(torch, model) as sums, \
                trainer.step_randomness(1, sample) as gen:
            metrics = step(batch, gen)
        torch.cuda.synchronize()
    finally:
        tpavi_mod.dot_nonlocal_attention = saved
    metrics = {k: float(v.sum()) for k, v in metrics.items()}
    grads = _grads(model)
    if sums:
        metrics["rounded_grads"] = {n: grads[n] for n in sums}
        grads.update(sums)
    return metrics, grads


def check_state(torch, model) -> dict:
    """The checked state: a copy of ``model``'s weights and statistics, in
    host memory (so that it takes no room on the card while the main path
    runs), with both TPAVI W_z BNs given a nonzero scale from a fixed seed
    (at their zero init no gradient reaches θ, φ, g); the model is left as
    it is."""
    gen = torch.Generator().manual_seed(5)
    state = {k: v.detach().to("cpu", copy=True)
             for k, v in model.state_dict().items()}
    for attn in ("global_attn", "local_attn"):
        w = state[f"{attn}.W_z.1.weight"]
        w.copy_(torch.rand(w.shape, generator=gen) * 0.5 + 0.5)
    return state


def step_paths(torch, cfg, trainer, batch, state, tol, sample=0,
               model=None, stats=False) -> list:
    """The plain path and its second paths on ``state``: ``[(metrics,
    gradients)]``, the plain path first. The plain path is the fused
    stems' plain version on cuDNN and the naive attention; the second
    paths are equal in real arithmetic and differ in rounding:
    (tap by tap, reassociated), (tap by tap last to first, naive), (the
    fused stems' plain version, reassociated), the first
    ``tol["noise_paths"]`` of them. ``model``: the flagship to run them
    in (default: a new one); ``stats``: each run also gives the BN running
    statistics after its step."""
    from glfusion_tpu_torch.models import GlobalAndLocal

    PlainFusedStem, TapwiseStem, ReversedTapwiseStem = \
        _second_stem_classes(torch)
    # in bfloat16 the last second path carries K1's hi/lo rounding
    # (``plain_attention``'s "hilo")
    paths = [(PlainFusedStem, "naive"), (TapwiseStem, "reassoc"),
             (ReversedTapwiseStem, "naive"),
             (PlainFusedStem, "hilo" if cfg.model.dtype == "bfloat16"
              else "reassoc")]
    model = (model or GlobalAndLocal(cfg.model)).cuda()
    runs = []
    for stem_cls, impl in paths[:1 + tol["noise_paths"]]:
        for v, stem in list(model.init_block.items()):
            model.init_block[v] = stem_cls(stem[0].out_channels).cuda()
        model.load_state_dict(state)
        run = _step_run(torch, cfg, trainer, model, batch, impl, sample)
        if stats:
            run += (_running(model.state_dict()),)
        runs.append(run)
    del model
    torch.cuda.empty_cache()
    return runs


@contextlib.contextmanager
def kernel_recorder(torch):
    """Within: each K1 launch is held against its plain version on its own
    operands (``k1``: (θ's shape, relative norm error)), and each fused
    stem train call's inputs and output gradient are kept for
    ``stem_replay`` (``stem``), in call order. A K1 call is launched once,
    as without the recorder, so launch counts do not move."""
    from glfusion_tpu_torch.experiments import stem_module
    from glfusion_tpu_torch.ops import tpavi_fused

    launch, stem_train = tpavi_fused._launch, stem_module.fused_stem_train
    rec = {"k1": [], "stem": []}

    def k1_recorded(theta, phi, g):
        # the kernel's own output in the step against its plain version
        y = launch(theta, phi, g)
        with torch.no_grad():
            rec["k1"].append((tuple(theta.shape), rel_norm(
                y, tpavi_fused.fused_dot_nonlocal_plain(theta, phi, g))))
        return y

    def stem_recorded(x, weight, bias, gamma, beta, axis=None):
        out, mean, var = stem_train(x, weight, bias, gamma, beta, axis)
        call = {"inputs": [t.detach().clone() for t in
                           (x, weight, bias, gamma, beta)]}
        out.register_hook(lambda dy: call.__setitem__("dy", dy.detach()
                                                      .clone()))
        rec["stem"].append(call)
        return out, mean, var

    tpavi_fused._launch = k1_recorded
    stem_module.fused_stem_train = stem_recorded
    try:
        yield rec
    finally:
        tpavi_fused._launch = launch
        stem_module.fused_stem_train = stem_train


def kernel_step(torch, cfg, trainer, batch, state, sample=0):
    """The same step through the kernels (fused stems, K1) on ``state``,
    with every kernel call of the step held against its plain version on
    the step's own tensors (``in_situ``): (metrics, gradients, in situ)."""
    trainer.model.load_state_dict(state)
    with kernel_recorder(torch) as rec:
        m_k, g_k = _step_run(torch, cfg, trainer, trainer.model, batch,
                             "pallas", sample)
    stem_err = [stem_replay(torch, r) for r in rec["stem"] if "dy" in r]
    return m_k, g_k, {"k1": rec["k1"], "stem": stem_err}


STEM_TIE = 1e-4  # normalized-activation gap below which routing is rounding's


def unambiguous_dy(torch, rec):
    """A stem call's output gradient, zero at each pool window where the
    routing is decided by rounding: the plain forward's two largest
    relu(n) in the window lie within STEM_TIE (n is the BN-normalized
    conv, of unit scale), or its largest is within STEM_TIE of the ReLU's
    kink. Exact ties are common (flat regions of 8-bit images give equal
    patches): the plain stem and its second paths break them alike, the
    kernels by their own summation order, so they would differ there by
    the size of the routed gradient. Returns (dy, the share of windows
    zeroed)."""
    F = torch.nn.functional
    x, weight, bias, gamma, beta = (t.float() for t in rec["inputs"])
    with torch.no_grad():
        z = F.conv2d(x, weight, bias, padding=2)
        var, mean = torch.var_mean(z, dim=(0, 2, 3), unbiased=False)
        c = (1, -1, 1, 1)
        n = ((z - mean.view(c)) * torch.rsqrt(var.view(c) + 1e-5)
             * gamma.view(c) + beta.view(c))
        h = F.pad(torch.relu(n), (1, 1, 1, 1), value=float("-inf"))
        win = h.unfold(2, 3, 2).unfold(3, 3, 2).flatten(-2)
        top = win.topk(2, dim=-1).values
        ambiguous = ((top[..., 0] - top[..., 1] <= STEM_TIE)
                     | (top[..., 0] <= STEM_TIE))
    dy = rec["dy"]
    check(ambiguous.shape == dy.shape, f"stem windows {ambiguous.shape} "
          f"against dy {tuple(dy.shape)}")
    return dy.masked_fill(ambiguous, 0), ambiguous.float().mean().item()


def stem_replay(torch, rec, derive=None) -> dict:
    """One stem call of a step replayed on its recorded inputs and output
    gradient: the kernels' backward (the same kernels on the same inputs:
    the step's own numbers, the stem's backward being deterministic), the
    plain stem's, and two second plain paths' (the conv tap by tap, first
    to last and last to first): per gradient, and for the conv weight also
    tap by tap (each of the 49 taps over all channels: an error in one tap
    shows there undiluted), the kernels' relative norm error against the
    plain stem and the second paths' largest (the noise). A bias gradient
    (the conv's, or a derived one) is measured against its weight
    gradient's norm, as in ``stem_check``: under the train BN it cancels.
    ``derive(dx)`` adds gradients that are functions of dx (a parameter
    upstream of the stem), measured the same way.
    The output gradient is zero at the pool windows whose routing rounding
    decides (``unambiguous_dy``), so that every path computes the same
    function."""
    from glfusion_tpu_torch.experiments.stem_fused import (
        fused_stem_train, fused_stem_train_plain)

    _, TapwiseStem, ReversedTapwiseStem = _second_stem_classes(torch)
    x, weight, bias, gamma, beta = rec["inputs"]
    dy, ambiguous = unambiguous_dy(torch, rec)
    names = ("dx", "dweight", "dbias", "dgamma", "dbeta")

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in rec["inputs"]]
        return dict(zip(names, torch.autograd.grad(fn(*ins)[0], ins, dy)))

    got, want = grads(fused_stem_train), grads(fused_stem_train_plain)
    seconds = []
    for cls in (TapwiseStem, ReversedTapwiseStem):
        m = cls(weight.shape[0]).to(weight.device).train()
        with torch.no_grad():
            for t, v in ((m[0].weight, weight), (m[0].bias, bias),
                         (m[1].weight, gamma), (m[1].bias, beta)):
                t.copy_(v)
        xx = x.clone().requires_grad_(True)
        ins = [xx, m[0].weight, m[0].bias, m[1].weight, m[1].bias]
        seconds.append(dict(zip(names, torch.autograd.grad(
            m(xx), ins, dy.float()))))

    for g in [got, want] + seconds:  # dW tap by tap too
        taps = g["dweight"].reshape(weight.shape[0], -1)
        g.update({f"dweight_tap{t}": taps[:, t]
                  for t in range(taps.shape[1])})
        if derive is not None:
            g.update(derive(g["dx"]))

    def err(g, k):
        if k.endswith("bias"):  # against its weight's gradient
            return ((g[k] - want[k]).norm()
                    / want[k[:-len("bias")] + "weight"].norm()).item()
        return rel_norm(g[k], want[k])

    keys = list(want)
    return {"batch": x.shape[0], "windows_masked": ambiguous,
            "err": {k: err(got, k) for k in keys},
            "noise": {k: max(err(g, k) for g in seconds) for k in keys}}


def in_situ_verdict(in_situ, tol) -> dict:
    """The step's kernel calls against their plain versions: each K1 call's
    output within ``tol["kernel"]`` (relative norm, the kernel phase's
    limit); each stem gradient within 10× its second paths' noise +
    ``tol["stem"]``. Unlike the whole step's gradients these carry no
    chaos from other layers (K1 has none at all; the stem has its own
    near-tied pool windows, which the second paths measure), so a small
    error in one kernel shows."""
    bad = [("k1", shape, e) for shape, e in in_situ["k1"]
           if not (math.isfinite(e) and e <= tol["kernel"])]
    ratios = [(e / tol["kernel"], ("k1", i))
              for i, (_, e) in enumerate(in_situ["k1"])]
    for i, r in enumerate(in_situ["stem"]):
        for k, e in r["err"].items():
            ratio = e / (tol["noise"] * r["noise"][k] + tol["stem"])
            ratios.append((ratio, ("stem", i, k)))
            if not (math.isfinite(ratio) and ratio <= 1):
                bad.append(("stem", i, r["batch"], k, e, r["noise"][k]))
    worst = max(ratios, default=(0.0, None), key=lambda x: x[0])
    return {"ok": not bad, "bad": bad[:5],
            "worst_ratio": worst[0], "worst_call": worst[1],
            "k1_calls": len(in_situ["k1"]),
            "k1_worst_err": max((e for _, e in in_situ["k1"]), default=0.0),
            "stem_calls": len(in_situ["stem"])}


def step_verdict(m_k, g_k, runs, tol) -> dict:
    """The kernels' step against the plain path's, each error measured
    against the second paths' own (the noise). The losses within
    ``tol["loss"]`` (relative; plus ``tol["loss_noise"]``× the noise where
    given). Each gradient tensor within ``tol["noise"]``× its noise +
    ``tol["grad"]`` in relative norm. Tensors whose gradient is noise by
    construction are measured against their module's weight gradient: a
    conv bias before a train-mode BN (the stem conv, TPAVI's W_z conv),
    whose gradient cancels, and every tensor of fewer than
    ``tol["small"]`` elements (in float32 the heads' last conv biases),
    whose relative error would rest on a handful of numbers.
    ``worst_ratio`` is the largest error over its allowance; the check
    fails above 1."""
    (m_p, g_p), seconds = runs[0], runs[1:]
    loss_err, loss_noise, bad = {}, {}, []
    for k in ("loss", "seg_loss", "cyc_loss"):
        scale = max(abs(m_p[k]), 1e-12)
        loss_err[k] = abs(m_k[k] - m_p[k]) / scale
        loss_noise[k] = max(abs(m_r[k] - m_p[k]) for m_r, _ in seconds) / scale
        allow = tol["loss"] + tol.get("loss_noise", 0) * loss_noise[k]
        if not loss_err[k] <= allow:
            bad.append((k, loss_err[k], allow))
    if not all(set(g) == set(g_p) for g in [g_k] + [g for _, g in seconds]):
        raise AssertionError("gradient sets differ")

    def reference(name):
        """The norm a tensor's error is measured against."""
        if name.endswith(".0.bias") and (name.startswith("init_block.")
                                         or ".W_z." in name):
            return g_p[name[:-len("bias")] + "weight"]
        sibling = name.rsplit(".", 1)[0] + ".weight"
        if g_p[name].numel() < tol["small"] and sibling in g_p \
                and sibling != name:
            return g_p[sibling]
        return g_p[name]

    def err(g, name):
        den = reference(name).norm().item()
        num = (g[name] - g_p[name]).norm().item()
        return num / den if den > 0 else (0.0 if num == 0 else math.inf)

    grad_err = {n: err(g_k, n) for n in g_p}
    noise = {n: max(err(g_r, n) for _, g_r in seconds) for n in g_p}
    ratio = {n: e / (tol["noise"] * noise[n] + tol["grad"])
             for n, e in grad_err.items()}
    bad += [(n, grad_err[n], noise[n]) for n in g_p
            if not (math.isfinite(grad_err[n]) and ratio[n] <= 1)]
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    return {"ok": not bad, "bad": bad[:5], "n_bad": len(bad),
            "loss_rel_err": loss_err, "loss_plain_noise": loss_noise,
            "tensors": len(grad_err),
            "grad_rel_err_max": worst[0][1],
            "grad_rel_err_worst": [(n, e, noise[n]) for n, e in worst],
            "plain_noise_max": max(noise.values()),
            "worst_ratio": max(ratio.values()),
            "worst_ratio_tensor": max(ratio, key=ratio.get),
            "grad_err": grad_err, "noise": noise, "ratio": ratio,
            "tol": tol}


def fixed_check_sample(torch, trainer, sample: int = 0):
    """(batch, state) of the step check, made before any training: the
    host batch of epoch 1 + ``sample`` under the draws of (epoch 1, step
    ``sample``), and the model's initial state (``check_state``)."""
    cfg = trainer.cfg
    host = next(trainer.train_loader.batches(cfg.train.batch_size,
                                             1 + sample))
    with trainer.step_randomness(1, sample) as gen:
        batch = trainer.train_batch(host, trainer._cycle_clips(1), gen)
    return batch, check_state(torch, trainer.model)


def step_agreement(torch, cfg, trainer, batch, tol=STEP_TOL,
                   state=None) -> dict:
    """One train step through the kernels (fused stems, TPAVI kernel)
    against the same step through the plain versions (``step_paths``):
    same weights, batch, dropout seed and generator
    (``Trainer.step_randomness``), SGD at lr 0 so the weights stay and the
    gradients are compared (``step_verdict``). ``state`` is the checked
    state (``check_state``): the float32 phases take it from the initial
    weights, made before the epoch that trains on the card, so that a
    run's verdict does not depend on which weights that epoch left (it is
    not deterministic on the card); None takes the model's current one.

    Why a noise yardstick: every path sums in its own order, and a
    rounding-level difference decides a near-tied pool window or a ReLU
    gate at zero otherwise (measured: one such window in 1.3 M moves the
    stem's dx by 8e-4 in relative norm), which train-mode BNs amplify where
    a gradient is a small difference of large sums."""
    if state is None:
        state = check_state(torch, trainer.model)
    runs = step_paths(torch, cfg, trainer, batch, state, tol)
    m_k, g_k, in_situ = kernel_step(torch, cfg, trainer, batch, state)
    res = step_verdict(m_k, g_k, runs, tol)
    situ = in_situ_verdict(in_situ, tol)
    g_p = runs[0][1]
    for attn in ("global_attn", "local_attn"):
        check(g_p[f"{attn}.theta.weight"].norm().item() > 0,
              f"{attn}: no gradient reached the attention")
    check(res["ok"], f"step: kernels vs plain beyond the plain paths' own "
          f"noise: {res['bad']}")
    check(situ["k1_calls"] > 0 and situ["stem_calls"] > 0,
          f"step: no kernel call seen in the step: {situ}")
    check(situ["ok"], f"step: a kernel call against its plain version on "
          f"the step's tensors: {situ['bad']}")
    return {**{k: v for k, v in res.items() if k not in ("grad_err",
                                                         "noise", "ratio")},
            "in_situ": situ}


def train_phase(torch) -> dict:
    """The full-width flagship trains through ``Trainer`` (the
    ``--mode train`` path), then validates."""

    from glfusion_tpu_torch.config import Config
    from glfusion_tpu_torch.experiments import stem_fused
    from glfusion_tpu_torch.experiments.stem_module import (
        FusedIEKDStem, swap_in_fused_stems)
    from glfusion_tpu_torch.models import GlobalAndLocal
    from glfusion_tpu_torch.ops.tpavi_fused import fused_dot_nonlocal
    from glfusion_tpu_torch.train.trainer import Trainer
    from glfusion_tpu_torch.utils.convert import load_checkpoint

    kernels = stem_fused.KERNELS
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    cfg = Config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, use_pallas_fusion=True),
        data=dataclasses.replace(cfg.data,
                                 synthetic_num_patients=TRAIN_PATIENTS,
                                 train_repeat=TRAIN_REPEAT),
        train=dataclasses.replace(cfg.train, num_epochs=1,
                                  eval_every_epochs=0, save_every_epochs=1,
                                  save_dir=str(tmp / "ckpt"),
                                  log_dir=str(tmp / "log")))
    torch.manual_seed(0)
    model = GlobalAndLocal(cfg.model)
    swap_in_fused_stems(model)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, model=model, verbose=False)  # default: cuda
    setup_s = time.perf_counter() - t0
    check(trainer.device.type == "cuda", f"trainer on {trainer.device}")
    check(all(isinstance(m, FusedIEKDStem)
              for m in trainer.model.init_block.values()), "stems")

    step_s = []
    inner = trainer.train_step

    first_step = []

    def timed_step(batch, gen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        first_step.append(time.perf_counter())
        return out

    trainer.train_step = timed_step
    # the step check's state and batch, fixed before the epoch that trains
    # on the card (not deterministic there)
    check_batch, state0 = fixed_check_sample(torch, trainer)
    native = decode_check(trainer.data_paths["root"])
    warm = watch_warming(trainer.train_loader)

    # ---- the main path, counted: one epoch, then the validation
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    fused_dot_nonlocal.launches = 0
    t0 = time.perf_counter()
    metrics = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = metrics["steps"]
    check("thread" in warm, "Trainer.train started no warm-up")
    warm["thread"].join(timeout=60)
    check("done" in warm, "the warm-up thread did not finish")
    native.update(warm_keys=warm["keys"],
                  warm_done_s=warm["done"] - t0,
                  first_step_done_s=first_step[0] - t0,
                  warm_done_before_first_step=warm["done"] < first_step[0])
    emit("native", **native)
    train_counts = {k.__name__: k.launches for k in kernels}
    train_counts["fused_dot_nonlocal"] = fused_dot_nonlocal.launches
    check(steps == TRAIN_PATIENTS // 2 * TRAIN_REPEAT // cfg.train.batch_size,
          f"{steps} steps")
    for k in ("loss", "seg_loss", "cyc_loss"):
        check(math.isfinite(metrics[k]) and metrics[k] > 0,
              f"train {k} = {metrics[k]}")
    views = len(cfg.model.views)
    for k in kernels:  # 3 views × 2 passes, one launch each per step
        check(train_counts[k.__name__] == 2 * views * steps,
              f"{k.__name__}: {train_counts[k.__name__]} launches in "
              f"{steps} steps")
    check(train_counts["fused_dot_nonlocal"] == 4 * steps,
          f"TPAVI kernel: {train_counts['fused_dot_nonlocal']} launches")

    for k in kernels:
        k.launches = 0
    fused_dot_nonlocal.launches = 0
    t0 = time.perf_counter()
    results = trainer.validation_and_test()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    val_counts = {k.__name__: k.launches for k in kernels}
    val_counts["fused_dot_nonlocal"] = fused_dot_nonlocal.launches
    forwards = (sum(results[s]["clips"] for s in ("Inner-val", "Inner-test"))
                + -(-len(trainer.valid_loader) // cfg.train.batch_size))
    check(val_counts["stem_norm_pool"] == views * forwards
          and val_counts["fused_dot_nonlocal"] == 2 * forwards
          and sum(val_counts[k] for k in ("stem_stats", "stem_bwd1",
                                          "stem_bwd2", "stem_dx_reduce")) == 0,
          f"validation launches {val_counts} for {forwards} forwards")
    dice = {s: {v: r["dice"] for v, r in results[s]["views"].items()}
            for s in results}
    for s in dice:
        check(all(math.isfinite(d) for d in dice[s].values()), f"{s} dice")

    # ---- the checkpoint loads back
    path = trainer.checkpoint_path(0)
    back = GlobalAndLocal(cfg.model)
    swap_in_fused_stems(back)
    back.load_state_dict(load_checkpoint(str(path)))
    saved = back.state_dict()
    for k, t in trainer.model.state_dict().items():
        check(torch.equal(saved[k], t.cpu()), f"checkpoint {k}")

    # ---- one more step profiled, then kernels against the plain versions
    host = next(trainer.train_loader.batches(cfg.train.batch_size, 1))
    with trainer.step_randomness(1, 0) as gen:
        batch = trainer.train_batch(host, trainer._cycle_clips(1), gen)
        prof = profile_phase(torch, lambda: inner(batch, gen),
                             "train_profile")
    agreement = step_agreement(torch, cfg, trainer, check_batch,
                               state=state0)
    warm = step_s[1:] or step_s
    rec = dict(
        corpus=f"synthetic, {TRAIN_PATIENTS} patients (2 train, 1 val), "
               f"train_repeat {TRAIN_REPEAT}, 10 test clips of "
               f"{cfg.data.clip_length} frames",
        reduced=["random weights (seed 0, the default init)",
                 f"one epoch of {steps} steps on the synthetic corpus"],
        setup_s=setup_s, steps=steps, step_s=step_s,
        s_per_step_median=statistics.median(warm),
        train_s=train_s, validation_s=val_s,
        max_memory_allocated=peak, loss=metrics["loss"],
        seg_loss=metrics["seg_loss"], cyc_loss=metrics["cyc_loss"],
        train_dice=metrics["dice"], validation_dice=dice,
        launches_train=train_counts, launches_validation=val_counts,
        validation_forwards=forwards,
        step_idle_share=prof["idle_share"], step_agreement=agreement,
        checkpoint=str(path.name))
    emit("train", **rec)
    return {"train": train_counts, "validation": val_counts, "steps": steps,
            "data_paths": trainer.data_paths}


def decoder_toolchain() -> dict:
    """What the native decoder's build needs: ``g++`` and zlib's header."""
    from glfusion_tpu_torch import native

    return {"gxx": native.compiler_version() or None,
            "zlib_h": Path("/usr/include/zlib.h").exists()}


def decode_check(root) -> dict:
    """The native NIfTI decoder on every file of the corpus under ``root``:
    one batched native read and the pure reader, file by file, give the
    same types and bytes; both timed. Where ``g++`` and zlib's header are
    there the decoder must have built; where not, the record says so and
    ``read_nifti`` (then the pure reader) is checked instead."""
    import numpy as np

    from glfusion_tpu_torch import native
    from glfusion_tpu_torch.data.nifti import read_nifti, read_nifti_py

    files = sorted(str(p) for p in Path(root).rglob("*.nii*"))
    tools = decoder_toolchain()
    built = native.native_available()
    check(built or not (tools["gxx"] and tools["zlib_h"]),
          f"the decoder did not build: {native.build_error()}")
    t0 = time.perf_counter()
    got = (native.read_nifti_batch_native(files) if built
           else [read_nifti(f) for f in files])
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = [read_nifti_py(f) for f in files]
    pure_s = time.perf_counter() - t0
    for f, g, w in zip(files, got, want):
        check(g.dtype == w.dtype and g.shape == w.shape and bool(
            (np.ascontiguousarray(g).view(np.uint8)
             == np.ascontiguousarray(w).view(np.uint8)).all()),
              f"decoder: {f} differs from the pure reader")
    return dict(built=built, **tools,
                library=native.library_path().name if built else None,
                why_not=None if built else native.build_error(),
                files=len(files), bytes=sum(w.nbytes for w in want),
                equal_bitwise=True,
                batched_native_s=read_s if built else None,
                pure_s=pure_s)


def watch_warming(loader) -> dict:
    """Wraps ``loader.warm_async``: the record gets the thread, its keys
    and the host clock when it ended."""
    rec = {}
    start = loader.warm_async

    def warm_async(epoch=0, chunk=8):
        t = start(epoch, chunk)
        rec["keys"] = len(loader.epoch_keys(epoch))

        def watch():
            if t is not None:
                t.join()
            rec["done"] = time.perf_counter()

        rec["thread"] = threading.Thread(target=watch, daemon=True)
        rec["thread"].start()
        return t

    loader.warm_async = warm_async
    return rec


def aspp_phase(torch) -> list:
    """The clipped-tap ASPP (the form JAX's rule picks for the input's h, w)
    against the same module computing every branch as a plain convolution,
    on the same weights and inputs, train mode (dropout 0): the output, the
    input gradient and every parameter gradient in relative norm; the
    forward and forward + backward of each form timed."""
    from glfusion_tpu_torch.config import Config
    from glfusion_tpu_torch.models.aspp import ASPP, decomposes
    from glfusion_tpu_torch.models.precision import compute_dtype

    mcfg = Config().model
    gen = torch.Generator(device="cuda").manual_seed(4)
    records = []
    for b, hw in ASPP_CASES:
        for dt_name in ("float32", "bfloat16"):
            dt = compute_dtype(dt_name)
            torch.manual_seed(0)
            m = ASPP(mcfg.backbone_out_channels, mcfg.aspp_channels,
                     mcfg.aspp_rates, dropout=0.0, dtype=dt).cuda().train()
            cin = mcfg.backbone_out_channels
            x = torch.randn(b, cin, hw, hw, device="cuda",
                            generator=gen).to(dt)
            dy = torch.randn(b, mcfg.aspp_channels, hw, hw, device="cuda",
                             generator=gen).to(dt)

            def forward(plain, grad):
                if plain:
                    m.branch_convs = m.dilated_convs
                try:
                    m.zero_grad(set_to_none=True)
                    xx = x.detach().requires_grad_(grad)
                    y = m(xx)
                    if grad:
                        y.backward(dy)
                        return y, xx.grad, {n: p.grad for n, p in
                                            m.named_parameters()}
                    return y
                finally:
                    if plain:
                        del m.branch_convs

            yk, dxk, gk = forward(False, True)
            yp, dxp, gp = forward(True, True)
            torch.cuda.synchronize()
            err = {"out": rel_norm(yk, yp), "dx": rel_norm(dxk, dxp)}
            err.update({"d" + n: rel_norm(gk[n], gp[n]) for n in gp})
            limit = ASPP_TOL[dt_name]
            bad = {k: e for k, e in err.items() if not (
                math.isfinite(e)
                and e <= limit["out" if k == "out" else "grad"])}
            check(not bad, f"aspp {(b, hw)} {dt_name}: clipped taps vs "
                  f"plain convolutions beyond {limit}: {bad}")
            ms = {}
            for form, plain in (("clipped", False), ("plain", True)):
                ms[form + "_fwd_ms"] = time_ms(
                    torch, lambda: forward(plain, False), reps=5, warmup=1)
                ms[form + "_fwd_bwd_ms"] = time_ms(
                    torch, lambda: forward(plain, True), reps=5, warmup=1)
            rec = {"batch": b, "hw": hw, "dtype": dt_name,
                   "rates": list(mcfg.aspp_rates),
                   "decomposes": [decomposes(r, hw, hw)
                                  for r in mcfg.aspp_rates],
                   "rel_norm_err": err, "worst": max(err.values()),
                   "tol": limit, **ms}
            records.append(rec)
            emit("aspp", **rec)
            del m, x, dy, yk, dxk, gk, yp, dxp, gp
            torch.cuda.empty_cache()
    return records


def train_bf16_phase(torch, data_paths) -> dict:
    """JAX bench.py's recorded training configuration on the flagship with
    fused stems and the TPAVI kernel: bfloat16 with remat, one epoch
    through ``Trainer`` in each form of the cycle pass."""
    from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
    from glfusion_tpu_torch.models import GlobalAndLocal

    base = _flagship_config()
    base = base.replace(model=dataclasses.replace(
        base.model, dtype="bfloat16", remat=True))
    torch.manual_seed(0)
    model = GlobalAndLocal(base.model)
    swap_in_fused_stems(model)
    views = len(base.model.views)
    # per step: stem kernels a pass a view, K1 calls (sup global + local,
    # cycle global + local; cycle_light's cycle global only; one merged
    # global + the supervised local)
    expect = {"plain": (2 * views, 4), "cycle_light": (2 * views, 3),
              "fuse_passes": (views, 2)}
    counts = {}
    for name, opts in BF16_VARIANTS:
        cfg = base.replace(train=dataclasses.replace(base.train, **opts))
        trainer, step_s = _timed_trainer(torch, cfg, data_paths, model)
        # ---- the main path, counted
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        metrics = trainer.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        c = counts[name] = _counts(torch)
        steps = metrics["steps"]
        for k in ("loss", "seg_loss", "cyc_loss"):
            check(math.isfinite(metrics[k]) and metrics[k] > 0,
                  f"train_bf16 {name}: {k} = {metrics[k]}")
        per_stem, per_k1 = expect[name]
        for k, n in c.items():
            want = (per_k1 if k == "fused_dot_nonlocal" else per_stem) * steps
            check(n == want, f"train_bf16 {name}: {k} launched {n} times "
                  f"in {steps} steps")
        rec = dict(variant=name, steps=steps, step_s=step_s,
                   s_per_step_median=statistics.median(step_s[1:] or step_s),
                   max_memory_allocated=peak, loss=metrics["loss"],
                   seg_loss=metrics["seg_loss"], cyc_loss=metrics["cyc_loss"],
                   launches=c)
        if name == "plain":
            host = next(trainer.train_loader.batches(cfg.train.batch_size,
                                                     1))
            with trainer.step_randomness(1, 0) as gen:
                batch = trainer.train_batch(host, trainer._cycle_clips(1),
                                            gen)
                prof = profile_phase(torch, lambda: trainer.train_step(
                    batch, gen), "train_bf16_profile")
            rec["step_idle_share"] = prof["idle_share"]
            rec["step_agreement"] = step_agreement(torch, cfg, trainer, batch,
                                                   STEP_TOL_BF16)
        emit("train_bf16", dtype="bfloat16", remat=True, **rec)
        del trainer
    return {k: sum(c[k] for c in counts.values()) for k in counts["plain"]}


def _flagship_config(**train):
    """The full-width float32 flagship with K1, on the train phase's
    synthetic corpus, one epoch, no evaluation or checkpoint."""
    from glfusion_tpu_torch.config import Config

    cfg = Config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, use_pallas_fusion=True),
        data=dataclasses.replace(cfg.data,
                                 synthetic_num_patients=TRAIN_PATIENTS,
                                 train_repeat=TRAIN_REPEAT),
        train=dataclasses.replace(cfg.train, num_epochs=1,
                                  eval_every_epochs=0, save_every_epochs=0,
                                  **train))


def _timed_trainer(torch, cfg, data_paths, model):
    """A ``Trainer`` whose steps are timed (host clock, synchronised):
    (trainer, the list the step times go to)."""
    from glfusion_tpu_torch.train.trainer import Trainer

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_run_"))
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, save_dir=str(tmp / "ckpt"), log_dir=str(tmp / "log")))
    trainer = Trainer(cfg, data_paths=data_paths, model=model, verbose=False)
    step_s, inner = [], trainer.train_step

    def timed_step(batch, gen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    if hasattr(inner, "checkify_flush"):
        timed_step.checkify_flush = inner.checkify_flush
    timed_step.seg_loss = inner.seg_loss
    trainer.train_step = timed_step
    return trainer, step_s


def _counts(torch):
    from glfusion_tpu_torch.experiments import stem_fused
    from glfusion_tpu_torch.ops.tpavi_fused import fused_dot_nonlocal

    c = {k.__name__: k.launches for k in stem_fused.KERNELS}
    c["fused_dot_nonlocal"] = fused_dot_nonlocal.launches
    return c


def _zero_counts():
    from glfusion_tpu_torch.experiments import stem_fused
    from glfusion_tpu_torch.ops.tpavi_fused import fused_dot_nonlocal

    for k in stem_fused.KERNELS:
        k.launches = 0
    fused_dot_nonlocal.launches = 0


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def temporal_phase(torch, data_paths) -> dict:
    """``temporal`` on the full-width float32 flagship with K1 and the
    fused stems: one epoch through ``Trainer``; the cycle pass's two
    attentions run K1 at (1, 40·3·28², 1024), the supervised pass's at
    (8, 2352, 1024); then the step check on a fixed sample, its plain
    paths in the reassociated order where the naive map would not fit."""
    from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
    from glfusion_tpu_torch.models import GlobalAndLocal
    from glfusion_tpu_torch.ops import tpavi_fused

    cfg = _flagship_config(temporal=True)
    torch.manual_seed(0)
    model = GlobalAndLocal(cfg.model)
    swap_in_fused_stems(model)
    trainer, step_s = _timed_trainer(torch, cfg, data_paths, model)
    check_batch, state0 = fixed_check_sample(torch, trainer)
    shapes: dict = {}
    launch = tpavi_fused._launch

    def recorded(theta, phi, g):
        key = tuple(theta.shape)
        shapes[key] = shapes.get(key, 0) + 1
        return launch(theta, phi, g)

    # ---- the main path, counted
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tpavi_fused._launch = recorded
    try:
        metrics = trainer.train()
        torch.cuda.synchronize()
    finally:
        tpavi_fused._launch = launch
    peak = torch.cuda.max_memory_allocated()
    c = _counts(torch)
    steps = metrics["steps"]
    views = len(cfg.model.views)
    for k in ("loss", "seg_loss", "cyc_loss"):
        check(math.isfinite(metrics[k]) and metrics[k] > 0,
              f"temporal: {k} = {metrics[k]}")
    check(all(c[k] == 2 * views * steps for k in c
              if k != "fused_dot_nonlocal")
          and c["fused_dot_nonlocal"] == 4 * steps,
          f"temporal launches {c} in {steps} steps")
    want = {(8, 2352, 1024): 2 * steps, (1, TEMPORAL_N, 1024): 2 * steps}
    check(shapes == want, f"temporal: K1 shapes {shapes}, want {want}")
    agreement = step_agreement(torch, cfg, trainer, check_batch,
                               state=state0)
    emit("temporal", steps=steps, step_s=step_s,
         s_per_step_median=statistics.median(step_s[1:] or step_s),
         max_memory_allocated=peak, loss=metrics["loss"],
         seg_loss=metrics["seg_loss"], cyc_loss=metrics["cyc_loss"],
         launches=c, k1_shapes={str(k): v for k, v in shapes.items()},
         step_agreement=agreement)
    del trainer, model
    _free(torch)
    return c


def cps_phase(torch, data_paths) -> dict:
    """The CPS twin at full width in float32 with remat (two flagships
    with Adam would not fit without it), K1 and fused stems in both
    networks: one epoch through ``Trainer``; finite losses, and both
    networks' kernels launched: every forward kernel twice the single
    network's count, the backward ones but for net 2's cycle pass, whose
    features no loss reads."""
    from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
    from glfusion_tpu_torch.models import build_model

    cfg = _flagship_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, variant="cps",
                                                remat=True))
    torch.manual_seed(0)
    model, cps = build_model(cfg.model)
    check(cps, "cps: not the twin")
    for net in (model.net1, model.net2):
        swap_in_fused_stems(net)
    trainer, step_s = _timed_trainer(torch, cfg, data_paths, model)
    check(trainer.cps, "cps: the Trainer took a single network")
    params = sum(p.numel() for p in model.parameters())
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    metrics = trainer.train()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    c = _counts(torch)
    steps = metrics["steps"]
    views = len(cfg.model.views)
    for k in ("loss", "seg_loss", "cyc_loss"):
        check(math.isfinite(metrics[k]) and metrics[k] > 0,
              f"cps: {k} = {metrics[k]}")
    # forward: 2 networks × 2 passes; backward: not net 2's cycle pass,
    # whose features no loss reads (as in JAX)
    fwd, bwd = 2 * 2 * views * steps, 3 * views * steps
    check(all(c[k] == fwd for k in ("stem_stats", "stem_norm_pool"))
          and all(c[k] == bwd for k in ("stem_bwd1", "stem_bwd2",
                                        "stem_dx_reduce"))
          and c["fused_dot_nonlocal"] == 2 * 4 * steps,
          f"cps launches {c} in {steps} steps (two networks)")
    emit("cps", dtype="float32", remat=True, parameters=params, steps=steps,
         step_s=step_s,
         s_per_step_median=statistics.median(step_s[1:] or step_s),
         max_memory_allocated=peak, loss=metrics["loss"],
         seg_loss=metrics["seg_loss"], cyc_loss=metrics["cyc_loss"],
         launches=c)
    del trainer, model
    _free(torch)
    return c


def variants_phase(torch, data_paths) -> dict:
    """The flagship's eight ablations at full width in float32 with K1 and
    a ``FusedIEKDStem`` in each view: each trains ``VARIANT_STEPS`` steps
    through ``Trainer`` on the train phase's corpus, then runs one eval
    forward. Counted from 0 over both: K1's calls a step
    (``VARIANT_K1``) and an eval forward (half that), the stems' forward
    and backward in each view each pass; finite losses. In the steps of
    ``VARIANT_IN_SITU_K1`` each K1 call is held against its plain version
    on its own operands (those variants' s/step include that comparison:
    ``recorded``); in ``early_fusion`` each stem call of the first
    step (its dx now reaches the ``early_mix`` convs) is replayed
    (``stem_replay``) with ``early_mix``'s weight and bias gradients
    derived from each path's dx. The eval forward's ``f4_global``,
    ``f4_local`` and mask logits against the same model through the plain
    stems and the reassociated attention, within the serve phase's
    limits."""
    from glfusion_tpu_torch.experiments import stem_fused, stem_module
    from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
    from glfusion_tpu_torch.models import GlobalAndLocal

    records, total = {}, {}
    for variant, k1_step in VARIANT_K1.items():
        cfg = _flagship_config()
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, variant=variant),
            data=dataclasses.replace(cfg.data, train_repeat=VARIANT_REPEAT))
        torch.manual_seed(0)
        model = GlobalAndLocal(cfg.model)
        swap_in_fused_stems(model)
        trainer, step_s = _timed_trainer(torch, cfg, data_paths, model)
        mixes = []
        if variant == "early_fusion":  # each call's input: the V images
            for conv in model.early_mix.values():
                conv.register_forward_hook(
                    lambda m, args, out: mixes.append(args[0].detach()))
        host = next(trainer.train_loader.batches(cfg.train.batch_size, 1))
        with trainer.step_randomness(1, 0) as gen:
            images = trainer.train_batch(host, None, gen)["images"]

        # ---- the main path, counted: the steps, then one eval forward
        in_situ = variant in VARIANT_IN_SITU_K1 or variant == "early_fusion"
        recorder = (kernel_recorder(torch) if in_situ else
                    contextlib.nullcontext({"k1": [], "stem": []}))
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        with recorder as rec:
            metrics = trainer.train()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            model.eval()
            with torch.inference_mode():
                out_k = model(images)
        c = _counts(torch)
        steps = metrics["steps"]
        views = len(cfg.model.views)
        check(steps == VARIANT_STEPS, f"{variant}: {steps} steps")
        for k in ("loss", "seg_loss", "cyc_loss"):
            check(math.isfinite(metrics[k]) and metrics[k] > 0,
                  f"{variant}: {k} = {metrics[k]}")
        fwd, bwd = 2 * views * steps, 2 * views * steps
        want = {"stem_stats": fwd, "stem_norm_pool": fwd + views,
                "stem_bwd1": bwd, "stem_bwd2": bwd, "stem_dx_reduce": bwd,
                "fused_dot_nonlocal": k1_step * steps + k1_step // 2}
        check(c == want, f"{variant}: launches {c}, want {want}")
        for k in c:
            total[k] = total.get(k, 0) + c[k]

        # ---- the eval forward against the plain stems and reassoc order
        attns = [getattr(model, a) for a in ("global_attn", "local_attn")
                 if hasattr(model, a)]
        check(len(attns) == k1_step // 2, f"{variant}: {len(attns)} attns")
        saved = stem_module.fused_stem_eval
        stem_module.fused_stem_eval = stem_fused.fused_stem_eval_plain
        for attn in attns:
            attn.attn_impl = "reassoc"
        try:
            with torch.inference_mode():
                out_p = model(images)
        finally:
            stem_module.fused_stem_eval = saved
            for attn in attns:
                attn.attn_impl = "pallas"
        agree = {}
        for k, lim in (("f4_global", 1e-4), ("f4_local", 1e-4),
                       ("mask", 1e-3)):
            check(bool(torch.isfinite(out_k[k]).all()), f"{variant}: {k}")
            agree[k] = ((out_k[k] - out_p[k]).abs().max()
                        / out_p[k].abs().max()).item()
            check(agree[k] <= lim, f"{variant}: eval {k} kernel path vs "
                  f"plain relative error {agree[k]} > {lim}")

        rec_out = dict(steps=steps, step_s=step_s, recorded=in_situ,
                       s_per_step_median=statistics.median(step_s[1:]
                                                           or step_s),
                       max_memory_allocated=peak, loss=metrics["loss"],
                       launches=c, k1_per_step=k1_step,
                       eval_rel_err_vs_plain=agree)
        # ---- the kernels in situ, on the steps' own tensors
        if variant in VARIANT_IN_SITU_K1:
            k1 = rec["k1"][:k1_step * steps]  # the steps' calls
            check(len(k1) == k1_step * steps, f"{variant}: K1 calls seen")
            situ = in_situ_verdict({"k1": k1, "stem": []}, STEP_TOL)
            check(situ["ok"], f"{variant}: K1 in situ {situ['bad']}")
            rec_out["k1_in_situ"] = situ
        if variant == "early_fusion":
            calls = rec["stem"][:2 * views]  # the first step's
            check(len(mixes) >= len(calls) and all("dy" in r for r in calls),
                  f"early_fusion: {len(calls)} stem calls, {len(mixes)} "
                  "early_mix inputs")
            stems = []
            for r, mix in zip(calls, mixes):
                check(mix.shape[0] == r["inputs"][0].shape[0],
                      "early_fusion: a stem call and its early_mix input")

                def derive(dx, mix=mix):
                    return {"dearly_mix_weight": torch.einsum(
                                "bhw,bchw->c", dx[:, 0].float(), mix),
                            "dearly_mix_bias": dx.float().sum()}

                stems.append(stem_replay(torch, r, derive))
            situ = in_situ_verdict({"k1": [], "stem": stems}, STEP_TOL)
            check(situ["ok"] and situ["stem_calls"] == 2 * views,
                  f"early_fusion: stem dx in situ {situ['bad']}")
            rec_out["stem_in_situ"] = dict(
                situ, dx_err=[r["err"]["dx"] for r in stems],
                dx_noise=[r["noise"]["dx"] for r in stems],
                early_mix_err=[r["err"]["dearly_mix_weight"] for r in stems],
                early_mix_noise=[r["noise"]["dearly_mix_weight"]
                                 for r in stems])
        records[variant] = rec_out
        del trainer, model, rec, out_k, out_p, images
        _free(torch)
    emit("variants", dtype="float32", steps=VARIANT_STEPS,
         variants=records, launches=total)
    return total


def checkify_phase(torch, data_paths) -> dict:
    """``checkify`` on the float32 flagship with K1 and the fused stems:
    one epoch without it, then one with it from the same weights, for the
    s/step it costs; the launches are the checkify epoch's, counted from 0
    just before it. Then an epoch whose second step has one NaN pixel
    must raise JAX's message in its third step (the verdict is read one
    step late), which ends it."""
    from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
    from glfusion_tpu_torch.models import GlobalAndLocal

    torch.manual_seed(0)
    base = _flagship_config()
    model = GlobalAndLocal(base.model)
    swap_in_fused_stems(model)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    views = len(base.model.views)
    s_per_step = {}
    for on in (False, True):
        model.load_state_dict(init)
        cfg = base.replace(train=dataclasses.replace(base.train, checkify=on))
        trainer, step_s = _timed_trainer(torch, cfg, data_paths, model)
        _zero_counts()
        m = trainer.train()
        torch.cuda.synchronize()
        c = _counts(torch)
        check(math.isfinite(m["loss"]), f"checkify={on}: loss {m['loss']}")
        s_per_step[on] = statistics.median(step_s[1:] or step_s)
        del trainer
        _free(torch)
    steps = m["steps"]
    check(all(c[k] == 2 * views * steps for k in c
              if k != "fused_dot_nonlocal")
          and c["fused_dot_nonlocal"] == 4 * steps,
          f"checkify launches {c} in {steps} steps")

    model.load_state_dict(init)
    cfg = base.replace(train=dataclasses.replace(base.train, checkify=True))
    trainer, step_s = _timed_trainer(torch, cfg, data_paths, model)
    make_batch = trainer.train_batch

    def poisoned(host, cycle_iter, gen):
        batch = make_batch(host, cycle_iter, gen)
        if len(step_s) == 1:  # the second step
            batch["images"][0, 0, 5, 5, 0] = float("nan")
        return batch

    trainer.train_batch = poisoned
    error = None
    try:
        trainer.train()
    except RuntimeError as e:
        error = str(e)
    check(error is not None and error.startswith(
        "non-finite training loss nan"), f"checkify: the NaN step gave "
        f"{error!r}")  # the stem keeps the NaN, so the loss is NaN
    raised_in_step = len(step_s) + 1  # the raising step was not timed
    check(raised_in_step == 3, f"checkify raised in step {raised_in_step}")
    emit("checkify", steps=steps, s_per_step_off=s_per_step[False],
         s_per_step_on=s_per_step[True],
         overhead_s_per_step=s_per_step[True] - s_per_step[False],
         nan_error=error, raised_in_step=raised_in_step, launches=c)
    del trainer, model
    _free(torch)
    return c


def zoo_phase(torch, data_paths) -> dict:
    """The segmentation zoo (``--model``) at ``Config()`` widths, float32:
    each of ``ZOO_ARCHS`` is built through the registry and trains
    ``VARIANT_STEPS`` steps through ``Trainer`` on the train phase's
    corpus, then runs one eval forward of a supervised batch, timed
    (``utils/profiling.time_fn``) and counted (``flops_of``), and held
    against the same module in float64 on the card (every output within
    ``ZOO_TOL`` in relative norm: cuDNN's 3-D, transposed 3-D, depthwise
    and dilated convolutions, which the CPU tests never reach). For
    ``res3dunet`` the step's supervised loss on that batch, with and
    without its three ``mask_aux`` maps. The parameters no loss reaches
    (``ZOO_OUTSIDE_LOSS``: CEN's ``alpha``, every B2ResNet's second fork)
    must have moved in the steps, each element that was not 0 (Adam's L2
    step, as optax's; a 0 stays 0). No zoo model runs a hand-written
    kernel (JAX sends only the flagship's TPAVI to Pallas, and
    ``use_pallas_fusion``, on here as in the flagship's configuration,
    reaches no zoo TPAVI): K1's and the stems' launch counts must not move
    across the phase."""
    from glfusion_tpu_torch.models import build_model
    from glfusion_tpu_torch.train.losses import bce_with_logits_sum
    from glfusion_tpu_torch.utils.profiling import flops_of, time_fn

    before = _counts(torch)
    records = {}
    for arch in ZOO_ARCHS:
        cfg = _flagship_config()
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, arch=arch),
            data=dataclasses.replace(cfg.data, train_repeat=VARIANT_REPEAT))
        torch.manual_seed(0)
        model, _ = build_model(cfg.model, hw=cfg.data.crop_hw)
        trainer, step_s = _timed_trainer(torch, cfg, data_paths, model)
        outside = {k: p.detach().clone() for k, p in model.named_parameters()
                   if any(n in k for n in ZOO_OUTSIDE_LOSS)}
        check(bool(outside) == (arch == "cen" or arch.startswith("avs_")),
              f"{arch}: {len(outside)} parameters outside the loss")
        step = trainer.train_step
        host = next(trainer.train_loader.batches(cfg.train.batch_size, 1))
        with trainer.step_randomness(1, 0) as gen:
            batch = trainer.train_batch(host, None, gen)
        images, masks = batch["images"], batch["masks"]

        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        metrics = trainer.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        check(metrics["steps"] == VARIANT_STEPS, f"{arch}: {metrics['steps']}"
              " steps")
        for k in ("loss", "seg_loss", "cyc_loss"):
            check(math.isfinite(metrics[k]) and metrics[k] > 0,
                  f"{arch}: {k} = {metrics[k]}")
        params = dict(model.named_parameters())
        for k, was in outside.items():
            now = params[k].detach()
            check(bool((now != was)[was != 0].all())
                  and bool((now == was)[was == 0].all()),
                  f"{arch}: {k}, outside the loss, did not take Adam's L2 "
                  "step")

        model.eval()
        with torch.inference_mode():
            out = model(images)
            fwd_s = time_fn(lambda x: model(x), images, iters=3)
            flop = flops_of(lambda x: model(x), images)
            twin = copy.deepcopy(model).double()
            out64 = twin(images.double())
        errs = {}
        for k, v in out.items():
            for j, t in enumerate(v if isinstance(v, tuple) else (v,)):
                ref = (out64[k][j] if isinstance(v, tuple) else out64[k])
                name = f"{k}{j}" if isinstance(v, tuple) else k
                check(bool(torch.isfinite(t).all()), f"{arch}: {name}")
                errs[name] = rel_norm(t, ref)
                check(errs[name] <= ZOO_TOL, f"{arch}: eval {name} against "
                      f"float64 relative norm {errs[name]} > {ZOO_TOL}")
        rec = dict(s_per_step=step_s[-1], step_s=step_s,
                   outside_loss_moved=len(outside),
                   max_memory_allocated=peak, loss=metrics["loss"],
                   eval_ms=fwd_s * 1e3, eval_flop=flop,
                   eval_frames=list(images.shape[:2]),
                   params=sum(p.numel() for p in model.parameters()),
                   rel_err_vs_float64=errs)
        if "mask_aux" in out:
            with torch.inference_mode():
                plain = {k: v for k, v in out.items() if k != "mask_aux"}
                with_aux = step.seg_loss(out, masks).item()
                without = step.seg_loss(plain, masks).item()
                aux = sum(bce_with_logits_sum(a[vi], masks[vi]).item()
                          for a in out["mask_aux"]
                          for vi in range(masks.shape[0]))
            check(len(out["mask_aux"]) == 3, f"{arch}: mask_aux")
            check(abs(with_aux - without - aux) <= 1e-5 * with_aux,
                  f"{arch}: loss {with_aux} is not {without} + the aux "
                  f"terms {aux}")
            rec["seg_loss_with_aux"] = with_aux
            rec["seg_loss_without_aux"] = without
        records[arch] = rec
        del trainer, model, twin, out, out64, images, masks, batch, params
        del outside
        _free(torch)
    segmenters = segmenters_check(torch)
    after = _counts(torch)
    check(after == before, f"zoo: kernel launches moved {before} → {after}")
    emit("zoo", dtype="float32", steps=VARIANT_STEPS, archs=records,
         segmenters=sorted(segmenters), launches_before=before,
         launches_after=after)
    return records


def segmenters_check(torch) -> dict:
    """The library segmenters (``models/segmentation.py``, no ``--model``
    name, as in JAX) at their ctors' full width, float32: an eval forward
    of ``SEG_BATCH`` 112² frames (3 channels for ``deeplabv3_resnet50``;
    the multi-frame models a reference and ``SEG_SUPPORTS`` supports),
    timed, counted and held against its float64 twin within ``ZOO_TOL``
    in relative norm for every output, with its peak memory; one line a
    ctor. ``deeplabv3_resnet50_mltfrm`` also trains one forward and
    backward: every gradient finite, the shared backbone's BatchNorms
    counting one update a frame (1 + ``SEG_SUPPORTS``), the head's one."""
    from glfusion_tpu_torch.models import segmentation as seg
    from glfusion_tpu_torch.train.losses import bce_with_logits_sum
    from glfusion_tpu_torch.utils.profiling import flops_of, time_fn

    records = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in SEGMENTERS:
        torch.manual_seed(0)
        model = getattr(seg, name)().cuda().eval()
        multi = isinstance(model, seg.MultiFrameSegmenter)
        chans = 3 if name == "deeplabv3_resnet50" else 1
        x = torch.rand(SEG_BATCH, SEG_HW, SEG_HW, chans, device="cuda",
                       generator=gen)
        args = (x, [torch.rand(x.shape, device="cuda", generator=gen)
                    for _ in range(SEG_SUPPORTS)]) if multi else (x,)
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            out = model(*args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            ms = time_fn(model, *args, iters=3) * 1e3
            flop = flops_of(model, *args)
            twin = copy.deepcopy(model).double()
            out64 = twin(*[[t.double() for t in a] if isinstance(a, list)
                           else a.double() for a in args])
        errs = {}
        for k, t in out.items():
            check(bool(torch.isfinite(t).all()), f"{name}: {k}")
            check(t.shape == out64[k].shape, f"{name}: {k} {t.shape}")
            errs[k] = rel_norm(t, out64[k])
            check(errs[k] <= ZOO_TOL, f"{name}: eval {k} against float64 "
                  f"relative norm {errs[k]} > {ZOO_TOL}")
        rec = dict(eval_ms=ms, eval_flop=flop, max_memory_allocated=peak,
                   frames=list(x.shape), supports=SEG_SUPPORTS if multi
                   else 0, outputs={k: list(t.shape) for k, t in out.items()},
                   params=sum(p.numel() for p in model.parameters()),
                   rel_err_vs_float64=errs)
        del twin, out, out64
        if name == "deeplabv3_resnet50_mltfrm":
            rec["train"] = _segmenter_train(torch, model, args, gen,
                                            bce_with_logits_sum)
        emit("zoo_segmenter", name=name, dtype="float32", **rec)
        records[name] = rec
        del model, args, x
        _free(torch)
    return records


def _segmenter_train(torch, model, args, gen, bce) -> dict:
    """One train-mode forward and backward of a multi-frame segmenter."""
    bns = {k: m for k, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    before = {k: int(m.num_batches_tracked) for k, m in bns.items()}
    model.train()
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model(*args)["out"]
    masks = (torch.rand(out.shape, device="cuda", generator=gen)
             > 0.7).float()
    loss = bce(out, masks)
    loss.backward()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    grads = [(k, p.grad) for k, p in model.named_parameters()]
    check(all(g is not None and bool(torch.isfinite(g).all())
              for _, g in grads), "mltfrm: a gradient is missing or not "
          "finite")
    for k, m in bns.items():
        want = 1 + SEG_SUPPORTS if k.startswith("backbone.") else 1
        moved = int(m.num_batches_tracked) - before[k]
        check(moved == want, f"mltfrm: {k} counted {moved} updates, not "
              f"{want}")
    model.zero_grad(set_to_none=True)
    model.eval()
    return dict(loss=loss.item(), fwd_bwd_s=step_s,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                grads=len(grads), backbone_bn_updates=1 + SEG_SUPPORTS)


def regression_phase(torch) -> dict:
    """The mPAP regression path (``--mode reg-train|reg-val``) at full
    width, float32: each of ``REG_ARCHS`` (``build_reg_model`` with no
    overrides) trains one epoch of ``REG_STEPS`` steps through
    ``RegressionTrainer`` (the second step timed) on a synthetic corpus of
    ``REG_PATIENTS`` patients, then ``evaluate()`` (every score finite);
    an eval forward of the val batch is timed (``utils/profiling.time_fn``),
    counted (``flops_of``) and held against the same module in float64 on
    the card within ``REG_TOL`` in relative norm (cuDNN's 3-D, dilated 3-D
    and transposed 3-D convolutions, which the CPU tests never run at this
    size); the checkpoint saved after the epoch, restored by a fresh
    trainer, equals the trained state bit for bit (weights, BN buffers,
    Adam, the schedule). No regressor runs a hand-written kernel (JAX sends
    none of them to Pallas): K1's and the stems' launch counts must not
    move across the phase."""
    from glfusion_tpu_torch.config import Config
    from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset

    before = _counts(torch)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_reg_"))
    try:
        cfg = Config()
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, synthetic_num_patients=REG_PATIENTS))
        t0 = time.perf_counter()
        paths = generate_synthetic_dataset(tmp / "data", cfg.data,
                                           views=cfg.model.views,
                                           seed=cfg.train.seed)
        corpus_s = time.perf_counter() - t0
        records = {name: _regression(torch, cfg, paths, tmp / name, name)
                   for name in REG_ARCHS}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    after = _counts(torch)
    check(after == before,
          f"regression: kernel launches moved {before} → {after}")
    emit("regression_launches", corpus_s=corpus_s, launches_before=before,
         launches_after=after)
    return records


def _regression(torch, cfg, paths, save_dir: Path, name: str) -> dict:
    """One regressor of ``regression_phase``; emits its line."""
    from glfusion_tpu_torch.models.registry import build_reg_model
    from glfusion_tpu_torch.train.regression import RegressionTrainer
    from glfusion_tpu_torch.train.train_state import state_payload
    from glfusion_tpu_torch.utils.profiling import flops_of, time_fn

    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                save_dir=str(save_dir)))
    views = cfg.model.num_views
    torch.manual_seed(0)
    model, adapter = build_reg_model(name, views)
    trainer = RegressionTrainer(cfg, model, paths, input_adapter=adapter)
    check(trainer.steps_per_epoch == REG_STEPS,
          f"{name}: {trainer.steps_per_epoch} steps an epoch")
    step_s, inner = [], trainer.train_step

    def timed_step(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    trainer.train_step = timed_step
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.train_epoch(0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(metrics["steps"] == REG_STEPS and math.isfinite(metrics["loss"]),
          f"{name}: {metrics}")
    t0 = time.perf_counter()
    scores = trainer.evaluate()
    evaluate_s = time.perf_counter() - t0
    check(set(scores) == {"mse", "mae", "rmse", "r2"}
          and all(math.isfinite(v) for v in scores.values()),
          f"{name}: scores {scores}")

    x = trainer._batch(next(trainer.val_loader.batches(
        cfg.train.batch_size)), False)["clips"]
    model.eval()
    with torch.inference_mode():
        out = model(x)
        fwd_s = time_fn(lambda t: model(t), x, iters=3)
        flop = flops_of(lambda t: model(t), x)
        twin = copy.deepcopy(model).double()
        out64 = twin(x.double())
    errs = {}
    outs = out if isinstance(out, tuple) else (out,)  # Resnet50PFS: + seg
    refs = out64 if isinstance(out64, tuple) else (out64,)
    for k, t, ref in zip(("out", "seg"), outs, refs):
        check(bool(torch.isfinite(t).all()), f"{name}: {k} not finite")
        errs[k] = rel_norm(t, ref)
        check(errs[k] <= REG_TOL, f"{name}: eval {k} against float64 "
              f"relative norm {errs[k]} > {REG_TOL}")
    del twin, out64

    t0 = time.perf_counter()
    trainer.save(0, wait=True)
    save_s = time.perf_counter() - t0
    torch.manual_seed(1)  # other initial weights, overwritten by the load
    fresh, fresh_adapter = build_reg_model(name, views)
    restored = RegressionTrainer(cfg, fresh, paths,
                                 input_adapter=fresh_adapter)
    t0 = time.perf_counter()
    check(restored.load_latest() and restored.epoch == 1,
          f"{name}: no checkpoint restored")
    load_s = time.perf_counter() - t0
    want = state_payload(model, trainer.optimizer, trainer.scheduler)
    diff = state_diff(torch, want, state_payload(
        fresh, restored.optimizer, restored.scheduler))
    check(not diff, f"{name}: restored state differs at {diff[:5]}")
    net, side = trainer.ckpt.paths(0)
    rec = dict(model=name, s_per_step=step_s[-1], step_s=step_s,
               max_memory_allocated=peak, loss=metrics["loss"],
               scores=scores, evaluate_s=evaluate_s, eval_ms=fwd_s * 1e3,
               eval_flop=flop, eval_batch=list(x.shape),
               params=sum(p.numel() for p in model.parameters()),
               rel_err_vs_float64=errs, checkpoint_bytes=(
                   net.stat().st_size + side.stat().st_size),
               save_s=save_s, load_latest_s=load_s,
               restored_leaves=_leaves(want), restored_bitwise=True)
    emit("regression", dtype="float32", batch=cfg.train.batch_size,
         steps=REG_STEPS, **rec)
    del trainer, restored, model, fresh, out, x
    _free(torch)
    return rec


# mesh: two ranks share the one card over gloo (NCCL refuses two ranks on
# one device), the full-width float32 flagship with K1 and the fused stems;
# a global batch of MESH_BATCH frames a view and a clip of MESH_CLIP (the
# cycle loss needs T >= 16 + 3 + 2, and 24 splits over two ranks); one step
# each under (data 2), (model 2) and ``temporal`` at (data 2)
MESH_BATCH, MESH_CLIP = 4, 24
MESH_CASES = (("d2", 2, 1, {}), ("m2", 1, 2, {}),
              ("temporal_d2", 2, 1, {"temporal": True}))
# the weights after the step within this share of lr of torch Adam's first
# update of the summed gradients (float32 rounding of that update: 1e-7)
MESH_ADAM_GAP = 1e-4
MESH_TIMEOUT_S = 420


def _mesh_config(case_opts, root, data=-1, model=1):
    """The mesh phase's flagship, its checkpoints and logs under ``root``."""
    cfg = _flagship_config(**case_opts)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, clip_length=MESH_CLIP),
        train=dataclasses.replace(cfg.train, batch_size=MESH_BATCH,
                                  mesh_data=data, mesh_model=model,
                                  save_dir=f"{root}/ckpt",
                                  log_dir=f"{root}/log"))


_MESH_TEMPLATE: list = []


def _mesh_model(torch, cfg, state=None):
    """The flagship with fused stems holding ``state`` (None: seed 0's
    initial weights): a copy of one template a process (its CPU init takes
    seconds at full width)."""
    from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
    from glfusion_tpu_torch.models import GlobalAndLocal

    if not _MESH_TEMPLATE:
        torch.manual_seed(0)
        _MESH_TEMPLATE.append(GlobalAndLocal(cfg.model))
        swap_in_fused_stems(_MESH_TEMPLATE[0])
    model = copy.deepcopy(_MESH_TEMPLATE[0])
    if state is not None:
        model.load_state_dict(state)
    return model


def _mesh_step(torch, trainer, batch):
    """One step of ``trainer`` (its mesh) on ``batch`` under the draws of
    (epoch 1, step 0): (metrics, whole gradients, whole state after, the
    step's seconds), on the card. A collective on a mesh: every rank calls
    it."""
    from glfusion_tpu_torch.parallel.sharding import gather_many, param_dims

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with trainer.step_randomness(1, 0) as gen:
        metrics = trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    mesh, model = trainer.mesh, trainer.model
    dims = param_dims(model)
    named = list(model.named_parameters())
    whole = gather_many([(p.grad, dims[id(p)][1]) for _, p in named
                         if id(p) in dims], mesh.model_axis)
    grads = {n: (whole.pop(0) if id(p) in dims else p.grad).detach()
             .clone() for n, p in named}
    state = {k: v.detach().clone()
             for k, v in trainer.full_state_dict().items()}
    return ({k: float(v.sum()) for k, v in metrics.items()}, grads, state,
            step_s)


def _running(state) -> dict:
    """A state's BatchNorm running statistics."""
    return {k: v.detach().clone() for k, v in state.items()
            if ".running_" in k}


def adam_first_step_gap(torch, before, grads, after, opt) -> tuple:
    """The largest gap, over ``lr``, between each weight after the step and
    torch Adam's first update of it from ``grads`` (L2 added first, no
    moments yet), and its tensor. Adam's first step takes each element's
    gradient sign, so where a gradient is rounding noise two runs' weights
    differ by up to 2·lr however close their gradients; this checks that
    the mesh's weights followed its own summed gradients."""
    b1, b2 = opt.betas
    worst, where = 0.0, None
    for k, g in grads.items():
        p0 = before[k].to(g.device).float()
        g = g.float() + opt.weight_decay * p0
        m, v = (1 - b1) * g, (1 - b2) * g * g
        want = p0 - (opt.lr / (1 - b1)) * m / (
            v.sqrt() / math.sqrt(1 - b2) + 1e-8)
        gap = (after[k].float() - want).abs().max().item() / opt.lr
        if gap >= worst:
            worst, where = gap, k
    return worst, where


def _mesh_references(torch, cfg, trainer, batch, state) -> dict:
    """One process's step on ``batch`` and ``state`` (no mesh, in this
    rank): through the kernels, then the plain path and its second paths
    (``step_paths``); each run's metrics, gradients and running
    statistics."""
    from glfusion_tpu_torch.ops import tpavi_fused

    one = _mesh_model(torch, cfg, state).cuda()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel = _step_run(torch, cfg, trainer, one, batch, "pallas")
    step_s = time.perf_counter() - t0  # _step_run ends in a synchronize
    peak = torch.cuda.max_memory_allocated()
    kernel += (_running(one.state_dict()),)
    del one
    _free(torch)
    launches = tpavi_fused.fused_dot_nonlocal.launches
    plain = step_paths(torch, cfg, trainer, batch, state, STEP_TOL,
                       model=_mesh_model(torch, cfg), stats=True)
    check(tpavi_fused.fused_dot_nonlocal.launches == launches,
          "mesh: a plain path launched K1")
    return {"kernel": kernel, "plain": plain, "step_s": step_s,
            "peak_bytes": peak}


def mesh_rank(spec_path: str) -> None:
    """One rank of the mesh phase (``python3 chip_smoke.py --mesh-rank
    SPEC``, started by ``mesh_phase`` with the launcher's variables): each
    case's step on a mesh over the two ranks; then rank 0 alone runs one
    process's step on the same batch and state (no mesh) while rank 1
    waits, holds the two and writes the verdicts."""
    import torch

    sys.path.insert(0, str(ROOT))
    from glfusion_tpu_torch.parallel.sharding import (check_replicas_equal,
                                                      split_count)
    from glfusion_tpu_torch.train.train_state import (load_payload,
                                                      make_optimizer,
                                                      make_scheduler,
                                                      state_payload)
    from glfusion_tpu_torch.train.trainer import Trainer
    from glfusion_tpu_torch.utils.checkpoint import CheckpointManager
    from glfusion_tpu_torch.utils.cluster import (barrier,
                                                  initialize_distributed)

    spec = json.loads(Path(spec_path).read_text())
    t_start = time.perf_counter()
    initialize_distributed(port=spec["port"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    lead = rank == 0
    base = _mesh_config({}, spec["work"])
    _mesh_model(torch, base)  # the template
    state = check_state(torch, _MESH_TEMPLATE[0])
    lines, failures, refs, batch = [], [], {}, None
    timing = {"start_s": time.perf_counter() - t_start}
    for name, d, m, opts in MESH_CASES:
        t0 = time.perf_counter()
        cfg = _mesh_config(opts, f"{spec['work']}/{name}", d, m)
        trainer = Trainer(cfg, data_paths=spec["data_paths"],
                          model=_mesh_model(torch, cfg, state),
                          verbose=False)
        if batch is None:  # the global batch, the same on every rank
            host = next(trainer.train_loader.batches(MESH_BATCH, 1))
            with trainer.step_randomness(1, 0) as gen:
                batch = trainer.train_batch(host, trainer._cycle_clips(1),
                                            gen)
        _free(torch)
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        with kernel_recorder(torch) as rec:
            metrics, grads, after, step_s = _mesh_step(torch, trainer, batch)
        counts = _counts(torch)  # before the replays launch the stems again
        peak = torch.cuda.max_memory_allocated()
        # every K1 call in situ; the stems' (replays of each call's
        # backward, seconds a case) in the first case, where they are split
        situ = in_situ_verdict(
            {"k1": rec["k1"],
             "stem": [stem_replay(torch, r) for r in rec["stem"]
                      if "dy" in r and name == MESH_CASES[0][0]]}, STEP_TOL)
        differ = check_replicas_equal(trainer.model, trainer.mesh)
        mine = torch.tensor([counts[k] for k in sorted(counts)]
                            + [peak, float(situ["ok"]), float(bool(differ))],
                            dtype=torch.float64)
        every = torch.zeros(world, mine.numel(), dtype=torch.float64)
        every[rank] = mine
        torch.distributed.all_reduce(every)
        every = every.tolist()
        n = len(counts)
        saved = None
        if name == "m2":  # saved under (1, 2), restored by one process
            trainer.save(0)
            trainer.ckpt.wait()
            saved = state_payload(trainer.model, trainer.optimizer,
                                  trainer.scheduler)
        line = {"case": name, "mesh": trainer.mesh.shape,
                "step_s": step_s, "case_s": None,
                "peak_bytes_per_rank": [r[n] for r in every],
                "launches_per_rank": [dict(zip(sorted(counts), r[:n]))
                                      for r in every],
                "split_leaves": split_count(trainer.model),
                "in_situ_rank0": situ,
                "replicated_leaves_equal": not any(r[n + 2] for r in every)}
        if not all(r[n + 1] for r in every):
            failures.append(f"mesh {name}: a kernel call against its plain "
                            f"version in a rank: {situ['bad']}")
        if not line["replicated_leaves_equal"]:
            failures.append(f"mesh {name}: replicated leaves differ between "
                            f"ranks: {differ}")
        views = len(base.model.views)
        for r, c in enumerate(line["launches_per_rank"]):
            if not (c["fused_dot_nonlocal"] == 4 and all(
                    c[k] == 2 * views for k in c
                    if k != "fused_dot_nonlocal")):
                failures.append(f"mesh {name}: rank {r} launches {c}")
        del trainer
        _free(torch)
        barrier()
        if lead:  # one process's step on the same batch and state
            key = json.dumps(opts)
            t1 = time.perf_counter()
            if key not in refs:
                refs[key] = _mesh_references(torch, cfg, trainer_like(
                    cfg, spec), batch, state)
            line["reference_s"] = time.perf_counter() - t1
            ref = refs[key]
            plain = [(mm, g) for mm, g, _ in ref["plain"]]
            got = step_verdict(metrics, grads, plain, STEP_TOL)
            one = step_verdict(ref["kernel"][0], ref["kernel"][1], plain,
                               STEP_TOL)
            stats = step_verdict(metrics, _running(after),
                                 [(mm, st) for mm, _, st in ref["plain"]],
                                 STEP_TOL)
            gap = adam_first_step_gap(torch, state, grads, after, base.opt)
            line.update({
                "grad_ok": got["ok"], "grad_worst_ratio": got["worst_ratio"],
                "grad_worst_tensor": got["worst_ratio_tensor"],
                "grad_bad": got["bad"], "grad_n_bad": got["n_bad"],
                "loss_rel_err": got["loss_rel_err"],
                "one_process_step_s": ref["step_s"],
                "one_process_peak_bytes": ref["peak_bytes"],
                "one_process_worst_ratio": one["worst_ratio"],
                "one_process_worst_tensor": one["worst_ratio_tensor"],
                "plain_noise_max": got["plain_noise_max"],
                "running_stats_ok": stats["ok"],
                "running_stats_worst_ratio": stats["worst_ratio"],
                "adam_update_gap_over_lr": gap})
            if not got["ok"]:
                failures.append(f"mesh {name}: the sharded step against "
                                f"one process's plain path beyond its "
                                f"second paths' noise: {got['bad']}")
            if not stats["ok"]:
                failures.append(f"mesh {name}: BN running statistics: "
                                f"{stats['bad']}")
            if not gap[0] <= MESH_ADAM_GAP:
                failures.append(f"mesh {name}: the weights after the step "
                                f"against Adam's update of the summed "
                                f"gradients: {gap}")
            if saved is not None:
                ckpt = CheckpointManager(cfg.train.save_dir)
                payload, _ = ckpt.restore_latest()
                model = _mesh_model(torch, base).cuda()
                opt = make_optimizer(base, model.parameters())
                sched = make_scheduler(base, opt)
                load_payload(payload, model, opt, sched)
                diff = state_diff(torch, state_payload(model, opt, sched),
                                  saved)
                line["checkpoint_restored_bitwise"] = not diff
                line["checkpoint_leaves"] = _leaves(saved)
                if diff:
                    failures.append(f"mesh: the (1, 2) checkpoint restored "
                                    f"by one process differs at {diff[:5]}")
                del model, opt, sched, payload
            line["case_s"] = time.perf_counter() - t0
            lines.append(line)
        del grads, after, saved
        _free(torch)
        barrier()
    timing["ranks_s"] = time.perf_counter() - t_start
    if lead:
        Path(spec["out"]).write_text(json.dumps(
            {"lines": lines, "failures": failures, "timing": timing}))
    barrier()
    torch.distributed.destroy_process_group()


def trainer_like(cfg, spec):
    """What ``_step_run`` and ``step_paths`` read of a trainer: the step's
    randomness (``Trainer.step_randomness``) on this rank's card."""
    import types

    import torch

    from glfusion_tpu_torch.train.trainer import step_randomness

    dev = torch.device("cuda", torch.cuda.current_device())
    return types.SimpleNamespace(step_randomness=lambda e, s: step_randomness(
        cfg.train.seed, e, s, dev))


def mesh_phase(torch, data_paths) -> dict:
    """Two ranks share the one card over gloo, through ``Trainer``'s
    sharded path: each case's step held against one process's on the same
    global batch and state, as the train phase holds the kernels' step
    (``step_verdict``: the plain path, its second paths' noise); the BN
    running statistics the same way; the weights against Adam's update of
    the summed gradients; the replicated leaves bit for bit equal on both
    ranks; K1 and the stem kernels launched on every rank and checked in
    situ there; the (1, 2) checkpoint restored by one process bit for
    bit. Returns the ranks' launches, summed."""
    import socket

    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    _free(torch)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spec = {"port": port, "out": str(tmp / "out.json"),
            "work": str(tmp / "ranks"), "data_paths": data_paths}
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PMI_", "OMPI_"))}
    env.update(PMI_SIZE="2", MASTER_ADDR="127.0.0.1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
         str(tmp / "spec.json")], env={**env, "PMI_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    errs = []
    try:
        for r, proc in enumerate(procs):
            try:
                _, err = proc.communicate(
                    timeout=max(1.0, MESH_TIMEOUT_S
                                - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                errs.append(f"rank {r} did not end in {MESH_TIMEOUT_S} s")
                continue
            if proc.returncode != 0:
                errs.append(f"rank {r} exited {proc.returncode}: "
                            f"{err[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(not errs, "mesh: " + " | ".join(errs))
    got = json.loads(Path(spec["out"]).read_text())
    for line in got["lines"]:
        emit("mesh", **line)
    emit("mesh_seconds", **got["timing"], total_s=time.perf_counter() - t0,
         nvidia_smi=nvidia_smi_line(), backend="gloo, two ranks on one card")
    check(not got["failures"], " | ".join(got["failures"]))
    check(len(got["lines"]) == len(MESH_CASES), "mesh: cases missing")
    shutil.rmtree(tmp, ignore_errors=True)
    launches = [c for line in got["lines"]
                for c in line["launches_per_rank"]]
    return {k: int(sum(c[k] for c in launches)) for k in launches[0]}


def _du(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def resume_agreement(torch, u, reruns, r) -> dict:
    """Every tensor of r against u, allowed RESUME_NOISE × the largest of
    the reruns' own differences from u + RESUME_FLOOR in relative norm, and
    bitwise where every rerun is bitwise u. Returns the verdict, the worst
    ratios with (elements, r's error, the reruns' noise), and the noise's
    quantiles over the tensors."""
    def rel(a, ref64):
        return ((a.double() - ref64).norm()
                / ref64.norm().clamp_min(1e-30)).item()

    ratio, bad, errs = {}, [], {}
    for k, ref in u.items():
        ref64 = ref.double()
        e_r = rel(r[k], ref64)
        noise = max(rel(x[k], ref64) for x in reruns)
        allow = RESUME_NOISE * noise + RESUME_FLOOR
        ratio[k], errs[k] = e_r / allow, (ref.numel(), e_r, noise)
        exact = all(torch.equal(x[k], ref) for x in reruns)
        if (exact and not torch.equal(r[k], ref)) or not e_r <= allow:
            bad.append((k, e_r, noise))
    worst = sorted(ratio, key=ratio.get, reverse=True)[:8]
    noise = sorted(e for _, _, e in errs.values() if e > 0)
    return {"ok": not bad, "bad": bad[:5], "n_bad": len(bad),
            "worst_ratio": ratio[worst[0]], "worst_tensor": worst[0],
            "worst": [(k, *errs[k], ratio[k]) for k in worst],
            "noise_quantiles": [noise[int(q * (len(noise) - 1))]
                                for q in (0, 0.1, 0.5, 0.9, 1) if noise],
            "tensors": len(ratio),
            "bitwise_reruns": sum(all(torch.equal(x[k], u[k])
                                      for x in reruns) for k in u),
            "bitwise_r": sum(torch.equal(r[k], u[k]) for k in u)}


def state_diff(torch, a, b, path: str = "") -> list:
    """The paths at which two nested states differ: tensors by dtype,
    shape and bits, anything else by ``==``."""
    if isinstance(a, torch.Tensor):
        same = isinstance(b, torch.Tensor) and same_bits(torch, a,
                                                         b.to(a.device))
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [path]
        return [d for k in a for d in state_diff(torch, a[k], b[k],
                                                 f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in state_diff(torch, x, y, f"{path}/{i}")]
    return [] if a == b else [path]


def _leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_leaves(v) for v in tree)
    return 1


def _by_part(paths) -> dict:
    """Differing paths counted by their top-level part."""
    out = {}
    for p in paths:
        part = p.split("/")[1]
        out[part] = out.get(part, 0) + 1
    return out


def lifecycle_phase(torch, data_paths) -> dict:
    """The training lifecycle and the output modes on the full-width
    flagship (float32, TF32 off, K1 and a ``FusedIEKDStem`` in every view):
    U trains 2 epochs; U′, U″, U‴ again (the noise yardstick); S is
    stopped in epoch 0 (``request_stop``) and R resumes it from its
    checkpoint in a fresh ``Trainer`` to epoch 2. R's restored state must
    be S's bit for bit (``state_diff``), and R's end state lie within
    ``resume_agreement`` of U's. Negative controls: a weights-only restore
    (the reference's file alone) and a restore with the schedule's epoch
    reset must fail the restore check, and a restore with Adam's moments
    zeroed the end-state check. Then the sweep over U's epochs,
    ``--torch-ckpt`` on U's last file, infer, visual and serve on R's
    weights. The checkpoints (up to 4.4 GB) are removed also when a check
    fails."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lifecycle_"))
    try:
        return _lifecycle(torch, data_paths, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _lifecycle(torch, data_paths, tmp: Path) -> dict:
    import numpy as np

    from glfusion_tpu_torch.config import Config
    from glfusion_tpu_torch.data.nifti import read_nifti_py
    from glfusion_tpu_torch.experiments import stem_fused
    from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
    from glfusion_tpu_torch.models import GlobalAndLocal
    from glfusion_tpu_torch.ops.tpavi_fused import fused_dot_nonlocal
    from glfusion_tpu_torch.serve import serve_test_clips
    from glfusion_tpu_torch.train.train_state import (make_scheduler,
                                                      state_payload)
    from glfusion_tpu_torch.train.trainer import Trainer

    kernels = stem_fused.KERNELS
    base = Config()
    base = base.replace(
        model=dataclasses.replace(base.model, use_pallas_fusion=True),
        data=dataclasses.replace(base.data,
                                 synthetic_num_patients=TRAIN_PATIENTS,
                                 train_repeat=TRAIN_REPEAT),
        train=dataclasses.replace(base.train, num_epochs=2,
                                  eval_every_epochs=0))
    torch.manual_seed(0)
    model = GlobalAndLocal(base.model)
    swap_in_fused_stems(model)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    disk = [0]

    def make(tag, save_every):
        model.load_state_dict(init)
        cfg = base.replace(train=dataclasses.replace(
            base.train, save_every_epochs=save_every,
            save_dir=str(tmp / tag / "ckpt"), log_dir=str(tmp / tag / "log")))
        tr = Trainer(cfg, data_paths=data_paths, model=model, verbose=False)
        tr.draws = []
        inner = tr.train_step

        def step(batch, gen):
            # the step's seed, its crops and its next (cycle) draw
            probe = torch.Generator(device="cuda")
            probe.set_state(gen.get_state())
            tr.draws.append({
                "epoch": tr.epoch, "seed": gen.initial_seed(),
                "images": batch["images"].clone(),
                "next_draw": torch.rand((), device="cuda",
                                        generator=probe).item(),
                "lr": tr.optimizer.param_groups[0]["lr"]})
            return inner(batch, gen)

        tr.train_step = step
        return tr

    def weights():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def free():
        # a Trainer and its step wrapper refer to each other: collect the
        # cycle, so its Adam state leaves the card
        gc.collect()
        torch.cuda.empty_cache()

    for k in kernels:
        k.launches = 0
    fused_dot_nonlocal.launches = 0
    t_phase = time.perf_counter()

    # ---- U: 2 epochs, a checkpoint each
    tr = make("U", 1)
    t0 = time.perf_counter()
    tr.train()
    u_train_s = time.perf_counter() - t0
    u, u_draws, saves = weights(), tr.draws, list(tr.ckpt.saves)
    check([s["epoch"] for s in saves] == [0, 1], f"U saved {saves}")
    disk[0] = max(disk[0], _du(tmp))
    clip = next(tr.eval_clips(sorted(tr.test_infos)[:1]))
    clip_batch = {"images": tr._to_device(clip["images"]),
                  "masks": tr._to_device(clip["masks"])}
    u_logits = tr.eval_step(clip_batch)["logits"].clone()

    # ---- the sweep over U's epochs, then U's state is put back
    val = {}
    validate = tr.validation_and_test

    def recorded():
        res = validate()
        val[tr.epoch] = float(np.mean([v["dice"] for v in
                                       res["Inner-val"]["views"].values()]))
        return res

    tr.validation_and_test = recorded
    t0 = time.perf_counter()
    best = tr.sweep_checkpoints()
    sweep_s = time.perf_counter() - t0
    check(sorted(val) == [0, 1] and best["epoch"] == max(val, key=val.get),
          f"sweep picked {best['epoch']} of {val}")
    check(tr.epoch == 2 and all(torch.equal(v, u[k]) for k, v in
                                model.state_dict().items()),
          "the sweep did not put U's state back")

    # ---- --torch-ckpt on U's last net file gives U's logits
    model.load_state_dict(init)
    tr.load_torch_checkpoint(str(tr.checkpoint_path(1)))
    ck_logits = tr.eval_step(clip_batch)["logits"]
    torch_ckpt_err = rel_max(ck_logits, u_logits)
    check(torch_ckpt_err <= 1e-6, f"--torch-ckpt logits {torch_ckpt_err}")
    del tr
    free()
    shutil.rmtree(tmp / "U")

    # ---- U′, U″, U‴: the same 2 epochs again, the noise yardstick
    reruns = []
    for i in range(RESUME_RERUNS):
        tr = make(f"U{i + 2}", 0)
        tr.train()
        reruns.append(weights())
        del tr
        free()

    # ---- S: asked to stop in epoch 0; only the stop writes a checkpoint
    tr = make("S", 100)
    inner_s = tr.train_step

    def stop_in_epoch_0(batch, gen):
        tr.request_stop()
        return inner_s(batch, gen)

    tr.train_step = stop_in_epoch_0
    tr.train()
    check(tr.epoch == 1 and tr.ckpt.all_steps() == [0],
          f"stop: epoch {tr.epoch}, saved {tr.ckpt.all_steps()}")
    stop_save = tr.ckpt.saves[0]
    steps0 = len(tr.draws)
    disk[0] = max(disk[0], _du(tmp))
    s_state = copy.deepcopy(state_payload(model, tr.optimizer, tr.scheduler))
    del tr
    free()

    def restored_diff(tr):
        return state_diff(torch, s_state, state_payload(
            model, tr.optimizer, tr.scheduler))

    def lr_diff(tr):
        return tr.optimizer.param_groups[0]["lr"] != u_lr1[0]

    u_lr1 = [d["lr"] for d in u_draws if d["epoch"] == 1]

    # ---- R: a fresh Trainer resumes S and trains to epoch 2
    tr = make("S", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(tr.load_latest(), "R found no checkpoint")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    # weights, BN buffers, Adam's moments and steps, the schedule: S's bits
    restore = restored_diff(tr)
    check(not restore, f"R's restored state differs from S's at "
          f"{len(restore)} paths: {restore[:5]}")
    adam_steps = {int(st["step"]) for st in tr.optimizer.state.values()}
    check(tr.epoch == 1 and adam_steps == {steps0} and not lr_diff(tr),
          f"restored epoch {tr.epoch}, Adam steps {adam_steps}, lr "
          f"{tr.optimizer.param_groups[0]['lr']} (U: {u_lr1[0]})")
    tr.train()
    r = weights()
    u_ep1 = [d for d in u_draws if d["epoch"] == 1]
    check(len(u_ep1) == len(tr.draws) > 0 and all(
        a["seed"] == b["seed"] and a["next_draw"] == b["next_draw"]
        and a["lr"] == b["lr"] and torch.equal(a["images"], b["images"])
        for a, b in zip(u_ep1, tr.draws)),
        "epoch 1's seeds, crops or cycle draws differ between U and R")
    agreement = resume_agreement(torch, u, reruns, r)
    check(agreement["ok"], f"resume check: {agreement}")
    # the same check against each rerun alone (not a verdict)
    single = [resume_agreement(torch, u, [x], r)["worst_ratio"]
              for x in reruns]

    # ---- outputs on R's weights: infer, visual, serve
    n_clips, views = len(tr.test_infos), len(base.model.views)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_infer = tr.infer(str(tmp / "infer"))
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_png = tr.test_visualize("chip_smoke", str(tmp / "visual"))
    visual_s = time.perf_counter() - t0
    stats = serve_test_clips(tr, out_dir=str(tmp / "serve"), depth=2,
                             threads=4)
    infer_files = sorted((tmp / "infer").glob("*.nii.gz"))
    frames = 0
    flips, flip_logit_max = 0, 0.0
    for f in infer_files:
        a = read_nifti_py(f)
        b = read_nifti_py(tmp / "serve" / f.name)
        check(a.dtype == np.uint8 and a.shape == b.shape and a.shape[0] == 5,
              f"{f.name}: {a.dtype} {a.shape} against {b.shape}")
        frames += a.shape[-1]
        differ = a != b
        if differ.any():
            cid, view = f.name[len("pred_"):-len(".nii.gz")].rsplit("_v", 1)
            c = next(tr.eval_clips([cid]))
            logits = tr.eval_step({
                "images": tr._to_device(c["images"]),
                "masks": tr._to_device(c["masks"])})["logits"]
            lg = logits[base.model.views.index(view)].permute(
                3, 1, 2, 0).cpu().numpy()
            flips += int(differ.sum())
            flip_logit_max = max(flip_logit_max,
                                 float(np.abs(lg[differ]).max()))
    pngs = len(list((tmp / "visual").rglob("pred_*.png")))
    check(n_infer == stats["written"] == len(infer_files) == n_clips * views
          and stats["clips"] == n_clips,
          f"infer {n_infer}, serve {stats}, files {len(infer_files)}")
    check(n_png == pngs == frames, f"{n_png} PNGs, {pngs} files, "
          f"{frames} frames")
    check(flip_logit_max < MASK_FLIP_LOGIT,
          f"infer and serve masks differ at |logit| {flip_logit_max}")
    disk[0] = max(disk[0], _du(tmp))
    del tr
    free()

    # ---- negative controls. Weights only (what the reference's file
    # holds): the restore check must see Adam's state and the schedule lost
    tr = make("S", 0)
    tr.load_torch_checkpoint(str(tr.checkpoint_path(0)))
    lost = _by_part(restored_diff(tr))
    check(set(lost) == {"optimizer", "scheduler"} and lr_diff(tr),
          f"weights-only restore: differing parts {lost}")
    del tr
    free()

    # the schedule's epoch reset after the restore: the restore and
    # learning-rate checks must fail it. Not trained on: its epoch-1
    # learning rate is 0.1 % off, which the end-state check does not see
    # (PERF.md section 6)
    tr = make("S", 0)
    check(tr.load_latest(), "scheduler control found no checkpoint")
    tr.scheduler = make_scheduler(tr.cfg, tr.optimizer)  # epoch 0 again
    sched_lost = _by_part(restored_diff(tr))
    check("scheduler" in sched_lost and lr_diff(tr),
          f"schedule reset: differing parts {sched_lost}")
    del tr
    free()

    # Adam's moments zeroed after the restore: the end-state check must
    # fail it
    tr = make("S", 0)
    check(tr.load_latest(), "negative control found no checkpoint")
    for st in tr.optimizer.state.values():
        st["exp_avg"].zero_()
        st["exp_avg_sq"].zero_()
    adam_lost = _by_part(restored_diff(tr))
    tr.train()
    control = resume_agreement(torch, u, reruns, weights())
    check(not control["ok"], "the negative control passed the resume check")
    launches = {k.__name__: k.launches for k in kernels}
    launches["fused_dot_nonlocal"] = fused_dot_nonlocal.launches
    check(all(n > 0 for n in launches.values()),
          f"lifecycle launches {launches}")
    del tr
    free()

    rec = dict(
        nvidia_smi=nvidia_smi_line(), phase_s=time.perf_counter() - t_phase,
        u_train_s=u_train_s, steps_per_epoch=steps0,
        checkpoint_bytes=saves[-1]["bytes"],
        save_blocking_s=[s["blocking_s"] for s in saves + [stop_save]],
        save_write_s=[s["write_s"] for s in saves + [stop_save]],
        load_latest_s=load_s, sweep_s=sweep_s,
        sweep_s_per_epoch=sweep_s / len(val), sweep_val_dice=val,
        sweep_best=best["epoch"], torch_ckpt_rel_err=torch_ckpt_err,
        restore_compared=_leaves(s_state),
        resume=agreement, resume_single_rerun_worst=single,
        control_weights_only={"restore_differing": lost},
        control_scheduler={"restore_differing": sched_lost},
        negative_control={"restore_differing": adam_lost, **{
            k: control[k] for k in ("ok", "n_bad", "worst_ratio",
                                    "worst_tensor", "worst")}},
        infer_clips_per_s=n_clips / infer_s, infer_s=infer_s,
        serve_clips_per_s=stats["clips_per_s"], serve_s=stats["wall_s"],
        visual_s=visual_s, pngs=n_png, mask_flips=flips,
        mask_flip_logit_max=flip_logit_max, disk_peak_bytes=disk[0],
        launches=launches)
    emit("lifecycle", **rec)
    print(f"lifecycle: restore check: R's state is S's at all "
          f"{rec['restore_compared']} leaves; the weights-only restore "
          f"differs at {lost}, the schedule reset at {sched_lost}, both "
          f"with another learning rate: both failed as they must",
          flush=True)
    print(f"lifecycle: negative control (Adam's moments zeroed) failed the "
          f"resume check as it must: {control['n_bad']} tensors, worst "
          f"ratio {control['worst_ratio']:.3g}", flush=True)
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if not (ROOT / "glfusion_tpu_torch" / "csrc").is_dir():
        raise SystemExit(
            f"chip_smoke: {ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    smi = nvidia_smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvidia_smi=smi,
         device=torch.cuda.get_device_name(0),
         tf32="off for matmuls and cuDNN in every comparison")

    from concurrent.futures import ThreadPoolExecutor

    from glfusion_tpu_torch import native
    from glfusion_tpu_torch.ops import _build

    sources = ("tpavi_fused", "stem_fused")
    t0 = time.perf_counter()
    todo = [n for n in sources if not _build.library_path(n).exists()]
    tools = decoder_toolchain()
    # one nvcc per source and g++ for the NIfTI decoder, all at once; with
    # g++ and zlib there, a failed decoder build fails the run
    cxx = (tools["gxx"] and tools["zlib_h"]
           and not native.library_path().exists())
    with ThreadPoolExecutor(len(sources) + 1) as ex:
        decoder = ex.submit(native.build) if cxx else None
        list(ex.map(_build.build, todo))
        if decoder is not None:
            decoder.result()
    for name in sources:
        _build.load(name)
    check(native.native_available() or not (tools["gxx"] and tools["zlib_h"]),
          f"the NIfTI decoder does not load: {native.build_error()}")
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln] for n in sources}
    emit("build", seconds=time.perf_counter() - t0, compiled=todo,
         decoder=dict(built=native.native_available(), compiled=bool(cxx),
                      why_not=native.build_error(), **tools),
         ptxas=ptxas)

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, *args)
        _free(torch)
        seconds[name] = time.perf_counter() - t0
        return out

    records = timed("kernel", kernel_phase)
    timed("kernel_backward", kernel_backward_phase)
    stem_records = timed("stem", stem_phase)
    timed("aspp", aspp_phase)
    serve_launches = timed("serve", serve_phase)  # ClipPipeline, http, export
    train = timed("train", train_phase)
    paths = train["data_paths"]
    # each returns its launches
    more = [timed(name, fn, paths) for name, fn in (
        ("temporal", temporal_phase), ("cps", cps_phase),
        ("checkify", checkify_phase), ("train_bf16", train_bf16_phase),
        ("lifecycle", lifecycle_phase), ("variants", variants_phase))]
    more.append(timed("mesh", mesh_phase, paths))
    timed("zoo", zoo_phase, paths)  # runs no kernel (asserted)
    timed("regression", regression_phase)  # runs no kernel (asserted)
    emit("seconds", **seconds, total=sum(seconds.values()))

    main_rec = records[(SERVE_SHAPE, "float32")]
    k1_launches = (serve_launches + train["train"]["fused_dot_nonlocal"]
                   + train["validation"]["fused_dot_nonlocal"]
                   + sum(c["fused_dot_nonlocal"] for c in more))
    kernels = [{
        "name": "tpavi_fused_dot_nonlocal",
        "route": "cuda",
        "source": "glfusion_tpu_torch/csrc/tpavi_fused.cu",
        "replaces": "glfusion_tpu/ops/tpavi_pallas.py:50",
        "launches": k1_launches,
        "shape": main_rec["shape"],
        "dtype": main_rec["dtype"],
        "max_abs_err": main_rec["max_abs_err"],
        "order": main_rec["order"],
        "stage1_ms": main_rec["stage1_ms"],
        "stage2_ms": main_rec["stage2_ms"],
        "ms": main_rec["kernel_ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
        "bmm_ms": main_rec["bmm_ms"],
        "reassoc_ms": main_rec["reassoc_ms"],
    }]
    stem = stem_records[(40, "float32")]
    replaces = {
        "stem_stats": "experiments/stem_pallas.py:289 (and "
                      "experiments/stem_banded.py:172)",
        "stem_norm_pool": "experiments/stem_pallas.py:310 (and "
                          "experiments/stem_banded.py:192)",
        "stem_bwd1": "experiments/stem_pallas.py:325",
        "stem_bwd2": "experiments/stem_pallas.py:356",
        # the second pass of K2d's function: dx summed in a fixed order
        "stem_dx_reduce": "experiments/stem_pallas.py:356",
    }
    abs_err = {"stem_stats": stem["err"]["max_abs_stats"],
               "stem_norm_pool": stem["err"]["max_abs_out"],
               "stem_bwd1": max(stem["err"]["max_abs_dgamma"],
                                stem["err"]["max_abs_dbeta"]),
               "stem_bwd2": stem["err"]["max_abs_bwd2"],
               "stem_dx_reduce": stem["err"]["max_abs_dx_reduce"]}
    for name, where in replaces.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "glfusion_tpu_torch/csrc/stem_fused.cu",
            "replaces": where,
            "launches": (train["train"][name] + train["validation"][name]
                         + sum(c[name] for c in more)),
            "shape": [stem["batch"], 1, STEM_HW, STEM_HW, STEM_C],
            "dtype": stem["dtype"], "max_abs_err": abs_err[name],
            "ms": stem["ms"][name], "plain_ms": stem["plain_ms"][name],
            "bound_ms": stem["bound_ms"][name],
            "bound_by": stem["bound_by"][name], "library_ms": None,
        })
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} never launched")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of the mesh phase
        mesh_rank(sys.argv[2])
    else:
        main()
