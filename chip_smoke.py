#!/usr/bin/env python3
"""Smoke check of the PyTorch port (``glfusion_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises and the exit code is
nonzero:

  env     torch and CUDA versions, the card's name and power limit; TF32 is
          switched off for matmuls and cuDNN, for every comparison below.
  build   nvcc builds the port's CUDA kernels (``tpavi_fused.cu``,
          ``stem_fused.cu``) from the checkout's sources, in parallel.
  kernel  the TPAVI kernel against its plain PyTorch version at small,
          ragged and serving shapes, float32 and bfloat16, on contiguous and
          on strided (split-projection) operands, with its time, the plain
          version's, a cuBLAS yardstick's and the card's bound.
  kernel_backward  the TPAVI kernel's autograd backward at the train
          shapes (8 and 40, 2352, 1024) against autograd of the plain
          version: dθ, dφ, dg.
  stem    the four fused-stem kernels against the plain (cuDNN) stem at
          B = 8 and 40, 112², C = 64, float32 and bfloat16: pooled output,
          batch mean and variance, all five gradients, eval output; a
          per-view run with three views' own weights; each kernel's time,
          bound and the plain composite's time.
  serve   the full-width flagship (``Config().model`` with
          ``use_pallas_fusion=True``, random weights from seed 0) serves four
          NIfTI clips through ``ClipPipeline``; the masks and the kernel's
          launch count are checked, and a 112² and the 160² clip are held
          against the plain-torch naive and reassociated attention orders.
  profile where one serving forward's device time goes (torch.profiler);
          printed before the serve line.
  train   the full-width flagship trains through ``Trainer`` with the TPAVI
          kernel and a ``FusedIEKDStem`` in every view on a small synthetic
          corpus (one epoch of a few steps), then validates; launch counts,
          finite losses, s/step, peak memory, a profiled step and the
          validation Dice; one step through the kernels held against the
          same step through the plain versions; the saved checkpoint loads
          back.

The last lines are the kernels' record, the card's ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, it
exits nonzero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks, dense: float32 outside the tensor cores,
# bfloat16 tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

KERNEL_SHAPES = [  # (B, N, C'), dtypes
    ((2, 75, 32), ("float32",)),
    ((2, 192, 128), ("float32",)),
    ((40, 2352, 1024), ("float32", "bfloat16")),  # 112² clips
    ((40, 4800, 1024), ("float32", "bfloat16")),  # 160² clips
]
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}  # max|y-ref| / max|ref|
SERVE_SHAPE = (40, 2352, 1024)
CLIPS = [("c0", 112, 40), ("c1", 112, 40), ("c2", 112, 27), ("c3", 160, 40)]
# the TPAVI kernel's train shapes: the supervised pass (8 frames) and the
# cycle pass (40-frame clips), 3 views of 28² tokens, C' = 1024
K1_TRAIN_SHAPES = [(8, 2352, 1024), (40, 2352, 1024)]
K1_GRAD_TOL = 1e-4  # max|d − ref| / max|ref|, float32
# the stem at the train step's batches: 8 supervised frames, 40 clip frames
STEM_BATCHES = (8, 40)
STEM_HW, STEM_C = 112, 64
STEM_TOL = {  # relative max error of the output and the statistics, and
    # relative norm error of the gradients; bf16 holds one output rounding
    "float32": {"out": 1e-4, "stat": 1e-5, "grad": 1e-3},
    "bfloat16": {"out": 1e-2, "stat": 1e-5, "grad": 1e-2},
}
# train phase: 4 synthetic patients (2 train, 1 val, 1 test), each train
# patient repeated 16 times an epoch → 4 steps of batch 8
TRAIN_PATIENTS, TRAIN_REPEAT = 4, 16
STEP_TOL = {"loss": 1e-4, "grad": 1e-3}  # relative; see step_agreement


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
    """The kernel against its plain version: (max|y-ref|, that / max|ref|)."""
    from glfusion_tpu_torch.ops.tpavi_fused import (fused_dot_nonlocal,
                                                    fused_dot_nonlocal_plain)

    y = fused_dot_nonlocal(theta, phi, g)
    torch.cuda.synchronize()
    ref = fused_dot_nonlocal_plain(theta, phi, g).float()
    check(y.dtype == theta.dtype and y.shape == theta.shape,
          f"kernel output {y.dtype} {tuple(y.shape)}")
    abs_err = (y.float() - ref).abs().max().item()
    return abs_err, abs_err / ref.abs().max().item()


def kernel_phase(torch):
    from glfusion_tpu_torch.ops.nonlocal_attn import dot_nonlocal_attention
    from glfusion_tpu_torch.ops.tpavi_fused import (fused_dot_nonlocal,
                                                    fused_dot_nonlocal_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    records = {}
    for (b, n, c), dtypes in KERNEL_SHAPES:
        for dt_name in dtypes:
            dt = getattr(torch, dt_name)
            theta, phi, g = (torch.randn(b, n, c, device="cuda",
                                         generator=gen).to(dt)
                             for _ in range(3))
            abs_err, rel_err = kernel_error(torch, theta, phi, g)
            check(math.isfinite(rel_err) and rel_err <= KERNEL_TOL[dt_name],
                  f"kernel {(b, n, c)} {dt_name}: relative error {rel_err} "
                  f"> {KERNEL_TOL[dt_name]}")
            # the eval path's operands: strided views of one (B, N, 3C')
            # projection, passed with their row stride 3C'
            split = torch.randn(b, n, 3 * c, device="cuda",
                                generator=gen).to(dt).split(c, dim=-1)
            _, strided_rel_err = kernel_error(torch, *split)
            check(strided_rel_err <= KERNEL_TOL[dt_name],
                  f"kernel {(b, n, c)} {dt_name}, strided operands: relative "
                  f"error {strided_rel_err} > {KERNEL_TOL[dt_name]}")
            del split
            reps = 10
            kernel_ms = time_ms(torch, lambda: fused_dot_nonlocal(
                theta, phi, g), reps)
            plain_ms = time_ms(torch, lambda: fused_dot_nonlocal_plain(
                theta, phi, g), reps)
            # cuBLAS naive chain in the input type: a yardstick only, the
            # port never calls it
            library_ms = time_ms(torch, lambda: torch.bmm(
                torch.bmm(theta, phi.transpose(1, 2)) / n, g), reps)
            reassoc_ms = time_ms(torch, lambda: dot_nonlocal_attention(
                theta, phi, g, impl="reassoc"), reps)
            # The function needs two products in the cheaper order:
            # 4·B·N·C'·min(N, C') FLOP (the naive order, 4·B·N²·C', is
            # printed beside it).
            peak = PEAK_FLOPS[dt_name]
            t_ops = 4 * b * n * c * min(n, c) / peak * 1e3
            t_bytes = 4 * b * n * c * theta.element_size() / PEAK_BYTES * 1e3
            rec = {
                "shape": [b, n, c], "dtype": dt_name,
                "rel_err": rel_err, "max_abs_err": abs_err,
                "strided_rel_err": strided_rel_err,
                "tol": KERNEL_TOL[dt_name], "kernel_ms": kernel_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "naive_order_bound_ms": max(4 * b * n * n * c / peak * 1e3,
                                            t_bytes),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "reassoc_ms": reassoc_ms,
            }
            records[((b, n, c), dt_name)] = rec
            emit("kernel", **rec)
            del theta, phi, g
            torch.cuda.empty_cache()
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

    with tempfile.TemporaryDirectory() as tmp:
        clips = write_clips(Path(tmp), views)
        t0 = time.perf_counter()
        decoded = {cid: pipe.decode_paths((cid, paths))[1]
                   for cid, paths in clips}
        decode_s = time.perf_counter() - t0  # all clips, one thread
        # warm-up at both spatial sizes (cuDNN picks its algorithms)
        for hw in sorted({hw for _, hw, _ in CLIPS}):
            pipe.predict_one(np.zeros(
                (len(views), cfg.data.clip_length, hw, hw, 1), np.float32))
        torch.cuda.synchronize()

        # ---- the main path, counted
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
    images, _ = pipe._pad_clip(decoded["c0"])
    x = torch.from_numpy(images).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: model(x), reps=3, warmup=1)
        x160 = torch.from_numpy(pipe._pad_clip(decoded["c3"])[0]).cuda()
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
            torch, model, model_re, pipe._pad_clip(decoded[cid])[0],
            served[i][1], t_true)
    with torch.inference_mode():
        profile_phase(torch, lambda: model(x))
    emit("serve", clips=len(served), frames=frames, wall_s=wall,
         clips_per_s=len(served) / wall, frames_per_s=frames / wall,
         view_frames_per_s=frames * len(views) / wall,
         yield_s=yield_s, decode_s_all_clips=decode_s,
         enqueue_stage_s=stages,
         forward_ms_median_112=fwd_ms, forward_ms_160=fwd_ms_160,
         max_memory_allocated=peak,
         kernel_launches=launches, agreement=agreement)
    return launches


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


def _category(name: str) -> str:
    low = name.lower()
    if "fused_dot_nonlocal" in low:
        return "tpavi_kernel"
    if any(k in low for k in ("stats_kernel", "norm_pool_kernel",
                              "bwd1_kernel", "bwd2_kernel")):
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


def stem_phase(torch) -> dict:
    import torch.nn.functional as F

    from glfusion_tpu_torch.experiments.stem_fused import (
        _chan, batch_moments, fused_stem_eval_plain, fused_stem_train_plain,
        geometry, stem_bwd1, stem_bwd2, stem_norm_pool, stem_stats)

    gen = torch.Generator(device="cuda").manual_seed(3)
    records = {}
    for b in STEM_BATCHES:
        for dt_name in ("float32", "bfloat16"):
            dt = getattr(torch, dt_name)
            inputs = _stem_inputs(torch, gen, b, dt)
            hc, wc, hp, wp, slabs = geometry(STEM_HW, STEM_HW)
            dy = torch.randn(b, STEM_C, hp, wp, device="cuda",
                             generator=gen).to(dt)
            err = stem_check(torch, inputs, dy, STEM_TOL[dt_name])
            # each kernel alone, and the plain composites
            x, w, bias, gamma, beta = inputs
            w49 = w.reshape(STEM_C, 49).contiguous()
            mean, var = batch_moments(stem_stats(x, w49, _chan(
                STEM_C, x.device, bias)))
            inv = torch.rsqrt(var + 1e-5)
            a = gamma * inv
            chan = _chan(STEM_C, x.device, bias, a, beta, mean, inv,
                         torch.zeros_like(a), torch.zeros_like(a))
            ms = {
                "stem_stats": time_ms(torch, lambda: stem_stats(x, w49, chan)),
                "stem_norm_pool": time_ms(
                    torch, lambda: stem_norm_pool(x, w49, chan)),
                "stem_bwd1": time_ms(torch, lambda: stem_bwd1(x, w49, chan,
                                                              dy)),
                "stem_bwd2": time_ms(torch, lambda: stem_bwd2(x, w49, chan,
                                                              dy)),
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
                # stands beside both backward kernels
                "stem_bwd1": bwd_plain, "stem_bwd2": bwd_plain,
            }
            conv = 2 * b * hc * wc * STEM_C * 49
            isz = x.element_size()
            x_bytes, out_bytes = b * STEM_HW * STEM_HW * isz, \
                b * STEM_C * hp * wp * isz
            part = b * slabs * STEM_C * 4
            work = {  # (FLOP, bytes) the function of each kernel needs
                "stem_stats": (conv, x_bytes + 3 * part),
                "stem_norm_pool": (conv, x_bytes + out_bytes),
                "stem_bwd1": (conv, x_bytes + out_bytes + 2 * part),
                # z (for x̂ and the routing), dW and dx: three conv products
                "stem_bwd2": (3 * conv, x_bytes + out_bytes
                              + b * STEM_HW * STEM_HW * 4 + part * 50),
            }
            bound = {}
            for k, (flop, nbytes) in work.items():
                t_ops = flop / PEAK_FLOPS["float32"] * 1e3
                t_bytes = nbytes / PEAK_BYTES * 1e3
                bound[k] = (max(t_ops, t_bytes),
                            "operations" if t_ops >= t_bytes else "bytes")
            rec = {"batch": b, "dtype": dt_name, "hw": STEM_HW, "c": STEM_C,
                   "err": err, "tol": STEM_TOL[dt_name], "ms": ms,
                   "plain_ms": plain_ms,
                   "bound_ms": {k: v[0] for k, v in bound.items()},
                   "bound_by": {k: v[1] for k, v in bound.items()}}
            records[(b, dt_name)] = rec
            emit("stem", **rec)
            del inputs, dy, ins_p, out_p
            torch.cuda.empty_cache()

    # per view, each with its own weights, as the flagship runs it: three
    # FusedIEKDStem modules, each held against the plain stem
    per_view = {}
    for v in ("1", "3", "4"):
        inputs = _stem_inputs(torch, gen, STEM_BATCHES[0], torch.float32)
        dy = torch.randn(STEM_BATCHES[0], STEM_C, 55, 55, device="cuda",
                         generator=gen)
        per_view[v] = stem_check(torch, inputs, dy, STEM_TOL["float32"])
    emit("stem_per_view", views=per_view)
    return records


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _tapwise_stem_class(torch):
    nn, F = torch.nn, torch.nn.functional

    class TapwiseStem(nn.Sequential):
        """The plain IEKD stem with its conv summed tap by tap (49
        multiply-adds, another order than cuDNN's): a second plain path."""

        def __init__(self, c):
            super().__init__(nn.Conv2d(1, c, 7, padding=2),
                             nn.BatchNorm2d(c))

        def forward(self, x):
            conv, bn = self[0], self[1]
            h, w = x.shape[2] - 2, x.shape[3] - 2
            xp = F.pad(x, (2, 2, 2, 2))
            z = conv.bias.view(1, -1, 1, 1).expand(x.shape[0], -1, h, w)
            for i in range(7):
                for j in range(7):
                    z = torch.addcmul(z, conv.weight[:, 0, i, j].view(
                        1, -1, 1, 1), xp[:, :, i:i + h, j:j + w])
            return F.max_pool2d(F.relu(bn(z)), 3, 2, 1)

    return TapwiseStem


def step_agreement(torch, cfg, trainer, batch) -> dict:
    """One train step through the kernels (fused stems, TPAVI kernel)
    against the same step through the plain versions (``iekd_stem`` on
    cuDNN, the naive attention chain): same weights, batch, dropout seed and
    generator state, SGD at lr 0 so the weights stay and the gradients are
    compared. Both TPAVI W_z BNs get a nonzero scale first (at their zero
    init no gradient reaches θ, φ, g).

    Tolerances: the losses within 1e-4 (relative). Gradients: float32 with
    TF32 off, but every path sums in its own order. A rounding-level
    difference decides a near-tied pool window or a ReLU gate at zero
    otherwise (measured: one such window in 1.3 M moves the stem's dx by
    8e-4 in relative norm), and train-mode BNs amplify it where a gradient
    is a small difference of large sums. The yardstick is the same step
    through a second plain path, equal in real arithmetic: the
    reassociated attention order and the stem's conv summed tap by tap.
    Each tensor's relative norm error against the plain path must stay
    within 10× that path's own + 1e-3. Conv biases followed by a train-mode
    BN (the stem conv, TPAVI's W_z conv), whose gradients cancel to noise,
    are measured against their weight gradient's norm."""
    from glfusion_tpu_torch.models import GlobalAndLocal
    from glfusion_tpu_torch.train.step import make_train_step

    TapwiseStem = _tapwise_stem_class(torch)
    model_k = trainer.model
    with torch.no_grad():
        for attn in (model_k.global_attn, model_k.local_attn):
            attn.W_z[1].weight.uniform_(0.5, 1.0)
    model_p = GlobalAndLocal(cfg.model).cuda()
    model_p.load_state_dict(model_k.state_dict())
    model_r = GlobalAndLocal(cfg.model).cuda()
    model_r.load_state_dict(model_k.state_dict())
    for v, stem in list(model_r.init_block.items()):
        tapwise = TapwiseStem(stem[0].out_channels).cuda()
        tapwise.load_state_dict(stem.state_dict())
        model_r.init_block[v] = tapwise
    gen_state = trainer.generator.get_state()
    results = []
    for model, impl in ((model_k, "pallas"), (model_p, "naive"),
                        (model_r, "reassoc")):
        for attn in (model.global_attn, model.local_attn):
            attn.attn_impl = impl
        step = make_train_step(cfg, model,
                               torch.optim.SGD(model.parameters(), lr=0.0))
        torch.manual_seed(7)
        trainer.generator.set_state(gen_state)
        metrics = step(batch, trainer.generator)
        torch.cuda.synchronize()
        results.append(({k: float(v.sum()) for k, v in metrics.items()},
                        _grads(model)))
    (m_k, g_k), (m_p, g_p), (_, g_r) = results
    loss_err = {k: abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                for k in ("loss", "seg_loss", "cyc_loss")}
    for k, e in loss_err.items():
        check(e <= STEP_TOL["loss"], f"step {k}: kernels vs plain {e}")
    check(set(g_k) == set(g_p) == set(g_r), "gradient sets differ")

    def err(g, name):
        if name.endswith(".0.bias") and (name.startswith("init_block.")
                                         or ".W_z." in name):
            wname = name[:-len("bias")] + "weight"
            return ((g[name] - g_p[name]).norm() / g_p[wname].norm()).item()
        return rel_norm(g[name], g_p[name])

    grad_err = {n: err(g_k, n) for n in g_p}
    noise = {n: err(g_r, n) for n in g_p}
    bad = [(n, grad_err[n], noise[n]) for n in g_p
           if not (math.isfinite(grad_err[n])
                   and grad_err[n] <= 10 * noise[n] + STEP_TOL["grad"])]
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    check(not bad, f"step gradients: kernels vs plain beyond the plain "
          f"paths' own noise: {bad[:5]}")
    for attn in ("global_attn", "local_attn"):
        check(g_p[f"{attn}.theta.weight"].norm().item() > 0,
              f"{attn}: no gradient reached the attention")
    del model_p, model_r
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "tensors": len(grad_err),
            "grad_rel_err_max": worst[0][1],
            "grad_rel_err_worst": [(n, e, noise[n]) for n, e in worst],
            "plain_noise_max": max(noise.values()),
            "tol": "loss 1e-4; grad 10 x second plain path + 1e-3"}


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

    def timed_step(batch, gen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    trainer.train_step = timed_step

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
                                          "stem_bwd2")) == 0,
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
    batch = trainer.train_batch(host, trainer._cycle_clips(1))
    prof = profile_phase(torch, lambda: inner(batch, trainer.generator),
                         "train_profile")
    agreement = step_agreement(torch, cfg, trainer, batch)
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
    return {"train": train_counts, "validation": val_counts, "steps": steps}


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

    from glfusion_tpu_torch.ops import _build

    sources = ("tpavi_fused", "stem_fused")
    t0 = time.perf_counter()
    todo = [n for n in sources if not _build.library_path(n).exists()]
    with ThreadPoolExecutor(len(sources)) as ex:  # one nvcc per source
        list(ex.map(_build.build, todo))
    for name in sources:
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in sources}
    emit("build", seconds=time.perf_counter() - t0, compiled=todo,
         ptxas=ptxas)

    records = kernel_phase(torch)
    kernel_backward_phase(torch)
    stem_records = stem_phase(torch)
    serve_launches = serve_phase(torch)
    train = train_phase(torch)

    main_rec = records[(SERVE_SHAPE, "float32")]
    k1_launches = (serve_launches + train["train"]["fused_dot_nonlocal"]
                   + train["validation"]["fused_dot_nonlocal"])
    kernels = [{
        "name": "tpavi_fused_dot_nonlocal",
        "route": "cuda",
        "source": "glfusion_tpu_torch/csrc/tpavi_fused.cu",
        "replaces": "glfusion_tpu/ops/tpavi_pallas.py:50",
        "launches": k1_launches,
        "shape": main_rec["shape"],
        "dtype": main_rec["dtype"],
        "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["kernel_ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
    }]
    stem = stem_records[(STEM_BATCHES[-1], "float32")]
    replaces = {
        "stem_stats": "experiments/stem_pallas.py:289 (and "
                      "experiments/stem_banded.py:172)",
        "stem_norm_pool": "experiments/stem_pallas.py:310 (and "
                          "experiments/stem_banded.py:192)",
        "stem_bwd1": "experiments/stem_pallas.py:325",
        "stem_bwd2": "experiments/stem_pallas.py:356",
    }
    abs_err = {"stem_stats": stem["err"]["max_abs_stats"],
               "stem_norm_pool": stem["err"]["max_abs_out"],
               "stem_bwd1": max(stem["err"]["max_abs_dgamma"],
                                stem["err"]["max_abs_dbeta"]),
               "stem_bwd2": max(stem["err"]["max_abs_dx"],
                                stem["err"]["max_abs_dweight"])}
    for name, where in replaces.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "glfusion_tpu_torch/csrc/stem_fused.cu",
            "replaces": where,
            "launches": train["train"][name] + train["validation"][name],
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
    main()
