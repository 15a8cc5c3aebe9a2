#!/usr/bin/env python3
"""Smoke check of the PyTorch port (``glfusion_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises and the exit code is
nonzero:

  env     torch and CUDA versions, the card's name and power limit; TF32 is
          switched off for matmuls and cuDNN, for every comparison below.
  build   nvcc builds the port's CUDA kernel from the checkout's sources.
  kernel  the TPAVI kernel against its plain PyTorch version at small,
          ragged and serving shapes, float32 and bfloat16, on contiguous and
          on strided (split-projection) operands, with its time, the plain
          version's, a cuBLAS yardstick's and the card's bound.
  serve   the full-width flagship (``Config().model`` with
          ``use_pallas_fusion=True``, random weights from seed 0) serves four
          NIfTI clips through ``ClipPipeline``; the masks and the kernel's
          launch count are checked, and a 112² and the 160² clip are held
          against the plain-torch naive and reassociated attention orders.
  profile where one serving forward's device time goes (torch.profiler);
          printed before the serve line.

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
    profile_phase(torch, model, x)
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
    if any(s in low for s in ("conv", "fprop", "implicit", "winograd",
                              "cudnn")):
        return "convolution"
    if "gemm" in low or "cutlass" in low:
        return "matmul"
    return "other"


def profile_phase(torch, model, x) -> None:
    """Where one serving forward's device time goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat: dict = {}
    for e in kernels:
        cat = _category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + e.self_device_time_total / 1e3
    device_ms = sum(by_cat.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", wall_ms=wall_ms, device_ms=device_ms,
         idle_share=max(0.0, 1 - device_ms / wall_ms),
         device_ms_by_category=by_cat,
         top_kernels=[{"name": e.key[:100], "ms": e.self_device_time_total
                       / 1e3, "calls": e.count} for e in top])


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

    from glfusion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = not _build.library_path("tpavi_fused").exists()
    _build.load("tpavi_fused")
    ptxas = [ln.strip() for ln in _build.build_log("tpavi_fused").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, compiled=built,
         ptxas=ptxas)

    records = kernel_phase(torch)
    launches = serve_phase(torch)

    main_rec = records[(SERVE_SHAPE, "float32")]
    print(json.dumps({"kernels": [{
        "name": "tpavi_fused_dot_nonlocal",
        "route": "cuda",
        "source": "glfusion_tpu_torch/csrc/tpavi_fused.cu",
        "replaces": "glfusion_tpu/ops/tpavi_pallas.py:50",
        "launches": launches,
        "shape": main_rec["shape"],
        "dtype": main_rec["dtype"],
        "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["kernel_ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
