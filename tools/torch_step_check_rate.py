"""How often ``chip_smoke.py``'s step check fails, and whether it still
fails a broken kernel: the float32 check, or with ``--bf16`` the
``train_bf16`` phase's.

Runs the step check of the checkout at ``--root`` (default: this one) on
the card, on ``--samples`` samples, recording each verdict instead of
raising. Two forms, told apart by the checkout's ``chip_smoke.py``:

* a checkout with ``step_paths`` (the check that measures a fixed state):
  sample i is the model's initial weights with the host batch of epoch
  1 + i under the draws of (epoch 1, step i) (``fixed_check_sample``),
  made before any training, so a sample's verdict does not depend on an
  epoch trained on the card. The plain paths run once a sample; the
  kernels' step is held against them as it is and under each negative
  control (``--controls``), which must fail every sample (the check: the
  whole step's gradients, ``step_verdict``, and each kernel call of the
  step against its plain version on the step's tensors,
  ``in_situ_verdict``):
    - ``k1_scale``: K1's 1/N computed for N + 1 tokens;
    - ``bwd2_tap``: ``stem_bwd2``'s dW partials of one tap (the centre of
      the 7×7) scaled by 1 + 1e-3.
  The whole step's part is also given at each of ``FLOORS`` in place of
  ``STEP_TOL["grad"]``, so that one run shows what each floor passes and
  what it catches.
* an older checkout (``step_agreement`` alone): its train phase runs one
  epoch, then its check runs on sample i: those weights, the host batch
  of epoch 1 + i under the draws of (epoch 1, step i).

    python3 tools/torch_step_check_rate.py [--root DIR] [--samples N] \\
        [--controls] [--bf16] [--out FILE]

``--bf16``: the checkout's ``train_bf16`` phase alone (its plain step's
epoch, then its step check, bfloat16 with remat, ``STEP_TOL_BF16``),
``--samples`` times on the train phase's synthetic corpus, each verdict
recorded instead of raised. Where the checkout reads the heads' last
conv biases before their rounding (``exact_bias_sums``), each line also
gives the verdict of the same runs on the rounded gradients, under the
earlier rule (two second paths: ``parent_rule``) and with three
(``three_paths_rounded``); for every one-element gradient (the
centerness heads' biases) and the worst tensor, the kernels' relative
error and each second path's (``paths``; rounded: ``paths_rounded``);
and the one-element gradients where the kernels differ from the plain
path and every second path reads 0 (``zero_noise``).

One JSON line per sample goes to ``--out`` (appended) and a short one to
standard output; the last line is the summary.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# floors of the per-tensor allowance (noise × 10 + floor) to report
FLOORS = (1e-3, 3e-4, 1e-4, 3e-5, 1e-5)
BWD2_TAP, BWD2_SCALE = 24, 1 + 1e-3


def verdicts(res, tol) -> dict:
    """The check's verdict at its floor and at each of ``FLOORS``, from one
    ``step_verdict`` result: {floor: (ok, worst ratio, worst tensor)}."""
    loss_ok = not any(b[0] in ("loss", "seg_loss", "cyc_loss")
                      for b in res["bad"])
    out = {}
    for floor in sorted({tol["grad"], *FLOORS}):
        ratio = {n: e / (tol["noise"] * res["noise"][n] + floor)
                 for n, e in res["grad_err"].items()}
        worst = max(ratio, key=ratio.get)
        out[floor] = (loss_ok and all(math.isfinite(r) and r <= 1
                                      for r in ratio.values()),
                      ratio[worst], worst)
    return out


class Controls:
    """The negative controls: each method breaks one kernel by patching
    its wrapper; ``restore`` puts both back."""

    def __init__(self):
        from glfusion_tpu_torch.experiments import stem_fused
        from glfusion_tpu_torch.ops import tpavi_fused

        self.stem_fused, self.tpavi_fused = stem_fused, tpavi_fused
        self.gemm, self.bwd2 = tpavi_fused._gemm, stem_fused.stem_bwd2

    def k1_scale(self):
        gemm = self.gemm

        def wrong(a, a_mn, b, b_mn, c, m, n, k, div, **kw):
            # stage 2 divides by N; stage 1 by 1
            return gemm(a, a_mn, b, b_mn, c, m, n, k,
                        div + 1 if div != 1.0 else div, **kw)
        self.tpavi_fused._gemm = wrong

    def bwd2_tap(self):
        bwd2 = self.bwd2

        def wrong(x, w49, chan, dy):
            dwp, dbp, dxp = bwd2(x, w49, chan, dy)
            dwp[..., BWD2_TAP] *= BWD2_SCALE
            return dwp, dbp, dxp
        wrong.launches = 0  # the kernel's wrapper counts under its name
        self.stem_fused.stem_bwd2 = wrong

    def restore(self):
        self.tpavi_fused._gemm = self.gemm
        self.stem_fused.stem_bwd2 = self.bwd2


def rounded(run) -> tuple:
    """(metrics, gradients) of a run with the heads' rounded bias
    gradients in place of their exact sums."""
    return run[0], {**run[1], **run[0].get("rounded_grads", {})}


def zero_noise(errors) -> list:
    """The tensors of ``path_errors`` where the kernels differ from the
    plain path and every second path reads 0."""
    return [n for n, e in errors.items() if e[0] > 0 and max(e[1:]) == 0]


def path_errors(runs, g_k, res) -> dict:
    """Tensor → [the kernels' relative error, then each second path's],
    against the plain path, for the worst tensor and every one-element
    gradient."""
    g_p = runs[0][1]
    names = {res["worst_ratio_tensor"]} | {n for n, g in g_p.items()
                                           if g.numel() == 1}

    def err(g, n):
        den = g_p[n].norm().item()
        return (g[n] - g_p[n]).norm().item() / den if den else math.inf

    return {n: [err(g_k, n)] + [err(g, n) for _, g in runs[1:]]
            for n in sorted(names)}


def fixed_state(torch, cs, args, smi, log):
    """This checkout's check on fixed samples, with the controls."""
    from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
    from glfusion_tpu_torch.models import GlobalAndLocal

    cfg = cs._flagship_config()
    torch.manual_seed(0)
    model = GlobalAndLocal(cfg.model)
    swap_in_fused_stems(model)
    trainer, _ = cs._timed_trainer(torch, cfg, None, model)
    tol = cs.STEP_TOL
    controls = Controls()
    for i in range(args.samples):
        t0 = time.perf_counter()
        batch, state = cs.fixed_check_sample(torch, trainer, i)
        runs = cs.step_paths(torch, cfg, trainer, batch, state, tol, i)
        line = {"sample": i, "form": "fixed_state", "tol": tol}
        for name in ("none",) + (("k1_scale", "bwd2_tap") if args.controls
                                 else ()):
            if name != "none":
                getattr(controls, name)()
            try:
                m_k, g_k, in_situ = cs.kernel_step(torch, cfg, trainer, batch,
                                                   state, i)
            finally:
                controls.restore()
            res = cs.step_verdict(m_k, g_k, runs, tol)
            situ = cs.in_situ_verdict(in_situ, tol)
            line[name] = {
                "ok": res["ok"] and situ["ok"],
                "worst_ratio": max(res["worst_ratio"], situ["worst_ratio"]),
                "worst_ratio_tensor": res["worst_ratio_tensor"],
                "bad": res["bad"], "loss_rel_err": res["loss_rel_err"],
                "loss_plain_noise": res["loss_plain_noise"],
                "in_situ": situ, "in_situ_detail": in_situ,
                # the whole step's gradients alone, at each floor
                "floors": {str(f): v for f, v in verdicts(res, tol).items()}}
        line["seconds"] = time.perf_counter() - t0
        log(line)
        del runs, batch, state
        torch.cuda.empty_cache()


def bf16_phase(torch, cs, args, smi, log):
    """The checkout's ``train_bf16`` phase alone, its plain step only (the
    one with the check), ``args.samples`` times."""
    import tempfile

    from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset

    cfg = cs._flagship_config()
    paths = generate_synthetic_dataset(tempfile.mkdtemp(), cfg.data,
                                       views=cfg.model.views,
                                       seed=cfg.train.seed)
    cs.BF16_VARIANTS = (("plain", {}),)
    verdict, raise_check = cs.step_verdict, cs.check
    for i in range(args.samples):
        seen, failed = [], []

        def recorded(m_k, g_k, runs, tol):
            res = verdict(m_k, g_k, runs, tol)
            # the same runs on the rounded gradients: the earlier rule
            # (two second paths, the first two here), and three
            r_k, r_runs = rounded((m_k, g_k)), [rounded(r) for r in runs]
            parent = verdict(*r_k, r_runs[:3], {**tol, "noise_paths": 2})
            three = verdict(*r_k, r_runs, tol)
            seen.append((res, parent, three, path_errors(runs, g_k, res),
                         path_errors(r_runs, r_k[1], res)))
            return res

        cs.step_verdict = recorded
        cs.check = lambda ok, msg: failed.append(msg) if not ok else None
        t0 = time.perf_counter()
        try:
            cs.train_bf16_phase(torch, paths)
        finally:
            cs.step_verdict, cs.check = verdict, raise_check
        res, parent, three, paths_err, paths_rounded = seen[-1]

        def brief(r):
            return {"ok": r["ok"], "worst_ratio": r["worst_ratio"],
                    "worst_ratio_tensor": r["worst_ratio_tensor"],
                    "bad": r["bad"]}
        log({"sample": i, "form": "bf16_phase", "tol": res["tol"],
             "none": {"ok": not failed, "worst_ratio": res["worst_ratio"],
                      "worst_ratio_tensor": res["worst_ratio_tensor"],
                      "bad": [m[:400] for m in failed],
                      "loss_rel_err": res["loss_rel_err"],
                      "loss_plain_noise": res["loss_plain_noise"]},
             "parent_rule": brief(parent),
             "three_paths_rounded": brief(three),
             "paths": paths_err, "paths_rounded": paths_rounded,
             "zero_noise": {"exact": zero_noise(paths_err),
                            "rounded": zero_noise(paths_rounded)},
             "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()


def trained_state(torch, cs, args, smi, log):
    """An older checkout's check: its train phase, then its check on N
    samples of the trained weights."""
    agreement = cs.step_agreement

    def sampled(torch_, cfg, trainer, batch, tol=cs.STEP_TOL):
        model = trainer.model
        state = {k: v.clone() for k, v in model.state_dict().items()}
        rng = torch.get_rng_state(), torch.cuda.get_rng_state()
        step_randomness = trainer.step_randomness
        raise_check, first = cs.check, None
        for i in range(args.samples):
            model.load_state_dict(state)
            torch.set_rng_state(rng[0])
            torch.cuda.set_rng_state(rng[1])
            host = next(trainer.train_loader.batches(cfg.train.batch_size,
                                                     1 + i))
            trainer.step_randomness = (
                lambda e, s, i=i: step_randomness(e, s + i))
            with trainer.step_randomness(1, 0) as g:
                batch = trainer.train_batch(host, trainer._cycle_clips(1), g)
            failed = []
            cs.check = lambda ok, msg: failed.append(msg) if not ok else None
            t0 = time.perf_counter()
            try:
                res = agreement(torch_, cfg, trainer, batch, tol)
            finally:
                cs.check = raise_check
                trainer.step_randomness = step_randomness
            log({"sample": i, "form": "trained_state",
                 "none": {"ok": not failed, "worst_ratio": res["worst_ratio"],
                          "worst_ratio_tensor": res["worst_ratio_tensor"],
                          "bad": [m[:400] for m in failed]},
                 "seconds": time.perf_counter() - t0})
            first = first or res
            torch.cuda.empty_cache()
        return first

    cs.step_agreement = sampled
    cs.train_phase(torch)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--samples", type=int, default=24)
    ap.add_argument("--controls", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="the train_bf16 phase alone, its step check")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_step_check_rate: CUDA is not available")
    import chip_smoke as cs
    from glfusion_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = ("tpavi_fused", "stem_fused")
    todo = [n for n in sources if not _build.library_path(n).exists()]
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(_build.build, todo))
    smi = cs.nvidia_smi_line()
    lines = []

    def log(line):
        line = {"root": str(root), "nvidia_smi": smi, **line}
        lines.append(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        print(json.dumps({k: line[k] for k in ("sample", "form")} | {
            k: (line[k]["ok"], round(line[k]["worst_ratio"], 4))
            for k in ("none", "parent_rule", "three_paths_rounded",
                      "k1_scale", "bwd2_tap")
            if k in line}),
            flush=True)

    form = fixed_state if hasattr(cs, "step_paths") else trained_state
    if args.bf16:
        form = bf16_phase
    form(torch, cs, args, smi, log)
    summary = {"root": str(root), "form": form.__name__,
               "dtype": "bfloat16" if args.bf16 else "float32",
               "samples": len(lines), "nvidia_smi": smi}
    if args.bf16:
        summary["zero_noise"] = {
            k: sum(len(x["zero_noise"][k]) for x in lines)
            for k in ("exact", "rounded")}
        summary["one_element_readings"] = sum(
            len([n for n in x["paths"] if n.startswith("centerness")])
            for x in lines)
    for name in ("none", "parent_rule", "three_paths_rounded", "k1_scale",
                 "bwd2_tap"):
        got = [x[name] for x in lines if name in x]
        if not got:
            continue
        summary[name] = {"failed": sum(not g["ok"] for g in got),
                         "worst_ratio_max": max(g["worst_ratio"] for g in got),
                         "worst_ratio_min": min(g["worst_ratio"] for g in got)}
        if "floors" in got[0]:
            summary[name]["floors"] = {
                f: {"failed": sum(not g["floors"][f][0] for g in got),
                    "worst_ratio_max": max(g["floors"][f][1] for g in got),
                    "worst_ratio_min": min(g["floors"][f][1] for g in got)}
                for f in got[0]["floors"]}
    print(json.dumps(summary), flush=True)
    if not all(math.isfinite(x["none"]["worst_ratio"]) for x in lines):
        raise SystemExit("a check gave a non-finite ratio")


if __name__ == "__main__":
    main()
