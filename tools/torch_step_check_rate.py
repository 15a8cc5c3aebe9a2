"""How often ``chip_smoke.py``'s float32 step check fails, and what moves it.

Runs ``chip_smoke.py``'s train phase from the checkout at ``--root`` (default:
this one) on the card, with its step check (``step_agreement``: one train step
through the kernels against the plain path, each gradient within 10× a second
plain path's own difference + 1e-3) repeated ``--repeats`` times on the
phase's one sample. Every repeat starts from the same weights and random
state, so the repeats differ only where the card's arithmetic is not
deterministic. A failed repeat is recorded, not raised.

Per repeat, besides the check's worst ratio (the check fails above 1) and its
worst tensors: for every BatchNorm of the heads (``classifier.*``,
``centerness.*``; each is followed by a ReLU) the number of its outputs whose
sign differs from the plain path's, in the kernel path and in the second plain
path. A changed sign is a ReLU gate that flipped; one flipped gate moves its
branch's weight gradient by about 1/sqrt(positions × channels) of its norm.

With ``--samples``, repeat i runs the check on another sample instead: the
host batch of epoch 1 + i and, on a tree whose steps draw from
``Trainer.step_randomness``, the draws of (epoch 1, step i) (else the
trainer's one generator seeded 1000 + i). A chip_smoke run's sample is one
such draw: the epoch that trains before it is not deterministic on the card,
so each run checks other weights.

    python3 tools/torch_step_check_rate.py [--root DIR] [--repeats N] \
        [--samples] [--out FILE]

One JSON line per repeat goes to ``--out`` (appended); a summary line per
repeat to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HEADS = ("classifier.", "centerness.")


class GateRecorder:
    """Sign masks of the heads' BatchNorm outputs, one list per train step
    while armed (a global forward hook; the mask is taken before the
    in-place ReLU that follows)."""

    def __init__(self, torch):
        self.torch = torch
        self.armed = False
        self.names = {}
        self.steps = []
        torch.nn.modules.module.register_module_forward_hook(self._hook)

    def _hook(self, module, inputs, output):
        name = self.names.get(module)
        if self.armed and name is not None:
            self.steps[-1].append((name, output.detach() > 0))

    def start(self, model):
        self.names = {m: n for n, m in model.named_modules()
                      if n.startswith(HEADS)
                      and isinstance(m, self.torch.nn.BatchNorm2d)}
        self.steps.append([])

    def flips(self, step: int) -> dict:
        """Per module, the signs of ``step`` that differ from step 1's (the
        plain path)."""
        out = Counter()
        ref = self.steps[1]
        if len(self.steps[step]) != len(ref):
            raise RuntimeError("the paths called the heads' BNs differently")
        for (name, a), (name_r, b) in zip(self.steps[step], ref):
            if name != name_r or a.shape != b.shape:
                raise RuntimeError(f"call order differs: {name} {name_r}")
            out[name] += int((a != b).sum())
        return {k: v for k, v in sorted(out.items(), key=lambda kv: -kv[1])
                if v}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--samples", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_step_check_rate: CUDA is not available")
    import chip_smoke as cs
    import glfusion_tpu_torch.train.step as step_mod
    from glfusion_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = ("tpavi_fused", "stem_fused")
    todo = [n for n in sources if not _build.library_path(n).exists()]
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(_build.build, todo))
    for name in sources:
        _build.load(name)

    rec = GateRecorder(torch)
    make = step_mod.make_train_step

    def recorded_make(cfg, model, opt, *a, **kw):
        step = make(cfg, model, opt, *a, **kw)

        def run(batch, gen):
            if rec.armed:
                rec.start(model)
            return step(batch, gen)
        return run

    step_mod.make_train_step = recorded_make
    smi = cs.nvidia_smi_line()
    agreement = cs.step_agreement
    lines = []

    def repeated(torch_, cfg, trainer, batch, tol=cs.STEP_TOL):
        model = trainer.model
        state = {k: v.clone() for k, v in model.state_dict().items()}
        rng = torch.get_rng_state(), torch.cuda.get_rng_state()
        gen = getattr(trainer, "generator", None)  # the carried one, if any
        gen_state = None if gen is None else gen.get_state()
        raise_check = cs.check
        first = None
        step_randomness = getattr(trainer, "step_randomness", None)
        for i in range(args.repeats):
            model.load_state_dict(state)
            torch.set_rng_state(rng[0])
            torch.cuda.set_rng_state(rng[1])
            if gen is not None:
                gen.set_state(gen_state)
            if args.samples:
                host = next(trainer.train_loader.batches(
                    cfg.train.batch_size, 1 + i))
                if gen is None:
                    trainer.step_randomness = (
                        lambda e, s, i=i: step_randomness(e, s + i))
                    with trainer.step_randomness(1, 0) as g:
                        batch = trainer.train_batch(
                            host, trainer._cycle_clips(1), g)
                else:
                    gen.manual_seed(1000 + i)
                    batch = trainer.train_batch(host,
                                                trainer._cycle_clips(1))
            failed = []
            cs.check = lambda ok, msg: failed.append(msg) if not ok else None
            rec.steps, rec.armed = [], True
            t0 = time.perf_counter()
            try:
                res = agreement(torch_, cfg, trainer, batch, tol)
            finally:
                rec.armed = False
                cs.check = raise_check
            line = {"root": str(root), "repeat": i, "nvidia_smi": smi,
                    "samples": args.samples,
                    "seconds": time.perf_counter() - t0,
                    "failed": bool(failed), "worst_ratio": res["worst_ratio"],
                    "worst_ratio_tensor": res["worst_ratio_tensor"],
                    "grad_rel_err_worst": res["grad_rel_err_worst"],
                    "plain_noise_max": res["plain_noise_max"],
                    "flips_kernel": rec.flips(0),
                    "flips_second": rec.flips(2),
                    "messages": [m[:400] for m in failed]}
            lines.append(line)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            print(json.dumps({k: line[k] for k in (
                "repeat", "failed", "worst_ratio", "worst_ratio_tensor")}
                | {"flips_kernel": sum(line["flips_kernel"].values()),
                   "flips_second": sum(line["flips_second"].values())}),
                flush=True)
            first = first or res
            rec.steps = []
            torch.cuda.empty_cache()
        if gen is None:
            trainer.step_randomness = step_randomness
        return first

    cs.step_agreement = repeated
    cs.train_phase(torch)
    print(json.dumps({"root": str(root), "repeats": len(lines),
                      "failed": sum(x["failed"] for x in lines),
                      "worst_ratios": [x["worst_ratio"] for x in lines],
                      "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
