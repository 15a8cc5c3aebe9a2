"""Command-line entry point of the port: ``python -m glfusion_tpu_torch``.

The port of ``glfusion_tpu/cli.py`` for ``--mode train|val|visual|infer|
serve|export`` (reference ``main.py --mode``), with the JAX CLI's flag
names and guards: ``--model`` (JAX's ``SEG_ARCHS``: the flagship and the
whole zoo of ``models/registry.py``, the AVS family and the legacy kinds
included), ``--variant`` (all eleven of JAX's values: the
flagship, its eight ablations, ``cps`` and ``temporal``),
``--checkify``, ``--debug-nans``, ``--http-port`` (an HTTP endpoint,
``http_serve.py``) and ``--from-export`` (serving a ``--mode export``
artifact). Without ``--data-root`` a synthetic corpus exercises the full
pipeline. It runs on the card; ``--platform cpu`` runs on the CPU, and
without it a machine with no CUDA raises. SIGTERM stops a training run at
the next epoch boundary with that epoch checkpointed; ``--resume``
continues it.

Multi-process runs: under an MPI-style launcher (``PMI_SIZE``/``PMI_RANK``
or ``OMPI_COMM_WORLD_SIZE``/``OMPI_COMM_WORLD_RANK``; ``MASTER_ADDR`` on
more than one node) every process joins one ``torch.distributed`` group
before anything touches the card (``utils/cluster.py``), one card a
process, and the trainers run on a (data, model) mesh over the processes
(``--mesh-model`` sets the model axis, data takes the rest; ``parallel/``).
Only rank 0 prints, logs and writes. ``--mode serve`` and the HTTP
endpoint refuse a multi-process run, as JAX's do; ``--mode export``, which
traces one process's forward, does too.

TF32 policy: in float32 the CLI turns TF32 off for cuBLAS and cuDNN, so
"float32" is IEEE float32, as in the JAX package's tests, on the CPU and in
every figure measured on the card; bfloat16 leaves PyTorch's settings as
they are.

``--mode reg-train|reg-val`` drive the mPAP video-regression path (the
reference's ``PAHDataset``, which its entry point never wires):
``--reg-model`` picks one of the four regressors of
``models/registry.build_reg_model`` and ``--label-type`` the target;
``train/regression.RegressionTrainer`` trains or scores it, and the last
line is strict JSON (``label``, ``mse``, ``mae``, ``rmse``, ``r2``; a
non-finite score is ``null``). reg-val scores the newest checkpoint, or
says there is none and scores fresh weights, as JAX's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

from glfusion_tpu_torch.arch_names import REG_ARCHS, SEG_ARCHS
from glfusion_tpu_torch.config import ALL_VIEWS, Config, tiny_config

# JAX's --variant choices; 'temporal' is a train switch on the plain model
VARIANTS = ("global_and_local", "global_only", "local_only", "cyc_nofusion",
            "global_only_cyc_nofusion", "conv_merge", "fg_bg",
            "early_fusion", "late_fusion", "cps", "temporal")
# --tiny's regressors (JAX cli.py:262-269)
TINY_REG = {
    "resnet50pah": dict(depth=10),
    "r2plus1d": dict(layers=(1, 1, 1, 1), widths=(8, 16, 32, 64)),
    "timesformer": dict(dim=32, depth=1, heads=2, dim_head=16, patch_size=8),
    "resnet50pfs": dict(main_depth=10, proj_depth=10,
                        widths=(8, 16, 32, 64)),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="glfusion_tpu_torch",
        description="GL-Fusion multi-view echocardiogram segmentation "
                    "(PyTorch, one NVIDIA H100)")
    p.add_argument("--mode", choices=["train", "val", "visual", "infer",
                                      "serve", "export", "reg-train",
                                      "reg-val"], default="train",
                   help="train (then validate each epoch); val, visual, "
                        "infer, serve and export use the newest checkpoint "
                        "under --save-dir (or --torch-ckpt): val evaluates, "
                        "visual writes PNGs, infer writes NIfTI masks, "
                        "serve writes them through the pipelined "
                        "ClipPipeline (or, with --http-port, answers "
                        "requests), export writes a torch.export program "
                        "of the serving forward; reg-train and reg-val "
                        "train and score the mPAP video regressor "
                        "(--reg-model, --label-type)")
    p.add_argument("--model", default="glfusion", choices=list(SEG_ARCHS),
                   help="trainable architecture (models/registry.py): the "
                        "flagship and the zoo (unet, multiview_unet, "
                        "unet:<kind>, utnet, cen, res3dunet, avs_<flavor>, "
                        "legacy:<kind>)")
    p.add_argument("--reg-model", default="resnet50pah",
                   choices=list(REG_ARCHS),
                   help="regression architecture for --mode reg-*")
    p.add_argument("--label-type", default="mPAP", choices=["mPAP", "Vmax"],
                   help="regression target column (reference loader.py:140)")
    p.add_argument("--variant", default="global_and_local", choices=VARIANTS,
                   help="'cps' = the cross-pseudo-supervision twin; "
                        "'temporal' = cycle clips run video attention over "
                        "T·V·h·w tokens (a train switch on the flagship)")
    p.add_argument("--data-root", default=None,
                   help="dataset root containing infos/, data_list/, .nii.gz;"
                        " omit to run on synthetic data")
    # None: keep the configuration's default (--tiny has its own)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=1e-5)
    p.add_argument("--views", default="1,3,4",
                   help="comma-separated view ids")
    p.add_argument("--clip-length", type=int, default=None)
    p.add_argument("--no-cycle", action="store_true",
                   help="disable the temporal cycle-consistency loss")
    p.add_argument("--dense-cyc", action="store_true",
                   help="use the all-starts cycle loss (dense_seg_cycle)")
    p.add_argument("--cycle-light", action="store_true",
                   help="cycle forward computes only the cycle-loss "
                        "features (identical loss; skipped heads' BN stats "
                        "stop updating on cycle frames)")
    p.add_argument("--fuse-passes", action="store_true",
                   help="run the supervised batch and cycle clip through "
                        "ONE merged backbone pass per step (cycle-light "
                        "head semantics; merged-batch BN moments — see "
                        "TrainConfig.fuse_passes)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient accumulation: one Adam update per this "
                        "many supervised microbatches of --batch-size "
                        "(exact big-batch gradient under the sum-reduction "
                        "loss; cycle clip once per update — see "
                        "TrainConfig.grad_accum)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="model-parallel mesh axis size")
    p.add_argument("--save-dir", default="./result/ckpt")
    p.add_argument("--log-dir", default="./result/log_info/log_01")
    p.add_argument("--resume", action="store_true",
                   help="restore the newest checkpoint (weights, Adam state, "
                        "schedule) before training")
    p.add_argument("--torch-ckpt", default=None,
                   help="load a reference net_XXXXX.pth "
                        "({'network': state_dict}) instead of a checkpoint "
                        "under --save-dir")
    p.add_argument("--imagenet-backbone", default=None,
                   help="initialize every view's backbone from a LOCAL "
                        "torchvision resnet50 ImageNet .pth (the reference "
                        "recipe; the 1-channel stem conv stays random)")
    p.add_argument("--out-dir", default="./predictions",
                   help="infer and serve: output directory of the masks")
    p.add_argument("--method-name", default="glfusion_tpu_torch",
                   help="visual: output subdirectory (main.py:546)")
    p.add_argument("--sweep", action="store_true",
                   help="val: evaluate every saved checkpoint and report "
                        "the best Inner-val epoch >= 50 (all epochs when "
                        "none reaches 50)")
    p.add_argument("--ckpt-keep", type=int, default=None,
                   help="checkpoints kept on disk (default: all, which the "
                        "sweep needs)")
    p.add_argument("--log-histograms", action="store_true",
                   help="per-parameter TensorBoard histograms each epoch "
                        "(one copy of every parameter to the host)")
    p.add_argument("--serve-depth", type=int, default=2,
                   help="serve: clips in flight on the card")
    p.add_argument("--serve-threads", type=int, default=None,
                   help="serve: host NIfTI decode workers (default "
                        "min(4, cpu_count))")
    p.add_argument("--tiny", action="store_true",
                   help="miniature topology and corpus for smoke runs")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (params stay f32). The reference is "
                        "f32; bfloat16 halves activation memory. float32 "
                        "runs with TF32 off for matmuls and convolutions")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize backbone blocks (saves activation "
                        "memory at ~30%% extra FLOPs)")
    p.add_argument("--eval-every", type=int, default=1,
                   help="epochs between in-training validations")
    p.add_argument("--save-every", type=int, default=1,
                   help="epochs between checkpoints")
    p.add_argument("--checkify", action="store_true",
                   help="finiteness checks on the loss and the gradient "
                        "norm each step, read one step late (no step waits "
                        "for its own); a NaN raises by the epoch's end")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise at the first op whose output holds a NaN "
                        "(forward and backward; slow: one host read an op, "
                        "utils/debug.py)")
    p.add_argument("--http-port", type=int, default=None,
                   help="--mode serve: answer POST /predict and GET /healthz "
                        "on this port (0 picks a free one) instead of "
                        "writing the test clips' masks")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="--http-port bind address (0.0.0.0 to expose)")
    p.add_argument("--export-dir", default="./exported",
                   help="--mode export: output directory of the program "
                        "and its meta.json")
    p.add_argument("--export-hw", type=int, default=None,
                   help="--mode export: pinned spatial size of the program's "
                        "input (default: the crop size)")
    p.add_argument("--from-export", default=None,
                   help="--mode serve: run a saved --mode export program "
                        "instead of a checkpoint's weights")
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="cpu runs on the CPU; default: the CUDA card")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = tiny_config() if args.tiny else Config()
    temporal = args.variant == "temporal"
    variant = "global_and_local" if temporal else args.variant
    views = tuple(args.views.split(","))
    bad = [v for v in views if v not in ALL_VIEWS]
    if bad:
        raise SystemExit(
            f"error: --views contains unknown view id(s) {bad}; "
            f"valid ids are {list(ALL_VIEWS)}")

    def pick(value, default):
        return default if value is None else value

    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model, views=views, variant=variant, arch=args.model,
            dtype=(args.dtype or cfg.model.dtype),
            remat=args.remat or cfg.model.remat),
        data=dataclasses.replace(
            cfg.data, root=args.data_root,
            clip_length=pick(args.clip_length, cfg.data.clip_length)),
        opt=dataclasses.replace(cfg.opt, lr=args.lr,
                                weight_decay=args.weight_decay),
        train=dataclasses.replace(
            cfg.train,
            batch_size=pick(args.batch_size, cfg.train.batch_size),
            num_epochs=pick(args.epochs, cfg.train.num_epochs),
            use_cycle=not args.no_cycle,
            dense_cyc=args.dense_cyc,
            cycle_light=args.cycle_light,
            fuse_passes=args.fuse_passes,
            temporal=temporal,
            grad_accum=args.grad_accum,
            save_dir=args.save_dir,
            log_dir=args.log_dir,
            test_views=views,
            eval_every_epochs=args.eval_every,
            save_every_epochs=args.save_every,
            ckpt_keep=args.ckpt_keep,
            log_histograms=args.log_histograms,
            checkify=args.checkify,
            mesh_model=args.mesh_model,
        ),
    )


def data_paths_from_root(root: str, cfg: Config) -> dict:
    root = Path(root)
    paths = {
        "infos": str(root / cfg.data.infos_path),
        "unlab_infos": str(root / cfg.data.unlab_infos_path),
        "test_infos": str(root / cfg.data.test_infos_path),
        "data_list_dir": str(root / cfg.data.data_list_dir),
    }
    missing = [p for p in paths.values() if not Path(p).exists()]
    if missing:
        raise SystemExit("error: --data-root is missing required entries:\n  "
                         + "\n  ".join(missing))
    return paths


def apply_tf32_policy(cfg: Config) -> None:
    """float32 is IEEE float32: TF32 off for cuBLAS and cuDNN. bfloat16
    leaves PyTorch's settings as they are."""
    if cfg.model.dtype == "float32":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _train(trainer) -> None:
    """Train; on the main thread SIGTERM asks for a stop at the epoch
    boundary (the in-flight epoch is checkpointed, the process exits 0)."""
    import signal
    import threading

    if threading.current_thread() is not threading.main_thread():
        trainer.train()  # signal.signal is main-thread only
        return
    prev = signal.signal(signal.SIGTERM,
                         lambda signum, frame: trainer.request_stop())
    try:
        trainer.train()
    finally:
        signal.signal(signal.SIGTERM, prev)


def _run_regression(args: argparse.Namespace, cfg: Config,
                    data_paths) -> int:
    """--mode reg-train / reg-val: the mPAP video-regression path."""
    import json
    import math

    import torch

    from glfusion_tpu_torch.models.registry import build_reg_model
    from glfusion_tpu_torch.train.regression import RegressionTrainer
    from glfusion_tpu_torch.utils.cluster import barrier

    if args.torch_ckpt is not None or args.imagenet_backbone is not None:
        raise SystemExit("error: --torch-ckpt and --imagenet-backbone load "
                         "the segmentation flagship's weights; the "
                         "regression models have no reference checkpoint")
    if data_paths is None:
        import tempfile

        from glfusion_tpu_torch.data.synthetic import (
            generate_synthetic_dataset)
        tmp = tempfile.mkdtemp(prefix="glfusion_torch_synth_")
        data_paths = generate_synthetic_dataset(
            tmp, cfg.data, views=cfg.model.views, seed=cfg.train.seed)
        say(f"[glfusion_torch] synthetic dataset generated under {tmp}")
    torch.manual_seed(cfg.train.seed)  # the initial weights
    model, adapter = build_reg_model(
        args.reg_model, cfg.model.num_views, dtype=cfg.model.dtype,
        **(TINY_REG[args.reg_model] if args.tiny else {}))
    trainer = RegressionTrainer(cfg, model, data_paths,
                                label_type=args.label_type,
                                input_adapter=adapter, device=args.platform)
    tc = cfg.train
    if args.mode == "reg-train":
        if args.resume and trainer.load_latest():
            say(f"[glfusion_torch] resumed at epoch {trainer.epoch}")
        for epoch in range(trainer.epoch, tc.num_epochs):
            m = trainer.train_epoch(epoch)
            say(f"[glfusion_torch] reg epoch {epoch}: loss="
                f"{m['loss']:.4f} ({m['steps']} steps)")
            if ((tc.save_every_epochs > 0
                 and (epoch + 1) % tc.save_every_epochs == 0)
                    or epoch == tc.num_epochs - 1):
                trainer.save(epoch)
        trainer.ckpt.wait()
        barrier()
    elif trainer.load_latest():  # reg-val scores the newest checkpoint
        say("[glfusion_torch] reg-val: scoring the checkpoint of epoch "
            f"{trainer.epoch - 1}")
    else:
        say("[glfusion_torch] reg-val: no checkpoint found under "
            f"{tc.save_dir}; evaluating fresh init")
    metrics = trainer.evaluate()
    # strict JSON: a NaN or inf score (diverged weights) becomes null
    metrics = {k: (v if math.isfinite(v) else None)
               for k, v in metrics.items()}
    say(json.dumps({"label": args.label_type, **metrics}))
    return 0


def say(msg: str) -> None:
    """Print on rank 0 only (every rank of a multi-process run computes)."""
    from glfusion_tpu_torch.utils.cluster import get_global_rank

    if get_global_rank() == 0:
        print(msg, flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # multi-process bring-up BEFORE any use of the card: under an MPI-style
    # launcher every process joins the process group on its own card (JAX
    # cli.py:311). No-op for ordinary single-process runs.
    from glfusion_tpu_torch.utils.cluster import initialize_distributed

    initialize_distributed(cpu=args.platform == "cpu")
    if args.debug_nans:
        from glfusion_tpu_torch.utils.debug import debug_nans

        with debug_nans():
            return _main(args)
    return _main(args)


def _main(args: argparse.Namespace) -> int:
    cfg = config_from_args(args)
    apply_tf32_policy(cfg)
    data_paths = (None if args.data_root is None
                  else data_paths_from_root(args.data_root, cfg))
    if args.mode in ("reg-train", "reg-val"):
        return _run_regression(args, cfg, data_paths)
    if args.imagenet_backbone is not None and args.torch_ckpt is not None:
        raise SystemExit("error: --imagenet-backbone is an initialization; "
                         "--torch-ckpt loads a full checkpoint — pick one")
    from glfusion_tpu_torch.utils.cluster import get_world_size

    if args.mode == "export" and get_world_size() > 1:
        raise SystemExit("error: --mode export traces one process's "
                         "forward; run it as a single process")

    from glfusion_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, data_paths=data_paths, device=args.platform)
    if args.imagenet_backbone is not None:
        trainer.load_imagenet_backbone(args.imagenet_backbone)
    restored = False
    if args.torch_ckpt is not None:
        trainer.load_torch_checkpoint(args.torch_ckpt)
        restored = True
    elif args.mode == "serve" and args.from_export is not None:
        pass  # the export carries its own weights
    elif args.resume or args.mode != "train":
        restored = trainer.load_latest()
    if args.mode == "export" and not restored:
        raise SystemExit(
            "error: --mode export found no weights to bake into the "
            "artifact (no checkpoint under --save-dir and no --torch-ckpt);"
            " exporting a random-init model is never what you want")
    if (args.mode in ("val", "serve") and args.from_export is None
            and not restored):
        # a served endpoint or a score on random-init weights is never
        # what the caller wants
        raise SystemExit(
            f"error: --mode {args.mode} found no weights (no checkpoint "
            f"under {cfg.train.save_dir}, no --torch-ckpt, no "
            f"--from-export); train first or point at a checkpoint or an "
            f"export")

    if args.mode == "train":
        _train(trainer)
    elif args.mode == "val":
        if args.sweep:
            trainer.sweep_checkpoints()
        else:
            trainer.validation_and_test()
    elif args.mode == "visual":
        n = trainer.test_visualize(method_name=args.method_name)
        say(f"wrote {n} prediction frames")
    elif args.mode == "infer":
        n = trainer.infer(out_dir=args.out_dir)
        say(f"wrote {n} prediction volumes")
    elif args.mode == "export":
        from glfusion_tpu_torch.utils.model_export import (
            export_serving_forward, save_exported)

        ep = export_serving_forward(cfg, trainer.model, hw=args.export_hw)
        meta = save_exported(ep, args.export_dir, cfg)
        print(f"exported serving forward to {args.export_dir} "
              f"({meta['serialized_bytes']} bytes, device "
              f"{meta['device']}, symbolic frame axis)")
    elif args.http_port is not None:  # serve behind an endpoint
        from glfusion_tpu_torch.http_serve import serve_http

        serve_http(trainer, host=args.http_host, port=args.http_port,
                   from_export=args.from_export)
    else:  # serve
        from glfusion_tpu_torch.serve import serve_test_clips

        stats = serve_test_clips(
            trainer, out_dir=args.out_dir, depth=args.serve_depth,
            threads=args.serve_threads or min(4, os.cpu_count() or 1),
            from_export=args.from_export)
        print(f"served {stats['clips']} clips ({stats['clips_per_s']} "
              f"clips/s, {stats['wall_s']} s): wrote {stats['written']} "
              f"prediction volumes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
