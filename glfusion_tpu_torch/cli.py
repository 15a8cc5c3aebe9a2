"""Command-line entry point of the port: ``python -m glfusion_tpu_torch``.

The port of ``glfusion_tpu/cli.py`` for ``--mode train`` and ``--mode val``
(reference ``main.py --mode``), with the JAX CLI's flag names. Without
``--data-root`` a synthetic corpus exercises the full pipeline. It runs on
the card; ``--platform cpu`` runs on the CPU, and without it a machine with
no CUDA raises. The visual, infer, serve, export and regression modes are
ROADMAP M12/M14.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

from glfusion_tpu_torch.config import ALL_VIEWS, Config, tiny_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="glfusion_tpu_torch",
        description="GL-Fusion multi-view echocardiogram segmentation "
                    "(PyTorch, one NVIDIA H100)")
    p.add_argument("--mode", choices=["train", "val"], default="train",
                   help="train (then validate each epoch) or evaluate the "
                        "newest checkpoint under --save-dir")
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
    p.add_argument("--save-dir", default="./result/ckpt")
    p.add_argument("--log-dir", default="./result/log_info/log_01")
    p.add_argument("--tiny", action="store_true",
                   help="miniature topology and corpus for smoke runs")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (params stay f32). The reference is "
                        "f32; bfloat16 halves activation memory. float32 "
                        "convolutions inherit PyTorch's cuDNN TF32 default")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize backbone blocks (saves activation "
                        "memory at ~30%% extra FLOPs)")
    p.add_argument("--eval-every", type=int, default=1,
                   help="epochs between in-training validations")
    p.add_argument("--save-every", type=int, default=1,
                   help="epochs between checkpoints")
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="cpu runs on the CPU; default: the CUDA card")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = tiny_config() if args.tiny else Config()
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
            cfg.model, views=views,
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
            grad_accum=args.grad_accum,
            save_dir=args.save_dir,
            log_dir=args.log_dir,
            test_views=views,
            eval_every_epochs=args.eval_every,
            save_every_epochs=args.save_every,
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


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    data_paths = (None if args.data_root is None
                  else data_paths_from_root(args.data_root, cfg))

    from glfusion_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, data_paths=data_paths, device=args.platform)
    if args.mode == "train":
        trainer.train()
    else:
        if not trainer.load_latest():
            raise SystemExit(
                f"error: --mode val found no net_*.pth under "
                f"{cfg.train.save_dir}; train first")
        trainer.validation_and_test()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
