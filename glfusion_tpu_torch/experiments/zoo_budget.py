"""A zoo arch's budget at ``Config()`` widths, from its model alone: the
forward FLOP a frame-view (``utils/profiling.flops_of`` on the meta
device) and the bytes a train-mode forward saves for its backward, a
frame-view (``saved_tensors_hooks``, on the CPU). The ``zoo`` phase's
predictions in PERF.md were made from these.

A regressor's (``--reg``: ``build_reg_model`` at JAX's full-width
defaults, 3 views of 48 frames at 112²) is taken a sample, all on the
meta device: no memory, no arithmetic; each saved tensor counted once.
The ``regression`` phase's predictions were made from these.

    python -m glfusion_tpu_torch.experiments.zoo_budget [arch ...]
    python -m glfusion_tpu_torch.experiments.zoo_budget --reg [name ...]
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.arch_names import REG_ARCHS
from glfusion_tpu_torch.models import build_model, build_reg_model
from glfusion_tpu_torch.utils.profiling import flops_of

ARCHS = ("unet", "unet:r2", "unet:att", "unet:r2att", "multiview_unet",
         "utnet", "cen", "res3dunet")


def budget(arch: str, frames: int = 8, hw: int = 112) -> dict:
    """FLOP and saved bytes a frame-view of ``arch`` on ``frames`` frames
    a view (res3dunet folds them into one volume, so it needs 8)."""
    cfg = dataclasses.replace(Config().model, arch=arch)
    views = cfg.num_views
    with torch.device("meta"):
        meta, _ = build_model(cfg, hw=hw)
    x = torch.zeros(views, frames, hw, hw, 1, device="meta")
    with torch.no_grad():
        flop = flops_of(lambda t: meta.eval()(t), x)
    torch.manual_seed(0)
    model, _ = build_model(cfg, hw=hw)
    saved = {}

    def pack(t):
        saved[(t.data_ptr(), t.dtype, tuple(t.shape))] = (
            t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.train()(torch.rand(views, frames, hw, hw, 1))
    n = views * frames
    return {"arch": arch,
            "params": sum(p.numel() for p in model.parameters()),
            "fwd_flop_per_frame": flop / n if flop is not None else None,
            "saved_bytes_per_frame": sum(saved.values()) / n}


def reg_budget(name: str, views: int = 3, frames: int = 48,
               hw: int = 112) -> dict:
    """Forward FLOP and saved bytes of one sample of a regressor."""
    with torch.device("meta"):
        model, adapter = build_reg_model(name, views)
    x = adapter(torch.zeros(views, 1, hw, hw, frames, device="meta"))
    with torch.no_grad():
        flop = flops_of(lambda t: model.eval()(t), x)
    saved = {}

    def pack(t):  # the graph keeps t alive, so its id stays its own
        saved[id(t)] = t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.train()(x)
    return {"name": name,
            "params": sum(p.numel() for p in model.parameters()),
            "fwd_flop_per_sample": flop,
            "saved_bytes_per_sample": sum(saved.values())}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reg"]:
        for name in sys.argv[2:] or REG_ARCHS:
            print(reg_budget(name), flush=True)
    else:
        for name in sys.argv[1:] or ARCHS:
            print(budget(name), flush=True)
