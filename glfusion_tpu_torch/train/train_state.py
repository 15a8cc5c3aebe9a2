"""Optimizer and learning-rate schedule with the reference's semantics.

The port of ``glfusion_tpu/train/train_state.py``: ``Adam(lr=3e-4,
weight_decay=1e-5)`` with ``CosineAnnealingLR(T_max=100)`` stepped once per
EPOCH (reference ``main.py:162-169,257``). torch's own Adam is the
semantics the JAX package copies: the L2 term is added to the gradient
before the moments (not AdamW), eps 1e-8. The cosine is a closed-form
``LambdaLR`` that holds at the floor after ``T_max`` epochs, as the JAX
schedule does (``CosineAnnealingLR``'s recurrence would rise again).

``state_payload`` and ``load_payload`` carry the whole training state to
and from a checkpoint (``utils/checkpoint.py``): the weights and BN
statistics, Adam's moments and step counts, and the schedule's epoch, so a
restored run takes the uninterrupted run's next update.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch

from glfusion_tpu_torch.config import Config


def cosine_factor(epoch: int, t_max: int) -> float:
    """lr(epoch) / base lr: 0.5·(1 + cos(π·min(epoch, T_max)/T_max))."""
    return 0.5 * (1.0 + math.cos(math.pi * min(epoch, t_max) / t_max))


def make_optimizer(cfg: Config,
                   params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.opt.lr,
                            betas=tuple(cfg.opt.betas), eps=1e-8,
                            weight_decay=cfg.opt.weight_decay)


def zero_fill_grads(optimizer: torch.optim.Optimizer) -> None:
    """Give every parameter of ``optimizer`` whose ``grad`` is None a zero
    gradient; a train step calls this just before ``optimizer.step()``.

    This follows the JAX package and departs from the reference. JAX's
    chain (``add_decayed_weights`` then ``scale_by_adam``) sees a zero
    gradient for a parameter the loss does not reach, adds the L2 term,
    updates the moments and counts the step, so such a parameter moves by
    about lr·sign(p) each step (CEN's ``alpha``, ``B2ResNet``'s second
    fork). In the reference torch's Adam skips a parameter without a
    gradient, and the step's ``zero_grad(set_to_none=True)`` leaves
    exactly those without one. With a zero gradient torch's Adam takes
    JAX's update."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_scheduler(cfg: Config, optimizer: torch.optim.Optimizer
                   ) -> torch.optim.lr_scheduler.LambdaLR:
    """Per-epoch cosine; call ``.step()`` once at the end of each epoch."""
    t_max = cfg.opt.cosine_t_max
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda epoch: cosine_factor(epoch, t_max))


def state_payload(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                  scheduler: torch.optim.lr_scheduler.LRScheduler) -> dict:
    """The training state a checkpoint holds (live tensors: the checkpoint
    manager snapshots them)."""
    return {"network": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict()}


def load_payload(payload: dict, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LRScheduler) -> None:
    """Put a checkpoint's state back. The ``LambdaLR`` keeps its lambda (a
    function is not saved) and takes the saved epoch and learning rates."""
    model.load_state_dict(payload["network"])
    optimizer.load_state_dict(payload["optimizer"])
    scheduler.load_state_dict(payload["scheduler"])
