"""Layer-by-layer activation capture for parity debugging (port of
``glfusion_tpu/utils/activations.py``).

``capture_activations`` runs the model once with a forward hook on every
module and returns ``{path: array}``: each module's FIRST output, and the
model's outputs as ``__call__.{key}`` and ``__output__.{key}``. Paths are
the JAX package's flax paths (``/``-joined, ending in ``/__call__``)
where the port's module names map onto them, so a JAX dump and a port
dump of the same weights compare with ``diff_activations``:

  * per-view modules (the flagship's ``layer{s}.{v}``, ``classifier.{v}``
    …, the zoo's ``net.{i}``, ``encoder.{i}`` …) drop the view and stack
    the views' outputs on a leading axis, as JAX's ``nn.vmap`` does;
  * the flagship's backbone, heads and attentions take JAX's names
    (``backbone/layer1_block0/conv1``, ``classifier/aspp/b0_conv``,
    ``global_attn/norm``); the zoo's names are JAX's already, except
    ``ConvBNRelu``'s ``conv``/``bn`` (flax ``Conv_0``/``BatchNorm_0``);
  * channels-first outputs become channels-last (CEN's stream-major
    (S·B, …) also (S, B, …)); a module without a JAX counterpart keeps
    its port name, with ``/`` for ``.``.

Modules that return a tuple are skipped, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn


def _stage_name(rest, num_rates: int) -> Optional[list]:
    """The flagship's DeepLabHead child path → JAX names (None: no
    counterpart)."""
    if not rest:
        return []
    head = {"1": "conv", "2": "bn", "4": "out_conv"}
    if rest[0] in head:
        return [head[rest[0]]] if len(rest) == 1 else None
    if rest[0] != "0":
        return None
    rest = rest[1:]  # the ASPP
    if not rest:
        return ["aspp"]
    if rest[0] == "project" and len(rest) == 2:
        name = {"0": "project_conv", "1": "project_bn",
                "3": "project_dropout"}.get(rest[1])
        return ["aspp", name] if name else None
    if rest[0] == "convs" and len(rest) == 3:
        i, j = int(rest[1]), rest[2]
        if i <= num_rates:
            return ["aspp", f"b{i}_{'conv' if j == '0' else 'bn'}"] \
                if j in "01" else None
        name = {"1": "pool_conv", "2": "pool_bn"}.get(j)
        return ["aspp", name] if name else None
    return None


def _flagship_path(model, parts) -> Optional[Tuple[str, int]]:
    views = list(model.cfg.views)
    head = parts[0]
    if head in ("global_attn", "local_attn"):
        if len(parts) == 1:
            return head, None
        return (f"{head}/norm", None) if parts[1:] == ["norm_layer"] else None
    if len(parts) < 2 or parts[1] not in views:
        return None
    vi, rest = views.index(parts[1]), parts[2:]
    if head == "init_block":
        name = {"0": "stem_conv", "1": "stem_bn"}.get(rest[0]) if rest \
            else None
        return (f"backbone/{name}", vi) if name else None
    if head.startswith("layer") and rest:
        path = [f"backbone/{head}_block{rest[0]}"]
        rest = rest[1:]
        if rest[:1] == ["downsample"] and len(rest) == 2:
            rest = [{"0": "downsample_conv", "1": "downsample_bn"}[rest[1]]]
        if rest and not (rest[0].startswith("conv")
                         or rest[0].startswith("bn")
                         or rest[0].startswith("downsample_")):
            return None
        return "/".join(path + rest), vi
    if head in ("classifier", "centerness"):
        names = _stage_name(rest, len(model.cfg.aspp_rates))
        return ("/".join([head] + names), vi) if names is not None else None
    if head in ("merge", "early_mix", "late_mix") and not rest:
        return head, vi
    return None


def _zoo_path(model, parts) -> Tuple[str, Optional[int]]:
    """The zoo's names are JAX's: drop the view index of a per-view
    ``ModuleList`` and rename ``ConvBNRelu``'s children."""
    from glfusion_tpu_torch.models.unet import ConvBNRelu

    out, vi, mod = [], None, model
    for p in parts:
        child = mod._modules[p]
        if isinstance(mod, nn.ModuleList):
            vi = int(p)
        elif isinstance(mod, ConvBNRelu):
            out.append({"conv": "Conv_0", "bn": "BatchNorm_0"}[p])
        else:
            out.append(p)
        mod = child
    return "/".join(out), vi


def _to_numpy(t: torch.Tensor, channels_first: bool,
              streams: Optional[int]) -> np.ndarray:
    if channels_first and t.dim() >= 4:
        t = t.movedim(1, -1)
        if streams:
            t = t.reshape(streams, -1, *t.shape[1:])
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def capture_activations(model: nn.Module, x: torch.Tensor,
                        train: bool = False,
                        **forward_kwargs) -> Dict[str, np.ndarray]:
    """Run ``model(x, **forward_kwargs)`` in train or eval mode (restored
    after) with every module's first output captured; returns the flat
    ``{path: array}`` dict described in the module docstring."""
    from glfusion_tpu_torch.models.cen import CENRefineNet
    from glfusion_tpu_torch.models.glfusion import GlobalAndLocal
    from glfusion_tpu_torch.models.tpavi import TPAVI

    firsts: Dict[str, tuple] = {}
    hooks = []
    tpavi = {n for n, m in model.named_modules() if isinstance(m, TPAVI)}
    cen = next((m.streams for m in model.modules()
                if isinstance(m, CENRefineNet)), None)
    for name, mod in model.named_modules():
        if not name:
            continue

        def hook(m, args, out, name=name):
            if name not in firsts and isinstance(out, torch.Tensor):
                firsts[name] = out.clone()  # an in-place ReLU may follow

        hooks.append(mod.register_forward_hook(hook))
    was = model.training
    model.train(train)
    try:
        with torch.no_grad():
            out = model(x, **forward_kwargs)
    finally:
        model.train(was)
        for h in hooks:
            h.remove()

    grouped: Dict[str, dict] = {}
    for name, t in firsts.items():
        parts = name.split(".")
        if isinstance(model, GlobalAndLocal):
            mapped = _flagship_path(model, parts)
        else:
            mapped = _zoo_path(model, parts)
        key, vi = mapped if mapped else (name.replace(".", "/"), None)
        in_tpavi = any(name == p or name.startswith(p + ".") for p in tpavi)
        arr = _to_numpy(t, not in_tpavi, cen)
        grouped.setdefault(f"{key}/__call__", {})[vi] = arr
    flat = {}
    for key, per in grouped.items():
        if None in per:
            flat[key] = per[None]
        else:
            flat[key] = np.stack([per[i] for i in sorted(per)])
    if isinstance(out, dict):
        for k, v in out.items():
            if isinstance(v, torch.Tensor):
                flat[f"__call__.{k}"] = flat[f"__output__.{k}"] = \
                    _to_numpy(v, False, None)
    return flat


def diff_activations(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                     atol: float = 1e-4) -> Dict[str, float]:
    """Max-abs differences for keys present in both dumps; sorted
    worst-first (a shape mismatch reads inf)."""
    diffs = {}
    for k in sorted(set(a) & set(b)):
        if a[k].shape != b[k].shape:
            diffs[k] = float("inf")
        else:
            diffs[k] = float(np.max(np.abs(a[k].astype(np.float64)
                                           - b[k].astype(np.float64))))
    return dict(sorted(diffs.items(), key=lambda kv: -kv[1]))
