"""Sharding rules: data-parallel batches and the model axis's split leaves.

The port of ``glfusion_tpu/parallel/sharding.py``.

* Batches split their batch axis over ``data`` (:func:`shard_batch`): each
  rank takes its contiguous slice. Stacked views (V, B, ...) split axis 1,
  a clip's frames (V, T, ...) too, regressor batches axis 0. A batch axis
  ``data`` does not divide is replicated. Every rank decodes the whole
  host batch from the same seed, as JAX's ``device_put_global`` does.
* A parameter or BatchNorm statistic splits its output-channel axis over
  ``model`` when that axis is at least ``_MIN_SHARD_DIM`` and divisible by
  the model size; everything else is replicated. That is JAX's
  ``variable_pspec`` (the last axis of a flax leaf) on torch layouts:
  axis 0 of a ``Conv*d`` or ``Linear`` weight, axis 1 of a
  ``ConvTranspose*d`` weight, the only axis of a bias and of a norm's
  vectors and running statistics, the channel axis (1) of CEN's stacked
  (S, C) stream BatchNorms, and the last axis of any other parameter
  (TimeSformer's class tokens).
* Each rank stores only its slice of a split leaf, so Adam's moments
  follow. A split leaf is gathered over ``model`` where a layer reads it
  (the backward keeps this rank's slice of its gradient), so every model
  rank computes the whole layer; the split saves the leaves' and Adam's
  memory, not FLOPs.

Gradients (:func:`reduce_gradients`): a split leaf's are summed over
``data``; a replicated leaf's are summed over the world and divided by the
model size, so every rank holds the same bits and the replicas cannot
drift apart (cuDNN's weight gradients are not deterministic across
processes).
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.nn as nn

from glfusion_tpu_torch.parallel import context
from glfusion_tpu_torch.parallel.collectives import Axis, gather
from glfusion_tpu_torch.parallel.mesh import Mesh
from glfusion_tpu_torch.parallel.norm import (SplitDropout, SyncBatchNorm,
                                              SyncStreamBN)

# Minimum channel count worth sharding over the model axis.
_MIN_SHARD_DIM = 256

_CONV = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_CONV_T = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def _stream_bn(module: nn.Module) -> bool:
    from glfusion_tpu_torch.models.cen import StreamBN
    return isinstance(module, (StreamBN, SyncStreamBN))


def leaf_axis(module: nn.Module, name: str, leaf: torch.Tensor) -> int:
    """The torch axis that a flax leaf's last (output-channel) axis maps
    to, for the leaf ``name`` of ``module``."""
    if leaf.dim() <= 1:
        return 0
    if _stream_bn(module):
        return 1
    if name == "weight" and isinstance(module, _CONV_T):
        return 1
    if name == "weight" and isinstance(module, _CONV + (nn.Linear,)):
        return 0
    return leaf.dim() - 1


def shard_axis(module: nn.Module, name: str, leaf: torch.Tensor,
               model_size: int) -> int | None:
    """``variable_pspec``'s rule: the axis this leaf is split on over a
    model axis of ``model_size``, or None (replicated)."""
    if model_size <= 1 or leaf.dim() < 1:
        return None
    axis = leaf_axis(module, name, leaf)
    n = leaf.shape[axis]
    if n >= _MIN_SHARD_DIM and n % model_size == 0:
        return axis
    return None


class _SplitLeaves:
    """Mixin of a module whose split parameters are gathered over
    ``model`` where the module reads them (``self.weight``)."""

    def __getattr__(self, name):
        split = self.__dict__.get("_split_leaves")
        if split is not None and name in split:
            axis, dim = split[name]
            leaf = self._parameters[name]
            return context.gathered((id(self), name),
                                    lambda: gather(leaf, axis, dim))
        return super().__getattr__(name)


_SPLIT_TYPES: Dict[type, type] = {}


def _split_type(cls: type) -> type:
    if cls not in _SPLIT_TYPES:
        _SPLIT_TYPES[cls] = type(cls.__name__, (_SplitLeaves, cls),
                                 {"__module__": cls.__module__})
    return _SPLIT_TYPES[cls]


def _swap_layers(model: nn.Module) -> None:
    """The cross-rank BatchNorms and dropout in place of torch's."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            new = None
            if isinstance(child, nn.modules.batchnorm._BatchNorm) and \
                    not isinstance(child, SyncBatchNorm):
                new = SyncBatchNorm.replacing(child)
            elif _stream_bn(child) and not isinstance(child, SyncStreamBN):
                new = SyncStreamBN.replacing(child)
            elif type(child) is nn.Dropout:
                new = SplitDropout(child.p, child.inplace)
                new.train(child.training)
            if new is not None:
                parent._modules[name] = new


def split_leaves(model: nn.Module):
    """(module, name, model axis, dim) of every leaf split over ``model``
    (``shard_module``'s cut): parameters and running statistics."""
    for module in model.modules():
        split = module.__dict__.get("_split_leaves", {})
        for name, (axis, dim) in split.items():
            yield module, name, axis, dim
        stat_axis = module.__dict__.get("stat_axis")
        if stat_axis is not None:
            dim = 1 if isinstance(module, SyncStreamBN) else 0
            for name in ("running_mean", "running_var"):
                yield module, name, stat_axis, dim


def _is_norm(module: nn.Module) -> bool:
    return isinstance(module, nn.modules.batchnorm._BatchNorm) or \
        _stream_bn(module)


def split_plan(model: nn.Module, model_size: int) -> Dict[str, int]:
    """The rule's verdict on every leaf: state-dict key → the dim it is
    split on over a model axis of ``model_size`` (absent: replicated).
    Parameters, and the running statistics of the BatchNorms."""
    plan = {}
    for prefix, module in model.named_modules():
        leaves = list(module._parameters.items())
        if _is_norm(module):
            leaves += [(n, module._buffers.get(n))
                       for n in ("running_mean", "running_var")]
        for name, leaf in leaves:
            dim = None if leaf is None else shard_axis(module, name, leaf,
                                                      model_size)
            if dim is not None:
                plan[f"{prefix}.{name}" if prefix else name] = dim
    return plan


def shard_module(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Prepare ``model`` (already on its device, before its optimizer is
    made) for ``mesh``: the cross-rank BatchNorms and dropout, then each
    split leaf (:func:`split_plan`) cut to this rank's slice. A trivial
    mesh changes nothing. Every rank must hold the same full weights when
    this is called (built from the same seed, or loaded from one file)."""
    if mesh.trivial:
        return model
    _swap_layers(model)
    plan = split_plan(model, mesh.model)
    axis = mesh.model_axis
    for prefix, module in model.named_modules():
        split = {}
        for name in list(module._parameters) + list(module._buffers):
            dim = plan.get(f"{prefix}.{name}" if prefix else name)
            if dim is None:
                continue
            if name in module._parameters:
                p = module._parameters[name]
                p.data = axis.own(p.data, dim).clone()
                split[name] = (axis, dim)
            else:
                module._buffers[name] = axis.own(module._buffers[name],
                                                 dim).clone()
                module.stat_axis = axis
        if split:
            module._split_leaves = split
            module.__class__ = _split_type(module.__class__)
    return model


def _split_map(model: nn.Module) -> Dict[str, tuple]:
    """state-dict key → (model axis, split dim) of every split leaf."""
    names = {id(m): n for n, m in model.named_modules()}
    out = {}
    for module, name, axis, dim in split_leaves(model):
        prefix = names[id(module)]
        out[f"{prefix}.{name}" if prefix else name] = (axis, dim)
    return out


def gather_many(leaves, axis: Axis) -> list:
    """Each (tensor, dim) gathered along its dim over ``axis``, in buckets
    of one all-reduce."""
    if axis.size == 1:
        return [t for t, _ in leaves]
    bufs = []
    for t, dim in leaves:
        shape = list(t.shape)
        shape[dim] *= axis.size
        buf = t.new_zeros(shape)
        buf.narrow(dim, axis.index * t.shape[dim], t.shape[dim]).copy_(t)
        bufs.append(buf)
    _all_reduce_many(bufs, axis)
    return bufs


def _gather_split(items) -> list:
    """Gather each (tensor, (axis, dim)), one bucketed gather per axis."""
    out = [None] * len(items)
    by_axis: Dict[int, list] = {}
    for i, (t, (axis, dim)) in enumerate(items):
        by_axis.setdefault(id(axis), []).append((i, t, axis, dim))
    for group in by_axis.values():
        whole = gather_many([(t, dim) for _, t, _, dim in group],
                            group[0][2])
        for (i, _, _, _), t in zip(group, whole):
            out[i] = t
    return out


def unshard_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every split leaf gathered whole (a
    collective on a sharded model: every rank calls it and gets the full
    tensors)."""
    sd = model.state_dict()
    split = _split_map(model)
    keys = [k for k in sd if k in split]
    whole = dict(zip(keys, _gather_split([(sd[k].detach(), split[k])
                                          for k in keys])))
    return {k: whole.get(k, v) for k, v in sd.items()}


def shard_state_dict(full: Dict[str, torch.Tensor],
                     model: nn.Module) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this rank's slices (for ``load_state_dict``
    of a sharded model; unchanged for an unsharded one)."""
    split = _split_map(model)
    return {k: (split[k][0].own(v, split[k][1]) if k in split else v)
            for k, v in full.items()}


def param_dims(model: nn.Module) -> Dict[int, tuple]:
    """id(parameter) → (model axis, split dim) of every split parameter."""
    return {id(module._parameters[name]): (axis, dim)
            for module, name, axis, dim in split_leaves(model)
            if name in module._parameters}


def _optimizer_params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def unshard_optimizer_state(optimizer: torch.optim.Optimizer,
                            model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of split parameters
    gathered whole (a collective on a sharded model)."""
    sd = optimizer.state_dict()
    dims = param_dims(model)
    todo = []  # (param index, state key, tensor, (axis, dim))
    for i, p in enumerate(_optimizer_params(optimizer)):
        split = dims.get(id(p))
        for k, v in sd["state"].get(i, {}).items():
            if split is not None and torch.is_tensor(v) and v.dim() > 0 \
                    and v.shape == p.shape:
                todo.append((i, k, v, split))
    if not todo:
        return sd
    whole = _gather_split([(v, split) for _, _, v, split in todo])
    state = {i: dict(entry) for i, entry in sd["state"].items()}
    for (i, k, _, _), t in zip(todo, whole):
        state[i][k] = t
    return {**sd, "state": state}


def shard_optimizer_state(full: dict, optimizer: torch.optim.Optimizer,
                          model: nn.Module) -> dict:
    """A full optimizer state dict cut to this rank's slices."""
    dims = param_dims(model)
    if not dims:
        return full
    params = _optimizer_params(optimizer)
    state = {}
    for i, entry in full["state"].items():
        p = params[int(i)]
        split = dims.get(id(p))
        state[i] = {k: (split[0].own(v, split[1])
                        if split is not None and torch.is_tensor(v)
                        and v.dim() > 0 and v.shape != p.shape else v)
                    for k, v in entry.items()}
    return {**full, "state": state}


def shard_batch(batch, mesh: Mesh, batch_axis: int = 1):
    """Each tensor of ``batch`` (a dict, or one tensor) cut to this rank's
    contiguous slice of ``batch_axis`` over ``data``; a tensor whose batch
    axis ``data`` does not divide is kept whole (replicated)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, batch_axis) for k, v in batch.items()}
    if batch.dim() > batch_axis and mesh.divides(batch.shape[batch_axis]):
        return mesh.data_axis.own(batch, batch_axis)
    return batch


def _buckets(tensors, limit: int = 1 << 24):
    """Runs of same-type, same-device tensors of at most ``limit``
    elements (a larger tensor alone)."""
    run, n = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or n + t.numel() > limit):
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


def _all_reduce_many(tensors: Iterable[torch.Tensor], axis: Axis,
                     divide: int = 1) -> None:
    """Sum each tensor in place over ``axis`` (flattened in buckets), then
    divide by ``divide``."""
    if axis.size == 1 and divide == 1:
        return
    for run in _buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in run])
        axis.all_reduce_(flat)
        if divide != 1:
            flat.div_(divide)
        offset = 0
        for t in run:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def reduce_gradients(params: Iterable[torch.nn.Parameter], model: nn.Module,
                     mesh: Mesh) -> None:
    """Sum the step's gradients over ``data``: a split leaf's over its data
    axis; a replicated leaf's over the world, divided by the model size
    (the same bits on every rank). Every parameter has a gradient
    (``zero_fill_grads`` first)."""
    if mesh.trivial:
        return
    dims = param_dims(model)
    params = list(params)
    split = [p.grad for p in params if id(p) in dims]
    whole = [p.grad for p in params if id(p) not in dims]
    _all_reduce_many(split, mesh.data_axis)
    _all_reduce_many(whole, mesh.world_axis, divide=mesh.model)


def global_grad_norm(params: Iterable[torch.nn.Parameter], model: nn.Module,
                     mesh: Mesh) -> torch.Tensor:
    """The float32 norm of the whole gradient after the reduction: each
    replicated leaf once, each split leaf's slices summed over ``model``."""
    params = list(params)
    if mesh.trivial:
        return torch.nn.utils.get_total_norm([p.grad.float()
                                              for p in params])
    dims = param_dims(model)
    sq = lambda ps: sum((p.grad.float().pow(2).sum() for p in ps),  # noqa
                        torch.zeros((), device=params[0].grad.device))
    split = sq([p for p in params if id(p) in dims])
    whole = sq([p for p in params if id(p) not in dims])
    if dims:
        mesh.model_axis.all_reduce_(split)
    return torch.sqrt(whole + split)


def check_replicas_equal(model: nn.Module, mesh: Mesh) -> list:
    """Names of the replicated leaves (floating parameters and buffers)
    whose bits differ from rank 0's on any rank (a collective; rank 0's
    values reach every rank as an all-reduce of them and zeros, exact)."""
    if mesh.trivial:
        return []
    split = _split_map(model)
    leaves = [(k, v.detach()) for k, v in model.state_dict().items()
              if k not in split and torch.is_floating_point(v)]
    bad = []
    for run in _buckets([v for _, v in leaves]):
        mine = torch.cat([t.reshape(-1) for t in run])
        lead = mesh.world_axis.all_reduce_(
            mine.clone() if mesh.rank == 0 else torch.zeros_like(mine))
        offset = 0
        for t in run:
            n = t.numel()
            if not torch.equal(mine[offset:offset + n],
                               lead[offset:offset + n]):
                bad.append(next(k for k, v in leaves if v is t))
            offset += n
    flags = torch.tensor([float(len(bad))], device=_any_device(model))
    mesh.world_axis.all_reduce_(flags)
    if flags.item() and not bad:
        bad.append("(another rank)")
    return bad


def _any_device(model: nn.Module) -> torch.device:
    for t in model.state_dict().values():
        return t.device
    return torch.device("cpu")


def split_count(model: nn.Module) -> tuple[int, int]:
    """(split leaves, all leaves) of the model's state dict."""
    return len(_split_map(model)), len(model.state_dict())
