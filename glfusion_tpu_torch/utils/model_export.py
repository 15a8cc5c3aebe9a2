"""Ahead-of-time export of the serving forward as a ``torch.export`` program.

The port of ``glfusion_tpu/utils/model_export.py``. ``torch.export`` takes
the place of ``jax.export``: the serving forward, (V, T, H, W, 1) float32
frames in [0, 1] → (V, T, H, W, C) uint8 masks (logit > 0, the reference
eval's rule), with the weights carried in the program, a **symbolic frame
axis** (``torch.export.Dim``) and the spatial size pinned to ``hw`` (default
``cfg.data.crop_hw``), as in JAX. The TPAVI kernel is recorded as one node
of the registered op ``glfusion_tpu_torch::fused_dot_nonlocal``
(``ops/tpavi_fused.py``), so :func:`load_serving_forward` runs the program
after importing that module alone: no model code, no checkpoint.

A torch export is for one device type: the program is traced on the
device it will run on (the meta records it) and loaded onto that type. The
loaded forward runs with TF32 off for cuBLAS and cuDNN, the CLI's float32
policy, whatever the process's flags.

Artifact layout (a directory):

  * ``serving_fn.pt2`` — the ``torch.export.save`` archive;
  * ``meta.json`` — the shape and IO contract and provenance, JAX's fields
    with ``torch_version`` in place of ``jax_version`` and ``device`` in
    place of ``platforms``; format ``glfusion_tpu_torch.torch_export.v1``.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

_BLOB = "serving_fn.pt2"
_META = "meta.json"
FORMAT = "glfusion_tpu_torch.torch_export.v1"


class ServingForward(torch.nn.Module):
    """A model's serving forward: images → uint8 masks."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return (self.model(images)["mask"] > 0).to(torch.uint8)


def export_serving_forward(cfg, model: torch.nn.Module,
                           hw: Optional[int] = None,
                           device=None) -> torch.export.ExportedProgram:
    """Export ``model``'s serving forward on ``device`` (default: the
    model's) with a symbolic frame axis (any T from 1 to ``clip_length``
    at run time). ``hw`` pins the spatial size (default
    ``cfg.data.crop_hw``)."""
    if cfg.model.arch == "res3dunet":
        raise ValueError(
            "res3dunet has no export with a symbolic frame axis: its adapter "
            "pads the frames to a multiple of 8 (JAX's export fails the "
            "same way)")
    if device is None:
        device = next(model.parameters()).device
    fwd = ServingForward(model).to(device).eval()
    hw = cfg.data.crop_hw if hw is None else int(hw)
    example = torch.zeros((cfg.model.num_views, 2, hw, hw, 1),
                          dtype=torch.float32, device=device)
    shapes = ({1: torch.export.Dim("t", min=1,
                                   max=max(cfg.data.clip_length, 2))},)
    with torch.no_grad():
        return torch.export.export(fwd, (example,), dynamic_shapes=shapes,
                                   strict=False)


def save_exported(ep: torch.export.ExportedProgram, path: str,
                  cfg) -> Dict[str, Any]:
    """Write ``ep`` and its ``meta.json`` into directory ``path``; returns
    the meta."""
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(ep, str(out / _BLOB))
    (spec,) = [s for s in ep.graph_signature.input_specs
               if s.kind == torch.export.graph_signature.InputKind.USER_INPUT]
    node = next(n for n in ep.graph.nodes
                if n.op == "placeholder" and n.name == spec.arg.name)
    in_shape = node.meta["val"].shape
    meta = {
        "format": FORMAT,
        "input": {"shape": ["V", "T", "H", "W", 1], "dtype": "float32",
                  "range": "[0, 1] preprocessed frames"},
        "output": {"shape": ["V", "T", "H", "W", "C"], "dtype": "uint8",
                   "meaning": "per-structure masks, sigmoid > 0.5"},
        "num_views": cfg.model.num_views,
        "views": list(cfg.model.views),
        "input_hw": int(in_shape[2]),  # pinned spatial size (H == W)
        "crop_hw": cfg.data.crop_hw,
        "num_classes": cfg.model.num_classes,
        "device": node.meta["val"].device.type,
        # JAX's fields; the port's exports always leave the frames free
        "symbolic_frames": True,
        "frames": None,
        "torch_version": torch.__version__,
        "serialized_bytes": (out / _BLOB).stat().st_size,
    }
    (out / _META).write_text(json.dumps(meta, indent=2))
    return meta


@contextlib.contextmanager
def ieee_float32():
    """TF32 off for cuBLAS and cuDNN inside the block (``cli.py``'s
    float32 policy), the process's flags put back after."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def read_meta(path: str) -> Dict[str, Any]:
    """An export directory's ``meta.json`` ({} if it has none); raises if
    the directory holds no program or a program of another format."""
    root = Path(path)
    if not (root / _BLOB).exists():
        raise FileNotFoundError(
            f"{path} is not a glfusion_tpu_torch export directory "
            f"(missing {_BLOB})")
    meta: Dict[str, Any] = {}
    if (root / _META).exists():
        meta = json.loads((root / _META).read_text())
    if meta.get("format", FORMAT) != FORMAT:
        raise ValueError(f"{path}: format {meta['format']!r}, expected "
                         f"{FORMAT!r}")
    return meta


def load_serving_forward(path: str, device=None
                         ) -> Tuple[Callable[[Any], torch.Tensor],
                                    Dict[str, Any]]:
    """A saved export → ``(forward, meta)``. ``forward(images)`` takes a
    (V, T, H, W, 1) float32 array or tensor and returns the (V, T, H, W, C)
    uint8 masks on the export's device. Imports the kernel's op
    registration, nothing of the port's models. ``device`` (default: the
    meta's) must be of the type the program was exported for."""
    import glfusion_tpu_torch.ops.tpavi_fused  # noqa: F401  (the op)

    meta = read_meta(path)
    want = torch.device(device if device is not None
                        else meta.get("device", "cpu"))
    if meta.get("device") not in (None, want.type):
        raise ValueError(
            f"export {path} was made for {meta['device']}; it cannot run on "
            f"{want.type}: export again on that device")
    module = torch.export.load(str(Path(path) / _BLOB)).module()

    def forward(images) -> torch.Tensor:
        x = torch.as_tensor(images, dtype=torch.float32).to(want)
        with torch.inference_mode(), ieee_float32():
            return module(x)

    return forward, meta
