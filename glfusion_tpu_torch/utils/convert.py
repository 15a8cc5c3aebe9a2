"""Weights bridge: JAX variables → the port's state dict, and reference
checkpoints.

``state_dict_from_jax`` is the inverse of
``glfusion_tpu/utils/torch_convert.py::convert_state_dict``:

* the stacked leading view axis of the JAX per-view parameters is
  de-interleaved into ``init_block.{v}``, ``layer{s}.{v}``,
  ``classifier.{v}`` and ``centerness.{v}``;
* conv kernels (kh, kw, I, O) become (O, I, kh, kw);
* a Dense (I, O) becomes the 1×1×1 Conv3d weight (O, I, 1, 1, 1);
* BatchNorm ``scale/bias`` params and ``mean/var`` batch stats become
  ``weight/bias/running_mean/running_var``; LayerNorm ``scale/bias`` become
  ``weight/bias``.

Because the port uses the reference's names, ``convert_state_dict`` reads a
port state dict directly, and ``load_checkpoint`` reads a reference
``{'network': state_dict}`` file as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from glfusion_tpu_torch.config import ModelConfig

Tree = Mapping[str, "Tree | np.ndarray"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: Dict, key: str, p: Tree, bias: bool = False) -> None:
    sd[f"{key}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                          (3, 2, 0, 1)))
    if bias:
        sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd: Dict, key: str, p: Tree, s: Tree) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _dense3d(sd: Dict, key: str, p: Tree) -> None:
    k = np.asarray(p["kernel"])
    sd[f"{key}.weight"] = _t(k.T.reshape(k.shape[1], k.shape[0], 1, 1, 1))
    sd[f"{key}.bias"] = _t(p["bias"])


def backbone_state_dict(p: Tree, s: Tree,
                        block_sizes: Sequence[int]) -> Dict[str, torch.Tensor]:
    """JAX ``ResNetIEKD`` variables → ``models.resnet.ResNetIEKD`` names."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "init_block.0", p["stem_conv"], bias=True)
    _bn(sd, "init_block.1", p["stem_bn"], s["stem_bn"])
    for st, blocks in enumerate(block_sizes, 1):
        for b in range(blocks):
            jp, js = p[f"layer{st}_block{b}"], s[f"layer{st}_block{b}"]
            root = f"layer{st}.{b}"
            for j in (1, 2, 3):
                _conv(sd, f"{root}.conv{j}", jp[f"conv{j}"])
                _bn(sd, f"{root}.bn{j}", jp[f"bn{j}"], js[f"bn{j}"])
            if "downsample_conv" in jp:
                _conv(sd, f"{root}.downsample.0", jp["downsample_conv"])
                _bn(sd, f"{root}.downsample.1", jp["downsample_bn"],
                    js["downsample_bn"])
    return sd


def head_state_dict(p: Tree, s: Tree,
                    num_rates: int) -> Dict[str, torch.Tensor]:
    """JAX ``DeepLabHead`` variables → ``models.aspp.DeepLabHead`` names."""
    sd: Dict[str, torch.Tensor] = {}
    ap, as_ = p["aspp"], s["aspp"]
    _conv(sd, "0.convs.0.0", ap["b0_conv"])
    _bn(sd, "0.convs.0.1", ap["b0_bn"], as_["b0_bn"])
    for i in range(1, num_rates + 1):
        _conv(sd, f"0.convs.{i}.0", ap[f"b{i}_conv"])
        _bn(sd, f"0.convs.{i}.1", ap[f"b{i}_bn"], as_[f"b{i}_bn"])
    n = num_rates + 1
    _conv(sd, f"0.convs.{n}.1", ap["pool_conv"])
    _bn(sd, f"0.convs.{n}.2", ap["pool_bn"], as_["pool_bn"])
    _conv(sd, "0.project.0", ap["project_conv"])
    _bn(sd, "0.project.1", ap["project_bn"], as_["project_bn"])
    _conv(sd, "1", p["conv"])
    _bn(sd, "2", p["bn"], s["bn"])
    _conv(sd, "4", p["out_conv"], bias=True)
    return sd


def tpavi_state_dict(p: Tree, s: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``TPAVI`` variables → ``models.tpavi.TPAVI`` names."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("theta", "phi", "g"):
        _dense3d(sd, name, p[name])
    _dense3d(sd, "W_z.0", p["w_z_conv"])
    _bn(sd, "W_z.1", p["w_z_bn"], s["w_z_bn"])
    sd["norm_layer.weight"] = _t(p["norm"]["scale"])
    sd["norm_layer.bias"] = _t(p["norm"]["bias"])
    return sd


def _view(tree: Tree, i: int):
    """Slice the leading (view) axis of every array in a nested dict."""
    if isinstance(tree, Mapping):
        return {k: _view(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def state_dict_from_jax(variables: Mapping[str, Tree],
                        cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX ``GlobalAndLocal`` ``{'params', 'batch_stats'}`` → port state dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i, v in enumerate(cfg.views):
        p, s = _view(params, i), _view(stats, i)
        for k, t in backbone_state_dict(p["backbone"], s["backbone"],
                                        cfg.block_sizes).items():
            head, rest = k.split(".", 1)
            sd[f"{head}.{v}.{rest}"] = t
        for name in ("classifier", "centerness"):
            for k, t in head_state_dict(p[name], s[name],
                                        len(cfg.aspp_rates)).items():
                sd[f"{name}.{v}.{k}"] = t
    for name in ("global_attn", "local_attn"):
        for k, t in tpavi_state_dict(params[name], stats[name]).items():
            sd[f"{name}.{k}"] = t
    return sd


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference ``net_XXXXX.pth`` (``{'network': state_dict}``) into
    a state dict the port's ``GlobalAndLocal`` loads strictly.

    Strips the DataParallel ``module.`` prefix and drops what the port does
    not carry: the reference's ``network.*`` constructor template (deep-
    copied, never run) and the dead TPAVI audio path ``align_channel``.
    """
    data = torch.load(path, map_location="cpu", weights_only=True)
    sd = data.get("network", data)
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    return {k: v for k, v in sd.items()
            if not k.startswith("network.") and ".align_channel." not in k}
