"""Weights bridge: JAX variables → the port's state dict, and reference
checkpoints.

``state_dict_from_jax`` is the inverse of
``glfusion_tpu/utils/torch_convert.py::convert_state_dict``:

* the stacked leading view axis of the JAX per-view parameters is
  de-interleaved into ``init_block.{v}``, ``layer{s}.{v}``,
  ``classifier.{v}`` and ``centerness.{v}``, and the variants' 1×1 convs
  (JAX ``PointwiseConv``) into names the port gives them: JAX ``merge``
  (``conv_merge``), ``early_mix`` (``early_fusion``) and ``late_mix``
  (``late_fusion``) become ``merge.{v}``, ``early_mix.{v}`` and
  ``late_mix.{v}`` (``.weight`` (O, I, 1, 1), ``.bias``). The reference's
  own names for these convs are not known, and JAX's
  ``convert_state_dict`` does not map them;
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

from glfusion_tpu_torch.arch_names import REG_ARCHS
from glfusion_tpu_torch.config import ModelConfig

Tree = Mapping[str, "Tree | np.ndarray"]
# the variants' per-view 1×1 convs, under the same name in both packages
MIXES = ("merge", "early_mix", "late_mix")


def _t(a) -> torch.Tensor:
    """float32; float64 arrays (a float64 JAX tree) stay float64."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(
        a, dtype=np.float64 if a.dtype == np.float64 else np.float32))


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


def aspp_state_dict(p: Tree, s: Tree,
                    num_rates: int) -> Dict[str, torch.Tensor]:
    """JAX ``ASPP`` variables → ``models.aspp.ASPP`` names (either of its
    forms: the parameter paths and shapes are the same)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "convs.0.0", p["b0_conv"])
    _bn(sd, "convs.0.1", p["b0_bn"], s["b0_bn"])
    for i in range(1, num_rates + 1):
        _conv(sd, f"convs.{i}.0", p[f"b{i}_conv"])
        _bn(sd, f"convs.{i}.1", p[f"b{i}_bn"], s[f"b{i}_bn"])
    n = num_rates + 1
    _conv(sd, f"convs.{n}.1", p["pool_conv"])
    _bn(sd, f"convs.{n}.2", p["pool_bn"], s["pool_bn"])
    _conv(sd, "project.0", p["project_conv"])
    _bn(sd, "project.1", p["project_bn"], s["project_bn"])
    return sd


def head_state_dict(p: Tree, s: Tree,
                    num_rates: int) -> Dict[str, torch.Tensor]:
    """JAX ``DeepLabHead`` variables → ``models.aspp.DeepLabHead`` names."""
    sd = {f"0.{k}": t for k, t in aspp_state_dict(
        p["aspp"], s["aspp"], num_rates).items()}
    _conv(sd, "1", p["conv"])
    _bn(sd, "2", p["bn"], s["bn"])
    _conv(sd, "4", p["out_conv"], bias=True)
    return sd


def tpavi_state_dict(p: Tree, s: Tree) -> Dict[str, torch.Tensor]:
    """JAX ``TPAVI`` variables of any mode → ``models.tpavi.TPAVI`` names
    (``gaussian`` has no θ, φ; ``concatenate``'s Dense ``w_f`` (2C', 1) is
    the 1×1 conv ``W_f.0``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("theta", "phi", "g"):
        if name in p:
            _dense3d(sd, name, p[name])
    if "w_f" in p:  # a Dense (2C', 1) is the 1×1 conv (1, 2C', 1, 1)
        _conv(sd, "W_f.0", {"kernel": np.asarray(p["w_f"]["kernel"])[
            None, None], "bias": p["w_f"]["bias"]}, bias=True)
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
    """JAX ``GlobalAndLocal`` ``{'params', 'batch_stats'}`` of any variant
    → port state dict (the modules the variant has); JAX
    ``GlobalAndLocalCPS`` variables (``net1``, ``net2`` trees) → the port
    twin's ``net1.*``, ``net2.*``."""
    params, stats = variables["params"], variables["batch_stats"]
    if "net1" in params:
        return {f"{net}.{k}": t for net in ("net1", "net2")
                for k, t in state_dict_from_jax(
                    {"params": params[net], "batch_stats": stats[net]},
                    cfg).items()}
    sd: Dict[str, torch.Tensor] = {}
    for i, v in enumerate(cfg.views):
        p, s = _view(params, i), _view(stats, i)
        for k, t in backbone_state_dict(p["backbone"], s["backbone"],
                                        cfg.block_sizes).items():
            head, rest = k.split(".", 1)
            sd[f"{head}.{v}.{rest}"] = t
        for name in ("classifier", "centerness"):
            if name in p:
                for k, t in head_state_dict(p[name], s[name],
                                            len(cfg.aspp_rates)).items():
                    sd[f"{name}.{v}.{k}"] = t
        for name in MIXES:
            if name in p:
                _conv(sd, f"{name}.{v}", p[name]["conv"], bias=True)
    for name in ("global_attn", "local_attn"):
        if name in params:
            for k, t in tpavi_state_dict(params[name],
                                         stats[name]).items():
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


# ------------------------------------------------------------------ the zoo

# where JAX stacks a per-view copy of the tree (``nn.vmap``) and the port
# holds ``.{i}`` modules; CEN's streams are stacked inside its StreamBNs
_ZOO_PER_VIEW = {"unet": ("net/encoder", "net/decoder"),
                 "multiview_unet": ("net/encoder", "net/decoder"),
                 "utnet": ("net",), "res3dunet": ("net",), "cen": ()}
# flax's automatic names of ConvBNRelu's children → the port's
_ZOO_RENAME = {"Conv_0": "conv", "BatchNorm_0": "bn"}


def _zoo_per_view(arch: str) -> tuple:
    if arch.startswith("unet:"):
        return ("net",)
    if arch not in _ZOO_PER_VIEW:
        raise ValueError(f"zoo_state_dict_from_jax: no mapping for {arch!r}")
    return _ZOO_PER_VIEW[arch]


def _zoo_kernel(k: np.ndarray, transposed: bool) -> np.ndarray:
    """flax (k…, I, O) → torch (O, I, k…); a flax ``ConvTranspose``
    (``transpose_kernel=False``, no flip) → torch ``ConvTranspose3d``
    (I, O, k…), whose taps run flipped."""
    n = k.ndim - 2
    if transposed:
        return np.flip(np.transpose(k, (n, n + 1) + tuple(range(n))),
                       axis=tuple(range(2, n + 2)))
    return np.transpose(k, (n + 1, n) + tuple(range(n)))


def _zoo_node(sd: Dict, key: str, name: str, p: Tree, s: Tree,
              transposed: bool) -> None:
    """The leaves of one flax module (its parameters and batch stats)."""
    if "kernel" in p:
        sd[f"{key}.weight"] = _t(np.ascontiguousarray(
            _zoo_kernel(np.asarray(p["kernel"]), transposed)))
        if "bias" in p:
            sd[f"{key}.bias"] = _t(p["bias"])
    elif "scale" in p:  # BatchNorm (C,), or CEN's StreamBN (S, C)
        if np.ndim(p["scale"]) == 1:
            _bn(sd, key, p, s)
        else:
            sd[f"{key}.weight"] = _t(p["scale"])
            sd[f"{key}.bias"] = _t(p["bias"])
            sd[f"{key}.running_mean"] = _t(s["mean"])
            sd[f"{key}.running_var"] = _t(s["var"])
    if "table" in p:  # UTNet's relative position bias
        sd[f"{key}.table"] = _t(p["table"])
    if "alpha" in p:  # a PReLU's slopes, or CEN's ensemble logits
        sd[f"{key}.weight" if name == "prelu" else f"{key}.alpha"] = _t(
            p["alpha"])


def _first_leaf(tree: Tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _zoo_walk(sd: Dict, key: str, path: tuple, p: Tree, s: Tree,
              per_view: tuple, arch: str) -> None:
    """Convert the flax module at ``path`` (its names) into port key
    ``key``, then its children."""
    if "/".join(path) in per_view:
        for i in range(np.shape(_first_leaf(p))[0]):
            _zoo_walk(sd, f"{key}.{i}", path + (str(i),), _view(p, i),
                      _view(s, i), per_view, arch)
        return
    name = path[-1] if path else ""
    if name == "global_attn":  # multiview_unet's TPAVI
        for k, t in tpavi_state_dict(p, s).items():
            sd[f"{key}.{k}"] = t
        return
    transposed = (arch == "res3dunet" and path[-2:-1] in
                  (("up2",), ("up3",), ("up4",)) and name == "conv")
    _zoo_node(sd, key, name, p, s, transposed)
    for child, sub in p.items():
        if isinstance(sub, Mapping):
            part = _ZOO_RENAME.get(child, child)
            _zoo_walk(sd, f"{key}.{part}" if key else part, path + (child,),
                      sub, s.get(child, {}), per_view, arch)


def zoo_state_dict_from_jax(variables: Mapping[str, Tree], arch: str,
                            per_view: bool = True
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``build_seg_model`` variables of a zoo arch (``unet``,
    ``multiview_unet``, ``unet:<kind>``, ``utnet``, ``cen``,
    ``res3dunet``) → the port adapter's state dict (``models/registry.py``).

    2-D kernels HWIO → OIHW, 3-D kernels DHWIO → OIDHW, depthwise kernels
    (3, 3, 1, C) → (C, 1, 3, 3) by the same rule; a per-view stacked tree
    (JAX ``nn.vmap``) becomes ``.{i}`` modules; BatchNorm ``scale/bias`` and
    ``mean/var`` become ``weight/bias/running_mean/running_var``, CEN's
    stacked (S, C) StreamBN leaves as they are; res3dunet's flax
    ``ConvTranspose`` kernels have their taps flipped (``_zoo_kernel``); a
    PReLU's ``alpha`` is ``prelu.weight``; TPAVI as ``tpavi_state_dict``.
    ``per_view=False``: the arch's network alone, not lifted over views.
    """
    sd: Dict[str, torch.Tensor] = {}
    _zoo_walk(sd, "", (), variables["params"],
              variables.get("batch_stats", {}),
              _zoo_per_view(arch) if per_view else (), arch)
    return sd


# ---------------------------------------------------------- the regressors

def _reg_walk(sd: Dict, key: str, p: Tree, s: Tree, flip: tuple) -> None:
    """The flax module tree ``p`` (batch stats ``s``) under port key
    ``key``; the port's module names are JAX's."""
    for name, sub in p.items():
        k = f"{key}.{name}" if key else name
        if not isinstance(sub, Mapping):
            if name == "conv_kernel":  # ECA's flax (k, 1, 1) WIO kernel
                sd[f"{key}.conv.weight"] = _t(np.ascontiguousarray(
                    np.transpose(np.asarray(sub), (2, 1, 0))))
            else:  # TimeSformer's cls_token
                sd[k] = _t(sub)
        elif "kernel" in sub:  # Conv, ConvTranspose, Dense
            sd[f"{k}.weight"] = _t(np.ascontiguousarray(_zoo_kernel(
                np.asarray(sub["kernel"]), transposed=name in flip)))
            if "bias" in sub:
                sd[f"{k}.bias"] = _t(sub["bias"])
        elif "scale" in sub:
            if name in s:  # BatchNorm
                _bn(sd, k, sub, s[name])
            else:  # LayerNorm
                sd[f"{k}.weight"] = _t(sub["scale"])
                sd[f"{k}.bias"] = _t(sub["bias"])
        else:
            _reg_walk(sd, k, sub, s.get(name, {}), flip)


def reg_state_dict_from_jax(variables: Mapping[str, Tree],
                            name: str) -> Dict[str, torch.Tensor]:
    """JAX ``build_reg_model`` variables of a regressor (``resnet50pah``,
    ``r2plus1d``, ``timesformer``, ``resnet50pfs``) → the port module's
    state dict (``models/registry.build_reg_model``; the names are JAX's).

    Conv kernels DHWIO → OIDHW and Dense (I, O) → Linear (O, I)
    (``_zoo_kernel``); Resnet50PFS's flax ``ConvTranspose`` ``seg_deconv``
    with its taps flipped and in/out swapped; ECA's (k, 1, 1)
    ``conv_kernel`` → ``eca.conv.weight`` (1, 1, k); BatchNorm leaves as
    ``_bn``; LayerNorm ``scale/bias`` → ``weight/bias``; ``cls_token`` as
    it is. No reference checkpoint exists for these models, so there is no
    ``--torch-ckpt`` for them (JAX's ``utils/torch_convert.py`` maps none
    either)."""
    if name not in REG_ARCHS:
        raise ValueError(f"reg_state_dict_from_jax: no mapping for {name!r}")
    sd: Dict[str, torch.Tensor] = {}
    _reg_walk(sd, "", variables["params"], variables.get("batch_stats", {}),
              ("seg_deconv",) if name == "resnet50pfs" else ())
    return sd
