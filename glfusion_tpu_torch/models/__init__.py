"""Models of the port: the GL-Fusion flagship, its CPS twin, the
segmentation zoo and their building blocks. ``build_model`` is the
registry's entry point (``models/registry.py``): ``(module, is_cps)`` of a
configuration's ``arch``."""

from glfusion_tpu_torch.models.glfusion import (GlobalAndLocal,
                                                GlobalAndLocalCPS)
from glfusion_tpu_torch.models.registry import build_seg_model as build_model

__all__ = ["GlobalAndLocal", "GlobalAndLocalCPS", "build_model"]
