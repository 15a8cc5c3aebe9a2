"""Models of the port: the GL-Fusion flagship, its CPS twin, the
segmentation zoo, the video regressors and their building blocks.
``build_model`` is the registry's entry point (``models/registry.py``):
``(module, is_cps)`` of a configuration's ``arch``; ``build_reg_model``
gives ``(module, input_adapter)`` of a ``--reg-model`` name."""

from glfusion_tpu_torch.models.glfusion import (GlobalAndLocal,
                                                GlobalAndLocalCPS)
from glfusion_tpu_torch.models.registry import build_reg_model
from glfusion_tpu_torch.models.registry import build_seg_model as build_model

__all__ = ["GlobalAndLocal", "GlobalAndLocalCPS", "build_model",
           "build_reg_model"]
