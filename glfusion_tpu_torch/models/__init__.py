"""Models of the port: the GL-Fusion flagship, its CPS twin, the
segmentation zoo, the video regressors and their building blocks.
``build_model`` is the registry's entry point (``models/registry.py``):
``(module, is_cps)`` of a configuration's ``arch``; ``build_reg_model``
gives ``(module, input_adapter)`` of a ``--reg-model`` name."""

from glfusion_tpu_torch.models.avs import (AVSBaseline, AVSTransfusion,
                                           B2ResNet, PredEndecoder)
from glfusion_tpu_torch.models.glfusion import (GlobalAndLocal,
                                                GlobalAndLocalCPS)
from glfusion_tpu_torch.models.legacy_variants import (LegacyMultiviewSeg,
                                                       SpatialConcatFusion,
                                                       SpatialMLP)
from glfusion_tpu_torch.models.registry import build_reg_model
from glfusion_tpu_torch.models.registry import build_seg_model as build_model

__all__ = ["AVSBaseline", "AVSTransfusion", "B2ResNet", "GlobalAndLocal",
           "GlobalAndLocalCPS", "LegacyMultiviewSeg", "PredEndecoder",
           "SpatialConcatFusion", "SpatialMLP", "build_model",
           "build_reg_model"]
