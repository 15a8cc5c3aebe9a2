"""Models of the port: the GL-Fusion flagship, its CPS twin and their
building blocks."""

from glfusion_tpu_torch.models.glfusion import (GlobalAndLocal,
                                                GlobalAndLocalCPS,
                                                build_model)

__all__ = ["GlobalAndLocal", "GlobalAndLocalCPS", "build_model"]
