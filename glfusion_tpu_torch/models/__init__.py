"""Models of the port: the GL-Fusion flagship and its building blocks."""

from glfusion_tpu_torch.models.glfusion import GlobalAndLocal

__all__ = ["GlobalAndLocal"]
