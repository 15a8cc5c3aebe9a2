"""GL-Fusion in PyTorch for one NVIDIA H100: the port of ``glfusion_tpu``.

Module names mirror ``glfusion_tpu`` so each counterpart is easy to find.
The package imports torch, numpy and the standard library only; its CUDA
kernels (``csrc/``) are built with nvcc at first use.
"""
