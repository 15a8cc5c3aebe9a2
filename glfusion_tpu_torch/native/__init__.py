"""The native NIfTI decoder (C++, ctypes) with the pure-Python reader as its
fallback: ``glfusion_tpu_torch/csrc/nifti_reader.cpp``, built by ``g++`` at
first use into ``glfusion_tpu_torch/_build/``. ``GLFUSION_NO_NATIVE=1``
switches it off; ``data.nifti.read_nifti`` routes through it."""

from glfusion_tpu_torch.native.loader import (  # noqa: F401
    build,
    build_error,
    compiler_version,
    library_path,
    native_available,
    read_nifti_batch_native,
    read_nifti_native,
)
