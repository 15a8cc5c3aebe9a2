"""Counterparts of the JAX package's ``experiments/``: the fused IEKD stem
(``stem_fused.py``, four CUDA kernels) and its drop-in module
(``stem_module.py``)."""
