"""kronfluence_tpu_torch: the PyTorch / CUDA port of kronfluence_tpu.

Influence functions with (EK-)FAC curvature on one NVIDIA H100. Module paths
mirror the JAX package's (`factor/covariance.py` <-> `factor/covariance.py`).
The port imports torch and numpy, never jax; its hand-written Hopper kernels
live in `csrc/` and are built with nvcc at first use (`ops/kernels/`).
"""
