"""PyTorch / CUDA port of the cardiac-MRI video super-resolution framework.

A second package beside the JAX one, which stays the reference.  It keeps
the same YAML config surface and the same public array layouts; its
hand-written CUDA kernels live under ``csrc/`` and are built with ``nvcc``
for Hopper (``sm_90a``) at first use.  It covers the flagship RefineNet's
training and eval:

    python -m efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main CONFIG [--test]
"""

__version__ = "0.1.0"
