"""orion_tpu_torch — the PyTorch/CUDA port of orion_tpu.

A second package beside `orion_tpu` (the JAX reference, unchanged): the
same scene model, camera, wavefront renderer and CLI, written with torch
tensors, with the TPU's Pallas kernels replaced by CUDA C++ kernels for
NVIDIA Hopper (`csrc/`, built with nvcc at first use). It imports neither
jax nor orion_tpu.

Ported so far: .rtc/.obj/.mtl/image I/O, the SoA Scene, the camera, the
Woop intersection, shading, the wavefront renderer (path and Whitted
modes), the path megakernel (ops/fused_path.py) and the brute-force sweep
(ops/brute_intersect.py), the Whitted megakernel (ops/whitted.py), the
engine and the CLI; training: the path-replay kernels (ops/prb.py), the
closed-form Whitted trainer (ops/prb_whitted.py) and `fit` (optim.py).
Entry points run on `cuda` unless the caller asks for `cpu`.
"""

__version__ = "0.1.0"

from orion_tpu_torch.optim import FitResult, fit  # noqa: E402,F401
