"""orion_tpu_torch — the PyTorch/CUDA port of orion_tpu.

A second package beside `orion_tpu` (the JAX reference, unchanged): the
same scene model, camera, wavefront renderer and CLI, written with torch
tensors, with the TPU's Pallas kernels replaced by CUDA C++ kernels for
NVIDIA Hopper (`csrc/`, built with nvcc at first use). It imports neither
jax nor orion_tpu.

Ported: .rtc/.obj/.mtl/image I/O, the SoA Scene, the camera
(`camera_from_rtc`, `make_camera`), the Woop intersection and the
Möller-Trumbore oracle, shading (with normal mapping), the wavefront
renderer (path and Whitted modes, with every single-device option:
`normal_maps`, `remat`, `fold_samples`, `sort_bounces`), the engine and
the CLI; the path and Whitted megakernels (ops/fused_path.py,
ops/whitted.py) and the brute-force sweep (ops/brute_intersect.py);
training: the path-replay kernels (ops/prb.py), the closed-form Whitted
trainer (ops/prb_whitted.py) and `fit` (optim.py); big scenes: the BVH
build (accel/bvh.py, native.py), the batched walk (ops/bvh_traverse.py),
the BVH walk kernel (ops/bvh_intersect.py), the BVH path megakernel
(ops/bvh_path.py), wavefront sorting (ops/reorder.py), the regenerative
wavefront (regen.py), the sorted-wavefront bounce pipeline with
per-bounce texturing (ops/bounce.py) and its closed-form trainer
(ops/bounce_prb.py), the BVH Whitted kernels (ops/bvh_whitted.py), the
BVH path-replay trainer (ops/bvh_prb.py), the refitted tree
(accel/refit.py), the binned sweep (ops/binned.py) and the
grouped-pointer walk (ops/bvh_g8.py); host services: resumable
accumulation (io/checkpoint.py) and profiling (profiling.py); ray
sharding over torch.distributed (parallel/: the sharded wavefronts and
train steps, the megakernels on pixel tiles; regen and checkpoint on
ranks; the CLI's --shard), sample-parallel rendering
(`parallel.distributed.render_multihost` over `render(sample_offset=)`),
primitive sharding (parallel/primitive_sharding.py) and treelets
(engine.py); the viewer (viewer.py, flying the megakernels through their
`camera_override`) and the examples (examples/torch_*.py).
Entry points run on `cuda` unless the caller asks for `cpu`.
"""

__version__ = "0.1.0"

from orion_tpu_torch.io.rtc import RTCData, parse_rtc, write_rtc  # noqa: F401
from orion_tpu_torch.scene import Scene, load_scene          # noqa: F401
from orion_tpu_torch.camera import (                         # noqa: F401
    Camera,
    camera_from_rtc,
    make_camera,
)
from orion_tpu_torch.engine import (                         # noqa: F401
    PreparedScene,
    prepare,
    render_prepared,
    render_report,
)
from orion_tpu_torch.render import render, trace_wavefront   # noqa: F401
from orion_tpu_torch.regen import (                          # noqa: F401
    render_regen,
    render_regen_shardmap,
)
from orion_tpu_torch.io.checkpoint import render_accumulate  # noqa: F401
from orion_tpu_torch.validate import SceneValidationError    # noqa: F401
from orion_tpu_torch.optim import FitResult, fit             # noqa: F401
