"""Multi-device rendering and training over `torch.distributed`: ray
sharding (sharding.py, shardmap_render.py), the megakernels on pixel
tiles (fused_shard.py), primitive sharding (primitive_sharding.py),
sample-parallel rendering and the process group (distributed.py)."""

from orion_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    make_train_step,
    render_sharded,
    scene_params,
)
from orion_tpu_torch.parallel.shardmap_render import (  # noqa: F401
    make_train_step_shardmap,
    render_shardmap,
)
from orion_tpu_torch.parallel.primitive_sharding import (  # noqa: F401
    make_mesh_2d,
    make_tp_intersect,
    render_tp,
)
