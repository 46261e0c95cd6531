"""Path-replay backpropagation over a BVH: material gradients of the path
tracer for scenes past the brute sweep's gate.

Replaces `orion_tpu.ops.pallas_bvh_prb` (the Pallas
`_make_bvh_fwd_ls_kernel` and `_make_bvh_replay_kernel`): the training
forward and the replay of ops/prb.py (legacy NEE; per-sample radiance
recorded by the forward; closed-form adjoints summed in double by the
replay) with every sweep replaced by the skip-pointer walk of the BVH
path kernel (ops/bvh_path.py) over a bundled [B_pad, 32] table. The
kernels (9a, 9b) are `csrc/prb.cu`'s two instantiations of the BVH path
kernel's persistent lane loop (`csrc/render_lane.cuh`): each launch is
handed a zeroed int32 pixel counter, as ops/bvh_path.py hands kernel 8
one. The plain versions are `fused_path.fused_fwd_ls_plain` and
`prb.prb_replay_plain` with the walk of ops/bvh_traverse.py. The forward
and the replay take the same `nodes` and `tab` tensors and walk them with
the same code, so the replay's remaining radiance cancels to zero.

Training moves materials only: the tree is built once from the geometry
and each step regathers the table's kd / ke columns
(`bvh_path.tab_updater_from_bvh`); `FusedPathPRB` carries the pair as an
autograd.Function over a `BVHPRBPlan`.

The wrappers take the plain versions only for CPU tensors; for CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from orion_tpu_torch.accel.bvh import BVH, SAH
from orion_tpu_torch.ops.bvh_intersect import NODE_COLS
from orion_tpu_torch.ops.bvh_path import (GPU_LEAF_WIDTH, TreeData,
                                          bvh_path_device_data,
                                          bvh_path_supported,
                                          tab_updater_from_bvh)
from orion_tpu_torch.ops.cuda_build import (CudaKernel, check_inputs,
                                            stream_ptr)
from orion_tpu_torch.ops.fused_path import (EM_STRIDE, MAX_SAMPLES,
                                            camera_vec, fused_fwd_ls_plain,
                                            pack_emitters)
from orion_tpu_torch.ops.prb import (M_LANES, _emitter_column, _seed32,
                                     prb_replay_plain, train_step_over)
from orion_tpu_torch.scene import Scene

_COLS = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
FWD_KERNEL = CudaKernel("prb", "bvh_prb_fwd_ls_launch",
                        [_P] * 7 + [_I] * 10 + [_P])
REPLAY_KERNEL = CudaKernel("prb", "bvh_prb_replay_launch",
                           [_P] * 8 + [_I] * 11 + [_P])


def bvh_train_supported(scene: Scene, samples: int = 1) -> bool:
    """Gate: bvh-path scene (untextured, small emitters), <= M_LANES
    materials, <= MAX_SAMPLES spp and ONE emissive mesh (the NEE
    emitted-color adjoint goes to one row)."""
    return (bvh_path_supported(scene) and scene.num_meshes <= M_LANES
            and samples <= MAX_SAMPLES and scene.num_emissive == 1)


def make_bvh_tab_updater(scene: Scene, *, strategy: str = SAH,
                         order_signs=(1.0, 1.0, 1.0),
                         leaf_width: int = GPU_LEAF_WIDTH, octants: int = 1,
                         builder: str = "auto", bvh: BVH | None = None):
    """(nodes, num_nodes, update): the tree's nodes on the scene's device
    (built here, or `bvh` built with leaf_size == leaf_width) and
    `tab_updater_from_bvh`'s update(mat_diffuse=None, mat_emissive=None)
    -> [B_pad, 32] table with those material columns."""
    nodes, _, total, bvh = bvh_path_device_data(
        scene, strategy=strategy, order_signs=order_signs, with_bvh=True,
        octants=octants, leaf_width=leaf_width, builder=builder, bvh=bvh)
    return nodes, total, tab_updater_from_bvh(bvh, scene)


def _check(name, nodes, tab, em, cam, copies: int, samples: int, extra=()):
    check_inputs(name, tab.device,
                 (("nodes", nodes, (nodes.shape[0], NODE_COLS),
                   torch.float32),
                  ("tab", tab, (tab.shape[0], _COLS), torch.float32),
                  ("em", em, (em.shape[0], EM_STRIDE), torch.float32),
                  ("cam", cam, (12,), torch.float32))
                 + tuple((w, x, s, torch.float32) for w, x, s in extra))
    if em.shape[0] != 1:
        raise ValueError(f"{name}: {em.shape[0]} emitters, the training "
                         "kernels take exactly one")
    if copies not in (1, 8) or nodes.shape[0] % copies:
        raise ValueError(f"{name}: {copies} copies over {nodes.shape[0]} "
                         f"nodes")
    if not 1 <= samples <= MAX_SAMPLES:
        raise ValueError(f"{name}: {samples} samples, need 1..{MAX_SAMPLES}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bvh_fwd_ls_plain(nodes, tab, em, cam, seed: int, W: int, H: int,
                     samples: int, max_depth: int, light_samples: int, *,
                     leaf_width: int, copies: int = 1,
                     stats: dict | None = None):
    """Kernel 9a's function: (img [W*H, 3], ls [W*H, 3*samples]) of the
    training forward over the tree. stats["tests"] / stats["box_tests"]
    count the walks' Woop tests of real rows and visited nodes."""
    tree = TreeData.from_nodes(nodes, copies, leaf_width)
    return fused_fwd_ls_plain(tab, None, None, em, cam, seed, W, H, samples,
                              max_depth, light_samples, stats=stats,
                              tree=tree)


def bvh_prb_replay_plain(nodes, tab, em, cam, seed: int, w, ls, W: int,
                         H: int, samples: int, max_depth: int,
                         light_samples: int, *, leaf_width: int,
                         copies: int = 1, stats: dict | None = None):
    """Kernel 9b's function: [6, M_LANES] gradient rows (d kd, d ke) of
    the replay over the tree."""
    tree = TreeData.from_nodes(nodes, copies, leaf_width)
    return prb_replay_plain(tab, None, None, em, cam, seed, w, ls, W, H,
                            samples, max_depth, light_samples, stats=stats,
                            tree=tree)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def bvh_fwd_ls(nodes, tab, em, cam, seed: int, W: int, H: int, samples: int,
               max_depth: int, light_samples: int, *, leaf_width: int,
               copies: int = 1):
    """(img [W*H, 3], ls [W*H, 3*samples]): kernel 9a for CUDA tensors, the
    plain version for CPU tensors. On the card `ls` is a view of a
    [3*samples, W*H] buffer (the kernel's plane layout)."""
    _check("bvh_fwd_ls", nodes, tab, em, cam, copies, samples)
    if tab.device.type == "cpu":
        return bvh_fwd_ls_plain(nodes, tab, em, cam, seed, W, H, samples,
                                max_depth, light_samples,
                                leaf_width=leaf_width, copies=copies)
    if tab.device.type != "cuda":
        raise ValueError(f"bvh_fwd_ls: unsupported device {tab.device}")
    n = W * H
    img = torch.empty((n, 3), dtype=torch.float32, device=tab.device)
    planes = torch.empty((3 * samples, n), dtype=torch.float32,
                         device=tab.device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=tab.device)
    FWD_KERNEL.launch(cam.data_ptr(), nodes.data_ptr(), tab.data_ptr(),
                      em.data_ptr(), img.data_ptr(), planes.data_ptr(),
                      nxt.data_ptr(), nodes.shape[0] // copies,
                      int(leaf_width), copies, em.shape[0], W, H, samples,
                      max_depth, light_samples, _seed32(seed),
                      stream_ptr(tab.device))
    return img, planes.t()


def bvh_prb_replay(nodes, tab, em, cam, seed: int, w, ls, W: int, H: int,
                   samples: int, max_depth: int, light_samples: int, *,
                   leaf_width: int, copies: int = 1):
    """[6, M_LANES] material gradient rows: kernel 9b for CUDA tensors, the
    plain version for CPU tensors. Every material id of the table and the
    emitter's must index one of the M_LANES accumulator columns."""
    n = W * H
    if tab.device.type == "cpu":
        _check("bvh_prb_replay", nodes, tab, em, cam, copies, samples,
               (("w", w, (n, 3)),))
        _emitter_column("bvh_prb_replay", tab, em)
        return bvh_prb_replay_plain(nodes, tab, em, cam, seed, w, ls, W, H,
                                    samples, max_depth, light_samples,
                                    leaf_width=leaf_width, copies=copies)
    if tab.device.type != "cuda":
        raise ValueError(f"bvh_prb_replay: unsupported device {tab.device}")
    planes = ls.t().contiguous()          # a view when ls came from 9a
    _check("bvh_prb_replay", nodes, tab, em, cam, copies, samples,
           (("w", w, (n, 3)), ("ls", planes, (3 * samples, n))))
    em_mesh = _emitter_column("bvh_prb_replay", tab, em)
    out = torch.zeros((6, M_LANES), dtype=torch.float64, device=tab.device)
    nxt = torch.zeros((1,), dtype=torch.int32, device=tab.device)
    REPLAY_KERNEL.launch(cam.data_ptr(), nodes.data_ptr(), tab.data_ptr(),
                         em.data_ptr(), w.data_ptr(), planes.data_ptr(),
                         out.data_ptr(), nxt.data_ptr(),
                         nodes.shape[0] // copies,
                         int(leaf_width), copies, em.shape[0], W, H, samples,
                         max_depth, light_samples, _seed32(seed), em_mesh,
                         stream_ptr(tab.device))
    return out.to(torch.float32)


# ---------------------------------------------------------------------------
# training step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BVHPRBPlan:
    """What kernels 9a/9b need besides the material tables: the tree's
    nodes (built once), the table updater, the emitter record, the
    camera and the sizes. The same protocol as prb.PRBPlan."""

    nodes: torch.Tensor
    update: object
    em: torch.Tensor
    cam: torch.Tensor
    W: int
    H: int
    samples: int
    max_depth: int
    light_samples: int
    leaf_width: int
    copies: int

    def table(self, mat_diffuse=None, mat_emissive=None):
        return self.update(mat_diffuse, mat_emissive)

    def forward(self, tab, seed):
        return bvh_fwd_ls(self.nodes, tab, self.em, self.cam, seed, self.W,
                          self.H, self.samples, self.max_depth,
                          self.light_samples, leaf_width=self.leaf_width,
                          copies=self.copies)

    def replay(self, tab, seed, w, ls):
        return bvh_prb_replay(self.nodes, tab, self.em, self.cam, seed, w,
                              ls, self.W, self.H, self.samples,
                              self.max_depth, self.light_samples,
                              leaf_width=self.leaf_width, copies=self.copies)


def make_bvh_train_step(scene: Scene, camera, target, *, samples: int,
                        max_depth: int, light_samples: int = 2,
                        strategy: str = SAH, order_signs=(1.0, 1.0, 1.0),
                        leaf_width: int = GPU_LEAF_WIDTH, octants: int = 1,
                        builder: str = "auto", bvh: BVH | None = None,
                        dynamic_params: bool = False):
    """MSE train step against `target` [H, W, 3] for scenes past the brute
    gate: one launch of kernel 9a (recording per-sample radiance) and one
    of kernel 9b, through prb.FusedPathPRB, on the scene's device (the
    plain versions on the CPU).

    dynamic_params=False: `step(seed) -> (loss, grads)` over the scene's
    own materials, grads for mat_diffuse and mat_emissive.
    dynamic_params=True: `step(params, seed) -> (loss, grads)` with params
    over {mat_diffuse, mat_emissive} (anything else raises ValueError); the
    table's material columns are regathered each call, the tree is not
    touched. `seed` is the int32 PCG seed; `step.plan` is the BVHPRBPlan.
    """
    if not bvh_train_supported(scene, samples):
        raise ValueError("scene outside the bvh-train gate "
                         "(textures / emitters / materials / spp)")
    nodes, _, update = make_bvh_tab_updater(
        scene, strategy=strategy, order_signs=order_signs,
        leaf_width=leaf_width, octants=octants, builder=builder, bvh=bvh)
    plan = BVHPRBPlan(
        nodes=nodes, update=update,
        em=torch.as_tensor(pack_emitters(scene), device=scene.device),
        cam=camera_vec(camera).to(scene.device), W=camera.xres,
        H=camera.yres, samples=samples, max_depth=max_depth,
        light_samples=light_samples, leaf_width=leaf_width, copies=octants)
    return train_step_over(scene, plan, target, dynamic_params)
