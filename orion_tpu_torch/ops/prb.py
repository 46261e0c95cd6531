"""Path-replay backpropagation (PRB): material gradients of the path tracer.

Replaces `orion_tpu.ops.pallas_prb`: two kernels, both CUDA C++ in
`csrc/prb.cu`, each with a plain PyTorch version and a launch counter.

- the training forward (`_make_fwd_ls_kernel`): the render kernel's
  regenerative estimator with the legacy NEE (the shadow sweep carries the
  winner's attributes, so the emitted color is a live table value) that
  also records each sample's radiance L_s per pixel;
- the replay (`_make_replay_kernel` / `replay_impl`): re-traces the same
  PCG4D paths (the draws are pure functions of pixel, sample, depth and
  site), starts each sample's remaining radiance U at L_s, subtracts each
  bounce's contribution as it meets it again, and accumulates the
  closed-form adjoints per material (w = dLoss/d(lane radiance)):

    d kd[m, c] += w_c T_c A_c + w_c U_c / kd_c
                  - share_c inv_p sum_c' w_c' U_c'   (p = max_c kd_c)
    d ke[m, c] += w_c T_c em_scale                    (depth-0 emission)
    d ke[em, c] += w_c T_c kd_c sum(scale)            (NEE emitted color)

The RR probability p = max(kd) splits the gradient of a tie evenly over
the tied channels (share = 1/#ties), the TPU kernel's rule. The grey
walls of a Cornell box tie three ways; reverse-mode AD of JAX's nested
jnp.maximum splits that tie 1/4, 1/4, 1/2 instead. Both are valid
subgradients; the port's AD oracle (`fused_path.fused_reference_render`)
takes torch.amax, whose backward splits evenly like the kernel.

The wrappers take the plain versions only for CPU tensors; for CUDA
tensors they launch the kernels or raise. `FusedPathPRB` is the
autograd.Function over the pair: its forward launches the training
forward and keeps L_s, its backward launches the replay.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from orion_tpu_torch.ops.cuda_build import CudaKernel, stream_ptr
from orion_tpu_torch.ops.fused_path import (
    _C_MESH, EM_STRIDE, MAX_SAMPLES, _regen_steps, check_tables, fused_args,
    fused_fwd_ls_plain, fused_path_supported, pack_fused_tri_table_torch)
from orion_tpu_torch.scene import Scene

M_LANES = 128     # materials the replay's accumulator holds

_P = ctypes.c_void_p
_I = ctypes.c_int
FWD_KERNEL = CudaKernel("prb", "prb_fwd_ls_launch",
                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _P])
REPLAY_KERNEL = CudaKernel("prb", "prb_replay_launch",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P])


def fused_train_supported(scene: Scene, samples: int = 1) -> bool:
    """Gate: fused-path scene, <= M_LANES materials, <= MAX_SAMPLES spp and
    ONE emissive mesh (the NEE emitted-color adjoint goes to one row)."""
    return (fused_path_supported(scene) and scene.num_meshes <= M_LANES
            and samples <= MAX_SAMPLES and scene.num_emissive == 1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def prb_replay_plain(tab, clo, chi, em, cam, seed: int, w, ls, W: int,
                     H: int, samples: int, max_depth: int,
                     light_samples: int, stats: dict | None = None):
    """The replay batched over all lanes: [6, M_LANES] gradient rows
    (0-2: d kd, 3-5: d ke, per material column).

    w: [W*H, 3] per-lane adjoint of the summed sample radiance (the image
    cotangent / samples); ls: [W*H, 3*samples] from the training forward.
    A lane that misses has no material and scatters nothing. Per-lane
    terms are float32 and their sums float64, as in the kernel.
    """
    del clo, chi
    dev = tab.device
    n = W * H
    S = samples
    with torch.no_grad():
        zero = torch.zeros((n,), dtype=torch.float32, device=dev)
        # L_{samp, c}, zero once the lane is past its last sample
        l_pad = torch.cat([ls.reshape(n, 3 * S),
                           torch.zeros((n, 3), dtype=ls.dtype, device=dev)],
                          dim=1).reshape(n, S + 1, 3)
        lane = torch.arange(n, device=dev)

        def l_of(samp):
            return l_pad[lane, torch.clamp(samp, max=S)]    # [n, 3]

        w3 = [w[:, c] for c in range(3)]
        acc = torch.zeros((6, M_LANES), dtype=torch.float64, device=dev)
        ek = [zero, zero, zero]
        L0 = l_of(torch.zeros((n,), dtype=torch.int64, device=dev))
        U = [L0[:, c] for c in range(3)]
        for st in _regen_steps(tab, em, cam, seed, W, H, samples, max_depth,
                               light_samples, legacy=True, stats=stats):
            T, kd, A = st["T"], st["kd"], st["A"]
            U = [U[c] - st["contrib"][c] for c in range(3)]
            hit = st["hit"]
            ties = [(kd[c] == st["p"]).to(torch.float32) for c in range(3)]
            tie_n = ties[0] + ties[1] + ties[2]
            wU = w3[0] * U[0] + w3[1] * U[1] + w3[2] * U[2]
            amax_term = -st["inv_p"] * wU / torch.clamp(tie_n, min=1.0)
            mat = st["mat"]
            for c in range(3):
                g_kd = (w3[c] * T[c] * A[c]
                        + torch.where(kd[c] > 0.0,
                                      w3[c] * U[c]
                                      / torch.clamp(kd[c], min=1e-30), zero)
                        + ties[c] * amax_term)
                g_ke = w3[c] * T[c] * st["em_scale"]
                acc[c].index_add_(0, mat,
                                  torch.where(hit, g_kd, zero).double())
                acc[3 + c].index_add_(0, mat,
                                      torch.where(hit, g_ke, zero).double())
                ek[c] = ek[c] + torch.where(
                    hit, w3[c] * T[c] * kd[c] * st["sum_scale"], zero)
            Ln = l_of(st["n_samp"])
            U = [torch.where(st["cont"], U[c], Ln[:, c]) for c in range(3)]
        em_mesh = int(em[0, 0])
        for c in range(3):
            acc[3 + c, em_mesh] += ek[c].double().sum()
    return acc.to(torch.float32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_common(name, tab, clo, chi, em, cam, extra=()):
    check_tables(name, tab, clo, chi, cam, 32,
                 (("em", em, (em.shape[0], EM_STRIDE)),) + tuple(extra))
    if em.shape[0] != 1:
        raise ValueError(f"{name}: {em.shape[0]} emitters, the training "
                         "kernels take exactly one")


def _seed32(seed: int) -> int:
    return (int(seed) + 2**31) % 2**32 - 2**31       # as int32 bits


def fused_fwd_ls(tab, clo, chi, em, cam, seed: int, W: int, H: int,
                 samples: int, max_depth: int, light_samples: int):
    """(img [W*H, 3], ls [W*H, 3*samples]): the training-forward kernel for
    CUDA tensors, the plain version for CPU tensors. On the card `ls` is a
    view of a [3*samples, W*H] buffer (the kernel's plane layout)."""
    if tab.device.type == "cpu":
        return fused_fwd_ls_plain(tab, clo, chi, em, cam, seed, W, H,
                                  samples, max_depth, light_samples)
    if tab.device.type != "cuda":
        raise ValueError(f"fused_fwd_ls: unsupported device {tab.device}")
    _check_common("fused_fwd_ls", tab, clo, chi, em, cam)
    if not 1 <= samples <= MAX_SAMPLES:
        raise ValueError(f"fused_fwd_ls: {samples} samples, need 1.."
                         f"{MAX_SAMPLES}")
    n = W * H
    img = torch.empty((n, 3), dtype=torch.float32, device=tab.device)
    planes = torch.empty((3 * samples, n), dtype=torch.float32,
                         device=tab.device)
    FWD_KERNEL.launch(cam.data_ptr(), tab.data_ptr(), clo.data_ptr(),
                      chi.data_ptr(), em.data_ptr(), img.data_ptr(),
                      planes.data_ptr(), tab.shape[0], clo.shape[0],
                      em.shape[0], W, H, samples, max_depth, light_samples,
                      _seed32(seed), stream_ptr(tab.device))
    return img, planes.t()


def _emitter_column(name, tab, em) -> int:
    """The emitter's material; ValueError unless it and every mesh id of the
    table index one of the replay's M_LANES accumulator columns."""
    ids = torch.cat([tab[:, _C_MESH], em[:1, 0]])
    lo, hi, em_mesh = (int(v) for v in
                       torch.stack([ids.min(), ids.max(), ids[-1]]).tolist())
    if lo < 0 or hi >= M_LANES:
        raise ValueError(f"{name}: material ids {lo}..{hi} outside the "
                         f"{M_LANES} accumulator columns")
    return em_mesh


def prb_replay(tab, clo, chi, em, cam, seed: int, w, ls, W: int, H: int,
               samples: int, max_depth: int, light_samples: int):
    """[6, M_LANES] material gradient rows: the replay kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if tab.device.type == "cpu":
        _emitter_column("prb_replay", tab, em)
        return prb_replay_plain(tab, clo, chi, em, cam, seed, w, ls, W, H,
                                samples, max_depth, light_samples)
    if tab.device.type != "cuda":
        raise ValueError(f"prb_replay: unsupported device {tab.device}")
    n = W * H
    planes = ls.t().contiguous()          # a view when ls came from the kernel
    _check_common("prb_replay", tab, clo, chi, em, cam,
                  (("w", w, (n, 3)), ("ls", planes, (3 * samples, n))))
    em_mesh = _emitter_column("prb_replay", tab, em)
    out = torch.zeros((6, M_LANES), dtype=torch.float64, device=tab.device)
    REPLAY_KERNEL.launch(cam.data_ptr(), tab.data_ptr(), clo.data_ptr(),
                         chi.data_ptr(), em.data_ptr(), w.data_ptr(),
                         planes.data_ptr(), out.data_ptr(), tab.shape[0],
                         clo.shape[0], em.shape[0], W, H, samples,
                         max_depth, light_samples, _seed32(seed), em_mesh,
                         stream_ptr(tab.device))
    return out.to(torch.float32)


# ---------------------------------------------------------------------------
# autograd and training steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PRBPlan:
    """What the pair of kernels needs besides the material tables: the
    device tables of the scene's geometry (built once) and the sizes."""

    scene: Scene
    base: torch.Tensor          # the host pack of the table, on the device
    clo: torch.Tensor
    chi: torch.Tensor
    em: torch.Tensor
    cam: torch.Tensor
    W: int
    H: int
    samples: int
    max_depth: int
    light_samples: int

    @classmethod
    def build(cls, scene: Scene, camera, *, samples: int, max_depth: int,
              light_samples: int):
        base, clo, chi, em, cam = fused_args(scene, camera)
        return cls(scene=scene, base=base, clo=clo, chi=chi, em=em, cam=cam,
                   W=camera.xres, H=camera.yres, samples=samples,
                   max_depth=max_depth, light_samples=light_samples)

    def table(self, mat_diffuse=None, mat_emissive=None):
        return pack_fused_tri_table_torch(self.scene, mat_diffuse,
                                          mat_emissive, base=self.base)

    def forward(self, tab, seed):
        return fused_fwd_ls(tab, self.clo, self.chi, self.em, self.cam, seed,
                            self.W, self.H, self.samples, self.max_depth,
                            self.light_samples)

    def replay(self, tab, seed, w, ls):
        return prb_replay(tab, self.clo, self.chi, self.em, self.cam, seed,
                          w, ls, self.W, self.H, self.samples,
                          self.max_depth, self.light_samples)


class FusedPathPRB(torch.autograd.Function):
    """img = training-forward(mat_diffuse, mat_emissive) as [H, W, 3]; its
    backward is the replay kernel (closed-form adjoints, no residuals)."""

    @staticmethod
    def forward(ctx, mat_diffuse, mat_emissive, plan: PRBPlan, seed: int):
        with torch.no_grad():
            tab = plan.table(mat_diffuse, mat_emissive)
            img, ls = plan.forward(tab, seed)
        ctx.plan, ctx.seed, ctx.M = plan, seed, mat_diffuse.shape[0]
        ctx.save_for_backward(tab, ls)
        return img.reshape(plan.H, plan.W, 3)

    @staticmethod
    def backward(ctx, grad_img):
        tab, ls = ctx.saved_tensors
        plan = ctx.plan
        # lanes sum their samples; the image is the mean
        w = (grad_img.reshape(-1, 3).to(torch.float32)
             / float(plan.samples)).contiguous()
        out = plan.replay(tab, ctx.seed, w, ls)
        M = ctx.M
        return out[0:3, :M].t(), out[3:6, :M].t(), None, None


def _gate(scene, samples):
    if not fused_train_supported(scene, samples):
        raise ValueError("scene outside the fused-train gate "
                         "(textures / emitters / size / materials / spp)")


def make_fused_grad_fn(scene: Scene, camera, *, samples: int,
                       max_depth: int, light_samples: int = 2):
    """`grads(seed, dloss_dimg, tab=None) -> {"mat_diffuse": [M, 3],
    "mat_emissive": [M, 3]}`: the gradients of a loss whose cotangent with
    respect to the [H, W, 3] image is `dloss_dimg`, from one training
    forward (for L_s) and one replay. `seed` is the int32 PCG seed."""
    _gate(scene, samples)
    plan = PRBPlan.build(scene, camera, samples=samples, max_depth=max_depth,
                         light_samples=light_samples)
    base = plan.table().detach()
    M = int(scene.num_meshes)

    def grads(seed: int, dloss_dimg, tab=None):
        tab = base if tab is None else tab
        with torch.no_grad():
            _, ls = plan.forward(tab, seed)
            w = (torch.as_tensor(dloss_dimg, dtype=torch.float32,
                                 device=tab.device).reshape(-1, 3)
                 / float(samples)).contiguous()
            out = plan.replay(tab, seed, w, ls)
        return {"mat_diffuse": out[0:3, :M].t(),
                "mat_emissive": out[3:6, :M].t()}

    return grads


def make_fused_train_step(scene: Scene, camera, target, *, samples: int,
                          max_depth: int, light_samples: int = 2,
                          dynamic_params: bool = False):
    """MSE train step against `target` [H, W, 3]: one training-forward
    launch and one replay launch, through FusedPathPRB.

    dynamic_params=False: `step(seed) -> (loss, grads)` over the scene's
    own materials, grads for mat_diffuse and mat_emissive.
    dynamic_params=True: `step(params, seed) -> (loss, grads)` where params
    is a dict over {mat_diffuse, mat_emissive}; the table is rebuilt from
    them each call and grads holds the same keys. `seed` is the int32 PCG
    seed. The cotangent is 2 (img - target) / (H W 3), as MSE's.
    """
    _gate(scene, samples)
    plan = PRBPlan.build(scene, camera, samples=samples, max_depth=max_depth,
                         light_samples=light_samples)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=scene.device)

    def _loss_and_grads(params, seed, wanted):
        kd = params.get("mat_diffuse", scene.mat_diffuse)
        ke = params.get("mat_emissive", scene.mat_emissive)
        kd = kd.detach().to(torch.float32).requires_grad_(True)
        ke = ke.detach().to(torch.float32).requires_grad_(True)
        img = FusedPathPRB.apply(kd, ke, plan, int(seed))
        diff = img - target
        loss = torch.mean(diff * diff)
        g_kd, g_ke = torch.autograd.grad(loss, (kd, ke))
        g = {"mat_diffuse": g_kd, "mat_emissive": g_ke}
        return loss.detach(), {k: g[k] for k in wanted}

    if not dynamic_params:
        def step(seed: int):
            return _loss_and_grads({}, seed, ("mat_diffuse", "mat_emissive"))

        return step

    def step_params(params, seed: int):
        bad = set(params) - {"mat_diffuse", "mat_emissive"}
        if bad:
            raise ValueError(f"PRB differentiates material tables only; "
                             f"got {sorted(bad)}")
        return _loss_and_grads(params, seed, tuple(params))

    return step_params
