// Path-replay backpropagation: the training forward and the replay, over a
// swept table (kernels 3a/3b) or over a BVH (kernels 9a/9b).
//
// Replaces: orion_tpu/ops/pallas_prb.py::_make_fwd_ls_kernel (launched by
// build_fwd_ls_call) and ::_make_replay_kernel / replay_impl (launched by
// build_replay_call); and orion_tpu/ops/pallas_bvh_prb.py::
// _make_bvh_fwd_ls_kernel and ::_make_bvh_replay_kernel (launched by
// make_bvh_train_step), the same pair over the BVH walk of bvh_path.cu.
// All four kernels are render_lane.cuh's persistent lane loop
// (`render_lanes`): 3a/3b over `RGeo` (kernel 1's staged float4 sweep),
// 9a/9b over `Tree`. The forward and the replay of a pair walk the same
// geometry with the same code, so the replay's U cancels.
//
// The forward (prb_fwd_ls_kernel, bvh_prb_fwd_kernel; the lane loop's
// kForwardLs mode): the path estimator of fused_path.cu with the legacy
// NEE (the shadow sweep runs on every hit lane and carries the winner's
// attributes: light normal at the winner's u, v, emitted color = the
// winner's ke, so d/d(ke) is live) that also records each sample's
// radiance: a running sum in registers, stored to
// ls[(3s + c) * n_lanes + lane] (a 64-bit offset) when the lane leaves
// sample s (the TPU kernel one-hot-adds every sample plane each bounce; the
// other planes only gain zeros, so the floats agree). A launch covers the
// pixels pix_base + [0, n_lanes): a tile's planes and image rows are its
// own, and equal the whole image's rows (the draws hash global pixel ids);
// the tree pair (9a, 9b) launches the whole image.
//
// The replay (prb_replay_kernel, bvh_prb_replay_kernel; kReplay): re-traces
// the same PCG4D paths with regeneration, starts U at L_s when a sample
// begins, subtracts each bounce's contribution (computed by the same code
// as the forward, op by op, see fused_common.cuh) and accumulates the
// closed-form adjoints
//   d kd[m] += w T A + w U / kd - share inv_p (w . U),  d ke[m] += w T em,
//   d ke[em] += w T kd sum(scale)
// into a block-shared [6, 128] accumulator (a lane that misses scatters
// nothing), plus per-thread NEE emitted-color sums. Each block then adds
// its accumulator to the [6, 128] output (which the wrapper zeroes) with
// one global atomic per nonzero entry. Per-lane terms are float; the sums
// are double, because a grey material's gradient is a small difference of
// large terms (w U / kd against the even split of the max(kd) term) summed
// over millions of lanes. Atomic sums make the order of additions, and so
// the last bits, vary from run to run.
//
// What bounds them on the H100: operations, as the render kernel (39 FP32
// operations per Woop test), with more tests: the legacy NEE sweeps every
// hit lane for every light sample, where the fast form skips lanes whose
// geometry term is <= 0. The bytes are the table (L1/L2 resident), 12 bytes
// of image, and the ls planes: 3 * samples floats per pixel written by the
// forward and read by the replay (100 MB at 1920x1080, 4 spp), against
// 3.35 TB/s about 0.03 ms each way. Over a tree add 12 FP32 operations per
// slab test; the tree and its bundled [B_pad, 32] table stay in L2 as for
// kernel 8, whose walk they share, and latency, not operations, sets the
// pace.
//
// Design (measured on the H100: PERF.md). One thread a pixel left a warp's
// lanes idle behind its slowest pixel (loop SIMT 0.61 at 4 spp over a
// table and over a tree), the compiler took 72-116 registers, and each
// lane's shared double atomics (a compare-and-swap loop) serialised on a
// warp's common material. All four kernels run persistent lanes (a thread
// takes the next pixel from a global counter, zeroed by the wrapper),
// each pair built for its own count of resident blocks; the replay sums
// each hit vertex's six terms over the warp's lanes on one material
// (`add_adjoint`) before one shared atomic; the bounce takes `sincospif`.
// Over a table every sweep of a vertex (the nearest and the legacy NEE's
// shadow sweeps) is RGeo's: float4 rows staged once per block, tested
// without a division, only the real rows; the NEE's two shadow rays of a
// vertex share one pass over the rows (`nee_pairs`).

#include "render_lane.cuh"

namespace {

using namespace orion;

// Resident blocks an SM that each pair is built for (__launch_bounds__),
// measured on the H100 (PERF.md) by tools/path_probe.py, which sweeps
// them in rewritten copies of this file. The tree pair (9a/9b): 10, which
// caps a thread at 48 registers; against 5 to 12, each block more up to
// 10 ran faster, spills and all (the walk waits on L2), 12 slower. The
// table pair (3a/3b): 6, 80 registers; against 6 to 12 its kernels ran
// fastest at 6-7 (its sweeps read shared memory, and spills cost more
// than more warps gain).
constexpr int kTableBlocks = 6;
constexpr int kTreeBlocks = 10;

// The block's part of the replay's output, once its lanes are done: the
// threads' NEE emitted-color sums `ek` (warp shuffle, then shared atomics
// into `sek`) join the emitter's column of the accumulator `sacc`, and
// each nonzero entry is added to the [6, kMLanes] output `grad` by one
// global atomic.
__device__ __forceinline__ void replay_epilogue(double* sacc, double* sek,
                                                const double ek[3],
                                                double* grad, int em_mesh) {
  __syncwarp();
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    double v = ek[ch];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(sek + ch, v);
  }
  __syncthreads();
  if (threadIdx.x < 3) sacc[(3 + threadIdx.x) * kMLanes + em_mesh] +=
      sek[threadIdx.x];
  __syncthreads();
  for (int k = threadIdx.x; k < 6 * kMLanes; k += blockDim.x) {
    if (sacc[k] != 0.0) atomicAdd(grad + k, sacc[k]);
  }
}

// ---------------------------------------------------------------------------
// over a triangle table (kernels 3a/3b)
// ---------------------------------------------------------------------------

using TablePath = PathParamsT<RGeo>;

__global__ void __launch_bounds__(kThreads, kTableBlocks)
prb_fwd_ls_kernel(const TablePath p, int n_lanes, int* next) {
  extern __shared__ float4 srows[];  // resident tables only: 1 + 4 T_pad
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  stage_rows(p.geo, srows);
  render_lanes<true, kForwardLs>(p, reinterpret_cast<const float*>(srows),
                                 n_lanes, next, nullptr,
                                 nullptr ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
}

__global__ void __launch_bounds__(kThreads, kTableBlocks)
prb_replay_kernel(const TablePath p, int n_lanes, int* next, double* grad,
                  int em_mesh) {
  extern __shared__ float4 srows[];  // resident tables only: 1 + 4 T_pad
  __shared__ double sacc[6 * kMLanes];
  __shared__ double sek[3];
  for (int k = threadIdx.x; k < 6 * kMLanes; k += blockDim.x) sacc[k] = 0.0;
  if (threadIdx.x < 3) sek[threadIdx.x] = 0.0;
  __syncthreads();
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  stage_rows(p.geo, srows);
  double ek[3] = {0.0, 0.0, 0.0};
  render_lanes<true, kReplay>(p, reinterpret_cast<const float*>(srows),
                              n_lanes, next, sacc, ek ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
  replay_epilogue(sacc, sek, ek, grad, em_mesh);
}

TablePath table_params(const float* cam, const float* tab, const float* clo,
                       const float* chi, const float* em, float* out,
                       float* ls, const float* w, int T_pad, int n_chunks,
                       int n_em, int W, int H, int samples, int max_depth,
                       int light_samples, int seed, int pix_base) {
  return TablePath{cam, RGeo{{tab, clo, chi, T_pad, n_chunks}}, em, out, ls,
                   w, n_em, W, H, samples, max_depth, light_samples,
                   static_cast<uint32_t>(seed), pix_base};
}

}  // namespace

// out = render_lane.cuh's kernel_info of 3a (which 0) or 3b (which 1) at
// the shared memory of a resident table of T_pad rows
extern "C" int prb_info(int which, int T_pad, int* out) {
  const size_t smem = staged_bytes(RGeo{{nullptr, nullptr, nullptr, T_pad, 1}});
  return which == 0 ? kernel_info(prb_fwd_ls_kernel, smem, out)
                    : kernel_info(prb_replay_kernel, smem, out);
}

// `next`: one int32, zero, the persistent lanes' pixel counter
extern "C" int prb_fwd_ls_launch(const float* cam, const float* tab,
                                 const float* clo, const float* chi,
                                 const float* em, float* out, float* ls,
                                 int* next, int T_pad, int n_chunks,
                                 int n_em, int W, int H, int samples,
                                 int max_depth, int light_samples, int seed,
                                 int pix_base, int n_lanes, void* stream) {
  const TablePath p = table_params(cam, tab, clo, chi, em, out, ls, nullptr,
                                   T_pad, n_chunks, n_em, W, H, samples,
                                   max_depth, light_samples, seed, pix_base);
  const size_t smem = staged_bytes(p.geo);
  if (n_lanes > 0) {
    prb_fwd_ls_kernel<<<persistent_blocks(prb_fwd_ls_kernel, smem, n_lanes),
                        kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        p, n_lanes, next);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int prb_replay_launch(const float* cam, const float* tab,
                                 const float* clo, const float* chi,
                                 const float* em, const float* w,
                                 const float* ls, double* grad, int* next,
                                 int T_pad, int n_chunks, int n_em, int W,
                                 int H, int samples, int max_depth,
                                 int light_samples, int seed, int em_mesh,
                                 int pix_base, int n_lanes, void* stream) {
  const TablePath p = table_params(cam, tab, clo, chi, em, nullptr,
                                   const_cast<float*>(ls), w, T_pad,
                                   n_chunks, n_em, W, H, samples, max_depth,
                                   light_samples, seed, pix_base);
  const size_t smem = staged_bytes(p.geo);
  if (n_lanes > 0) {
    prb_replay_kernel<<<persistent_blocks(prb_replay_kernel, smem, n_lanes),
                        kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        p, n_lanes, next, grad, em_mesh);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// over a BVH (kernels 9a/9b): render_lane.cuh's persistent lane loop
// ---------------------------------------------------------------------------

namespace {

using TreePath = PathParamsT<Tree>;

__global__ void __launch_bounds__(kThreads, kTreeBlocks)
bvh_prb_fwd_kernel(const TreePath p, int* next) {
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  render_lanes<true, kForwardLs>(p, nullptr, p.W * p.H, next, nullptr,
                                 nullptr ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
}

__global__ void __launch_bounds__(kThreads, kTreeBlocks)
bvh_prb_replay_kernel(const TreePath p, int* next, double* grad,
                      int em_mesh) {
  __shared__ double sacc[6 * kMLanes];
  __shared__ double sek[3];
  for (int k = threadIdx.x; k < 6 * kMLanes; k += blockDim.x) sacc[k] = 0.0;
  if (threadIdx.x < 3) sek[threadIdx.x] = 0.0;
  __syncthreads();
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  double ek[3] = {0.0, 0.0, 0.0};
  render_lanes<true, kReplay>(p, nullptr, p.W * p.H, next, sacc,
                              ek ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
  replay_epilogue(sacc, sek, ek, grad, em_mesh);
}

TreePath make_tree_params(const float* cam, const float* nodes,
                          const float* tab, const float* em, float* out,
                          float* ls, const float* w, int M, int leaf_width,
                          int copies, int n_em, int W, int H, int samples,
                          int max_depth, int light_samples, int seed) {
  return TreePath{cam,
                  Tree{reinterpret_cast<const float4*>(nodes), tab, M,
                       leaf_width, copies},
                  em, out, ls, w, n_em, W, H, samples, max_depth,
                  light_samples, static_cast<uint32_t>(seed)};
}

}  // namespace

// out = render_lane.cuh's kernel_info of 9a (which 0) or 9b (which 1)
extern "C" int bvh_prb_info(int which, int* out) {
  return which == 0 ? kernel_info(bvh_prb_fwd_kernel, 0, out)
                    : kernel_info(bvh_prb_replay_kernel, 0, out);
}

// `next`: one int32, zero, the persistent lanes' pixel counter
extern "C" int bvh_prb_fwd_ls_launch(const float* cam, const float* nodes,
                                     const float* tab, const float* em,
                                     float* out, float* ls, int* next, int M,
                                     int leaf_width, int copies, int n_em,
                                     int W, int H, int samples,
                                     int max_depth, int light_samples,
                                     int seed, void* stream) {
  const TreePath p = make_tree_params(cam, nodes, tab, em, out, ls, nullptr,
                                      M, leaf_width, copies, n_em, W, H,
                                      samples, max_depth, light_samples,
                                      seed);
  const int n_pix = W * H;
  if (n_pix > 0) {
    bvh_prb_fwd_kernel<<<persistent_blocks(bvh_prb_fwd_kernel, 0, n_pix),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, next);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_prb_replay_launch(const float* cam, const float* nodes,
                                     const float* tab, const float* em,
                                     const float* w, const float* ls,
                                     double* grad, int* next, int M,
                                     int leaf_width, int copies, int n_em,
                                     int W, int H, int samples,
                                     int max_depth, int light_samples,
                                     int seed, int em_mesh, void* stream) {
  const TreePath p = make_tree_params(cam, nodes, tab, em, nullptr,
                                      const_cast<float*>(ls), w, M,
                                      leaf_width, copies, n_em, W, H,
                                      samples, max_depth, light_samples,
                                      seed);
  const int n_pix = W * H;
  if (n_pix > 0) {
    bvh_prb_replay_kernel<<<persistent_blocks(bvh_prb_replay_kernel, 0,
                                              n_pix),
                            kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, next, grad, em_mesh);
  }
  return static_cast<int>(cudaGetLastError());
}
