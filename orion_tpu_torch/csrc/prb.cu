// Path-replay backpropagation: the training forward and the replay, over a
// swept table (kernels 3a/3b) or over a BVH (kernels 9a/9b).
//
// Replaces: orion_tpu/ops/pallas_prb.py::_make_fwd_ls_kernel (launched by
// build_fwd_ls_call) and ::_make_replay_kernel / replay_impl (launched by
// build_replay_call); and orion_tpu/ops/pallas_bvh_prb.py::
// _make_bvh_fwd_ls_kernel and ::_make_bvh_replay_kernel (launched by
// make_bvh_train_step), the same pair over the BVH walk of bvh_path.cu.
// Both pairs are one template each, instantiated over `Geo` and `Tree`
// (fused_common.cuh): the forward and the replay walk the same tree with
// the same code, so the replay's U cancels as it does over the table.
//
// prb_fwd_ls_kernel: the path estimator of fused_path.cu with the legacy
// NEE (the shadow sweep runs on every hit lane and carries the winner's
// attributes: light normal at the winner's u, v, emitted color = the
// winner's ke, so d/d(ke) is live) that also records each sample's
// radiance: a running sum in registers, stored to ls[(3s + c) * n_pix + pix]
// when the lane leaves sample s (the TPU kernel one-hot-adds every sample
// plane each bounce; the other planes only gain zeros, so the floats agree).
//
// prb_replay_kernel: re-traces the same PCG4D paths with regeneration,
// starts U at L_s when a sample begins, subtracts each bounce's
// contribution (computed by the same code as the forward, op by op, see
// fused_common.cuh) and accumulates the closed-form adjoints
//   d kd[m] += w T A + w U / kd - share inv_p (w . U),  d ke[m] += w T em,
//   d ke[em] += w T kd sum(scale)
// into a block-shared [6, 128] accumulator by shared-memory atomics (a
// lane that misses scatters nothing), plus per-thread NEE emitted-color
// sums. Each block then adds its accumulator to the [6, 128] output (which
// the wrapper zeroes) with one global atomic per nonzero entry. Per-lane
// terms are float; the sums are double, because a grey material's gradient
// is a small difference of large terms (w U / kd against the even split of
// the max(kd) term) summed over millions of lanes. Atomic sums make the
// order of additions, and so the last bits, vary from run to run.
//
// What bounds them on the H100: operations, as the render kernel (39 FP32
// operations per Woop test), with more tests: the legacy NEE sweeps every
// hit lane for every light sample, where the fast form skips lanes whose
// geometry term is <= 0. The bytes are the table (L1/L2 resident), 12 bytes
// of image, and the ls planes: 3 * samples floats per pixel written by the
// forward and read by the replay (100 MB at 1920x1080, 4 spp), against
// 3.35 TB/s about 0.03 ms each way. The replay adds atomics on shared
// memory, which serialise when a warp's lanes hit one material.
//
// Over a tree add 12 FP32 operations per slab test; the tree and its
// bundled [B_pad, 32] table stay in L2 as for kernel 8.
//
// Design: one thread per pixel lane with the whole path state in registers,
// lanes leave the loop on their own; resident tables staged in shared
// memory, larger ones swept chunk by chunk with the same AABB cull in both
// kernels (value-identical between them, so the replay sees the forward's
// paths); trees walked by fused_common.cuh's walk_tree.

#include "fused_common.cuh"

namespace {

using namespace orion;

template <class G>
__global__ void __launch_bounds__(kThreads)
prb_fwd_ls_kernel(const PathParamsT<G> p) {
  extern __shared__ float sgeo[];  // resident tables only: [T_pad, 16]
  stage_geo<kCols>(p.geo, sgeo);   // nothing for a tree
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= p.W * p.H) return;
  path_lane<true, kForwardLs>(p, sgeo, pix, nullptr, nullptr);
}

template <class G>
__global__ void __launch_bounds__(kThreads)
prb_replay_kernel(const PathParamsT<G> p, double* grad, int em_mesh) {
  extern __shared__ float sgeo[];  // resident tables only: [T_pad, 16]
  __shared__ double sacc[6 * kMLanes];
  __shared__ double sek[3];
  for (int k = threadIdx.x; k < 6 * kMLanes; k += blockDim.x) sacc[k] = 0.0;
  if (threadIdx.x < 3) sek[threadIdx.x] = 0.0;
  __syncthreads();
  stage_geo<kCols>(p.geo, sgeo);

  float ek[3] = {0.f, 0.f, 0.f};
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix < p.W * p.H) path_lane<true, kReplay>(p, sgeo, pix, sacc, ek);

  // the block's NEE emitted-color sums: warp shuffle, then shared atomics
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

PathParams make_params(const float* cam, const float* tab, const float* clo,
                       const float* chi, const float* em, float* out,
                       float* ls, const float* w, int T_pad, int n_chunks,
                       int n_em, int W, int H, int samples, int max_depth,
                       int light_samples, int seed) {
  return PathParams{cam, Geo{tab, clo, chi, T_pad, n_chunks}, em, out, ls,
                    w, n_em, W, H, samples, max_depth, light_samples,
                    static_cast<uint32_t>(seed)};
}

}  // namespace

extern "C" int prb_fwd_ls_launch(const float* cam, const float* tab,
                                 const float* clo, const float* chi,
                                 const float* em, float* out, float* ls,
                                 int T_pad, int n_chunks, int n_em, int W,
                                 int H, int samples, int max_depth,
                                 int light_samples, int seed, void* stream) {
  const PathParams p = make_params(cam, tab, clo, chi, em, out, ls, nullptr,
                                   T_pad, n_chunks, n_em, W, H, samples,
                                   max_depth, light_samples, seed);
  const int n_pix = W * H;
  const size_t smem = p.geo.resident() ? sizeof(float) * T_pad * kGeo : 0;
  if (n_pix > 0) {
    prb_fwd_ls_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int prb_replay_launch(const float* cam, const float* tab,
                                 const float* clo, const float* chi,
                                 const float* em, const float* w,
                                 const float* ls, double* grad, int T_pad,
                                 int n_chunks, int n_em, int W, int H,
                                 int samples, int max_depth,
                                 int light_samples, int seed, int em_mesh,
                                 void* stream) {
  const PathParams p = make_params(cam, tab, clo, chi, em, nullptr,
                                   const_cast<float*>(ls), w, T_pad,
                                   n_chunks, n_em, W, H, samples, max_depth,
                                   light_samples, seed);
  const int n_pix = W * H;
  const size_t smem = p.geo.resident() ? sizeof(float) * T_pad * kGeo : 0;
  if (n_pix > 0) {
    prb_replay_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p, grad,
                                                              em_mesh);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// over a BVH (kernels 9a/9b)
// ---------------------------------------------------------------------------

namespace {

using TreePath = PathParamsT<Tree>;

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

extern "C" int bvh_prb_fwd_ls_launch(const float* cam, const float* nodes,
                                     const float* tab, const float* em,
                                     float* out, float* ls, int M,
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
    prb_fwd_ls_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_prb_replay_launch(const float* cam, const float* nodes,
                                     const float* tab, const float* em,
                                     const float* w, const float* ls,
                                     double* grad, int M, int leaf_width,
                                     int copies, int n_em, int W, int H,
                                     int samples, int max_depth,
                                     int light_samples, int seed,
                                     int em_mesh, void* stream) {
  const TreePath p = make_tree_params(cam, nodes, tab, em, nullptr,
                                      const_cast<float*>(ls), w, M,
                                      leaf_width, copies, n_em, W, H,
                                      samples, max_depth, light_samples,
                                      seed);
  const int n_pix = W * H;
  if (n_pix > 0) {
    prb_replay_kernel<<<(n_pix + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, grad,
                                                              em_mesh);
  }
  return static_cast<int>(cudaGetLastError());
}
