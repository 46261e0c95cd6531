// Regenerative path-tracing megakernel over a BVH: the whole path tracer in
// one launch, for scenes past the brute sweep's triangle gate.
//
// Replaces: orion_tpu/ops/pallas_bvh_path.py::_make_kernel (launched by
// build_bvh_path_call): the estimator of pallas_fused.py's _make_regen_body
// with the legacy NEE (the shadow sweep carries the winner's normal and
// emitted color), its brute sweep replaced by a skip-pointer walk over a
// bundled [B_pad, 32] table.
//
// Per pixel lane, until the lane's sample index reaches `samples`: the lane
// loop of fused_common.cuh (`path_lane<true, kRender>`) instantiated over a
// `Tree` geometry, so the PCG4D streams, the NEE, the Russian roulette and
// the bounce are the fused and training kernels' own code. Every nearest
// hit (the path vertex; each NEE sample's shadow segment, capped at
// NEE_T_CAP) is one walk: slab test per node against the ray's live segment
// [0, t_best), Woop test of a hit leaf's rows, min t with ties to the
// smallest row and only strict improvement across leaves. Output
// [n_lanes, 3] = radiance / spp of the lanes [pix_base, pix_base + n_lanes):
// a tile renders the same pixels as the whole image.
//
// The TPU kernel walks one pointer per block of 256 lanes and votes the
// block's direction octant; a thread here walks alone and, when the node
// array holds 8 per-octant flattenings, starts at its own ray's octant. It
// picks the winner's (u, v) and attribute columns out of the leaf plane
// during the walk; here the winner's row is read once after the walk.
//
// What bounds it on the H100: operations and latency. A slab test is 12
// FP32 operations on a 32-byte node row, a Woop test 39 on the first 52
// bytes of a 128-byte table row (chip_smoke.py's SLAB_TEST_FLOPS and
// WOOP_TEST_FLOPS); nodes and table stay in L2 (a 35k-triangle scene at
// leaf width 2: about 0.9 MB of 4-ary collapsed nodes, 4.6 MB of rows), the
// output is 12 bytes per pixel. Every step of a walk depends on the one
// before it, bounce rays of neighbouring pixels diverge, and lanes of a
// warp sit at different depths and samples, so a warp runs as long as its
// longest lane.

#include "fused_common.cuh"

namespace {

using namespace orion;

using TreeParams = PathParamsT<Tree>;

__global__ void __launch_bounds__(kThreads)
bvh_path_kernel(const TreeParams p, int n_lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int pix = p.pix_base + lane;
  if (lane >= n_lanes || pix >= p.W * p.H) return;
  path_lane<true, kRender>(p, nullptr, pix, nullptr, nullptr);
}

}  // namespace

extern "C" int bvh_path_launch(const float* cam, const float* nodes,
                               const float* tab, const float* em, float* out,
                               int M, int leaf_width, int copies, int n_em,
                               int W, int H, int samples, int max_depth,
                               int light_samples, int seed, int pix_base,
                               int n_lanes, void* stream) {
  TreeParams p{cam,
               Tree{reinterpret_cast<const float4*>(nodes), tab, M,
                    leaf_width, copies},
               em, out, nullptr, nullptr, n_em, W, H, samples, max_depth,
               light_samples, static_cast<uint32_t>(seed), pix_base};
  if (n_lanes > 0) {
    bvh_path_kernel<<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p, n_lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
