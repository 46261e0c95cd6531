// Regenerative path-tracing megakernel over a BVH: the whole path tracer in
// one launch, for scenes past the brute sweep's triangle gate.
//
// Replaces: orion_tpu/ops/pallas_bvh_path.py::_make_kernel (launched by
// build_bvh_path_call): the estimator of pallas_fused.py's _make_regen_body
// with the legacy NEE (the shadow sweep carries the winner's normal and
// emitted color), its brute sweep replaced by a skip-pointer walk over a
// bundled [B_pad, 32] table.
//
// Per pixel, in sample order: the persistent lane loop of render_lane.cuh
// (`render_lanes<true>`) instantiated over a `Tree` geometry, so the PCG4D
// streams, the NEE, the Russian roulette and the bounce are the fused and
// training kernels' own code. Every nearest hit (the path vertex; each NEE
// sample's shadow segment, capped at NEE_T_CAP) is one walk
// (fused_common.cuh's walk_tree, shared by every tree kernel): slab test
// per node against the ray's live segment [0, t_best), Woop test of a hit
// leaf's rows, min t with ties to the smallest row and only strict
// improvement across leaves. Output [n_lanes, 3] = radiance / spp of the
// pixels [pix_base, pix_base + n_lanes): a tile renders the same pixels as
// the whole image.
//
// The TPU kernel walks one pointer per block of 256 lanes and votes the
// block's direction octant; a thread here walks alone and, when the node
// array holds 8 per-octant flattenings, starts at its own ray's octant.
//
// What bounds it on the H100: operations and latency. A slab test is 12
// FP32 operations on a 32-byte node row, a Woop test 39 on the first 52
// bytes of a 128-byte table row (chip_smoke.py's SLAB_TEST_FLOPS and
// WOOP_TEST_FLOPS); nodes and table stay in L2 (a 35k-triangle scene at
// leaf width 2: about 0.9 MB of 4-ary collapsed nodes, 4.6 MB of rows), the
// output is 12 bytes per pixel. In practice a warp runs its slowest lane's
// walk and waits on L2 for nodes and winner rows: resident warps, not
// operations, set the pace (PERF.md).
//
// Design (measured step by step in PERF.md). One thread per pixel
// left a third of the lane slots idle behind each warp's slowest pixel:
// the persistent lanes of render_lane.cuh take pixels from a global
// counter instead, and the kernel is built for 6 resident blocks an SM
// (kPathBlocks, 80 registers) where the compiler took 96 (5 blocks). The
// walk stays the skip-pointer one: a 4-wide tree cut a walk from 41 node
// steps to 9.4 but lost to it by 3% under the same lane loop (a step cost
// ~4x the instructions, and a warp runs its slowest lane's walk).

#include "render_lane.cuh"

namespace {

using namespace orion;

using TreeParams = PathParamsT<Tree>;

__global__ void __launch_bounds__(kThreads, kPathBlocks)
bvh_path_kernel(const TreeParams p, int n_lanes, int* next) {
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  render_lanes<true>(p, nullptr, n_lanes, next ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
}

}  // namespace

// Occupancy and resources of the kernel as built (render_lane.cuh's
// kernel_info; no shared memory).
extern "C" int bvh_path_info(int* out) {
  return kernel_info(bvh_path_kernel, 0, out);
}

// `next`: one int32, zero, the persistent lanes' pixel counter
extern "C" int bvh_path_launch(const float* cam, const float* nodes,
                               const float* tab, const float* em, float* out,
                               int* next, int M, int leaf_width, int copies,
                               int n_em, int W, int H, int samples,
                               int max_depth, int light_samples, int seed,
                               int pix_base, int n_lanes, void* stream) {
  TreeParams p{cam,
               Tree{reinterpret_cast<const float4*>(nodes), tab, M,
                    leaf_width, copies},
               em, out, nullptr, nullptr, n_em, W, H, samples, max_depth,
               light_samples, static_cast<uint32_t>(seed), pix_base};
  if (n_lanes > 0) {
    bvh_path_kernel<<<persistent_blocks(bvh_path_kernel, 0, n_lanes),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, n_lanes, next);
  }
  return static_cast<int>(cudaGetLastError());
}
