// Regenerative path-tracing megakernel: the whole path tracer in one launch.
//
// Replaces: orion_tpu/ops/pallas_fused.py::_make_kernel (launched by
// build_fused_call), the estimator of _make_regen_body with fast_shadow=True.
//
// Per pixel, in sample order:
// PCG4D-jittered primary ray (one jitter per sample, shared by all pixels);
// Woop nearest-hit sweep over the [T_pad, 32] table (min t, ties -> min row);
// depth-0 emission Ke * meshArea * cos; next-event estimation over every
// emissive mesh (<= 8 meshes of <= 8 triangles), `light_samples` draws each,
// visible iff the nearest hit with t < NEE_T_CAP lies on the sampled mesh
// (two draws of a mesh share one sweep of the rows, render_lane.cuh's
// `nee_fast_pairs`);
// Russian roulette on max(kd); cosine-weighted bounce; on termination the
// path regenerates as the pixel's next sample. Output: [n_lanes, 3] =
// radiance / spp of the launch's tile of pixels.
//
// What bounds it on the H100: operations. Every sweep tests each ray
// against every real table row, chunk-culled for big tables, and every path
// vertex tests each row against 1 + n_emitters * light_samples rays: the
// vertex's nearest hit, then per emitter ceil(light_samples / 2) shadow
// sweeps, each of which loads a row once and tests it against the two
// rays of a pair (one origin, so one origin transform). A test is 39 FP32
// operations (chip_smoke.py's WOOP_TEST_FLOPS): origin transform
// 3 x (3 mul + 3 add), direction transform 3 x (3 mul + 2 add), one divide,
// u/v 2 x (mul + add), the eps product. The bytes are the 128-byte table
// rows, which stay in L1/L2 (the Cornell table is 5 KB, the 16,384-row cap
// 2 MB), and 12 bytes of output per pixel.
//
// Design (after measuring the one-thread-a-pixel kernel: PERF.md).
// Persistent lanes (render_lane.cuh): a thread that finishes a pixel's 16th
// sample takes the next pixel from a global counter, where one thread per
// pixel left 23% of the lane slots idle behind each warp's slowest pixel;
// built for 6 resident blocks an SM (kPathBlocks, 80 registers). The
// table is render_lane.cuh's `RGeo`: staged float4 rows up to one chunk,
// larger tables chunk by chunk under an AABB cull, a division-free row
// test, ties to the smaller row (kernels 3a and 3b sweep it too). Winner
// attributes are read from the winner's table row only, instead of the
// TPU kernel's select-reduce or one-hot MXU gather.
//
// Random numbers are the TPU kernel's: stateless PCG4D hashes of (pixel,
// sample, depth, site) in wrapping uint32 arithmetic with logical shifts, so
// the image is a pure function of the seed.
//
// The lane loop and the table's sweep live in render_lane.cuh, shared with
// kernel 8 (bvh_path.cu) and the training kernels (prb.cu), and so does
// this kernel's NEE (`nee_fast_pairs`, the one NEE in fast-shadow form).

#include "render_lane.cuh"

namespace {

using namespace orion;

__global__ void __launch_bounds__(kThreads, kPathBlocks)
fused_path_kernel(const PathParamsT<RGeo> p, int n_lanes, int* next) {
  extern __shared__ float4 srows[];  // resident tables only: 1 + 4 T_pad
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  stage_rows(p.geo, srows);
  render_lanes<false, kRender>(p, reinterpret_cast<const float*>(srows),
                               n_lanes, next, nullptr,
                               nullptr ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
}

}  // namespace

// Occupancy and resources of the kernel as built (render_lane.cuh's
// kernel_info) at the shared memory of a resident table of T_pad rows.
extern "C" int fused_path_info(int T_pad, int* out) {
  return kernel_info(fused_path_kernel,
                     staged_bytes(RGeo{{nullptr, nullptr, nullptr, T_pad, 1}}),
                     out);
}

// Renders the pixels pix_base + [0, n_lanes) into out [n_lanes, 3] (a
// tile's rows are the whole image's: the draws hash global pixel ids).
// `next`: one int32, zero, the persistent lanes' pixel counter
extern "C" int fused_path_launch(const float* cam, const float* tab,
                                 const float* clo, const float* chi,
                                 const float* em, float* out, int* next,
                                 int T_pad, int n_chunks, int n_em, int W,
                                 int H, int samples, int max_depth,
                                 int light_samples, int seed, int pix_base,
                                 int n_lanes, void* stream) {
  PathParamsT<RGeo> p{cam, RGeo{{tab, clo, chi, T_pad, n_chunks}}, em, out,
                      nullptr, nullptr, n_em, W, H, samples, max_depth,
                      light_samples, static_cast<uint32_t>(seed), pix_base};
  const size_t smem = staged_bytes(p.geo);
  if (n_lanes > 0) {
    fused_path_kernel<<<persistent_blocks(fused_path_kernel, smem, n_lanes),
                        kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        p, n_lanes, next);
  }
  return static_cast<int>(cudaGetLastError());
}
