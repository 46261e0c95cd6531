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
// visible iff the nearest hit with t < NEE_T_CAP lies on the sampled mesh;
// Russian roulette on max(kd); cosine-weighted bounce; on termination the
// path regenerates as the pixel's next sample. Output: [n_pix, 3] =
// radiance / spp.
//
// What bounds it on the H100: operations. Every sweep tests each ray
// against every real table row, chunk-culled for big tables, and every path
// vertex runs 1 + n_emitters * light_samples sweeps. A test is 39 FP32
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
// built for 6
// resident blocks an SM (kPathBlocks, 80 registers). Tables up to one
// chunk (512 rows) are staged once per resident block into shared memory:
// a row's first 16 floats (the 13 Woop floats) as four float4, read by
// broadcast as four 128-bit loads instead of 13 scalar ones, and only the
// rows up to the last real one (a padding row has |n|^2 = 0), which the
// staging counts. Larger tables are read through the read-only cache in
// 512-row chunks, each chunk's AABB slab-tested against the lane's live
// segment [0, t_best) and skipped when the lane cannot improve. The row
// test (`test_row`) works in the numerator domain: with D = |dw| and
// n = t D, u D, v D sign-corrected by one xor each, it needs no division
// per row, and a row replaces the best (n_b, D_b) iff n D_b < n_b D; rows
// are swept in order, two an iteration, so ties keep the smaller row. The
// winner's t = n_b / D_b is -ow / dw of that row, bit for bit as the
// Woop test computes it. Winner attributes are read from the winner's
// table row only, instead of the TPU kernel's select-reduce or one-hot
// MXU gather.
//
// Random numbers are the TPU kernel's: stateless PCG4D hashes of (pixel,
// sample, depth, site) in wrapping uint32 arithmetic with logical shifts, so
// the image is a pure function of the seed.
//
// The lane loop lives in render_lane.cuh, shared with kernel 8 (bvh_path.cu);
// the NEE in fused_common.cuh, shared with the training kernels (prb.cu).

#include "render_lane.cuh"

namespace orion {

// Kernel 1's geometry: `Geo`'s table and chunk AABBs under their own
// sweep (`nearest` below); a resident table is staged into shared memory
// by `stage_rows`.
struct RGeo : Geo {};

// Shared-memory image of a resident table: one float4 header (x: the rows
// to sweep, as int bits), then per row its first 16 floats as four float4.
__device__ __forceinline__ void stage_rows(const RGeo& g, float4* s) {
  if (!g.resident()) return;
  int* n_rows = reinterpret_cast<int*>(s);
  if (threadIdx.x == 0) *n_rows = 0;
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(g.tab);
  for (int k = threadIdx.x; k < g.T_pad * 4; k += blockDim.x) {
    const int row = k >> 2, q = k & 3;
    const float4 v = __ldg(src + row * (kCols / 4) + q);
    s[1 + k] = v;
    if (q == 3 && v.x > 0.0f) atomicMax(n_rows, row + 1);  // |n|^2 > 0
  }
  __syncthreads();
}

// One row's test in the numerator domain (see the header note); a = w0-3,
// b = w4-7, c = w8-11, e.x = w12. Replaces (bn, bd, brow) when row k is
// hit at t in [0, bn / bd).
__device__ __forceinline__ void test_row(const float4 a, const float4 b,
                                         const float4 c, const float4 e,
                                         const Ray& r, int k, float& bn,
                                         float& bd, int& brow) {
  const float ou = a.x * r.ox + a.y * r.oy + a.z * r.oz + c.y;
  const float ov = a.w * r.ox + b.x * r.oy + b.y * r.oz + c.z;
  const float ow = b.z * r.ox + b.w * r.oy + c.x * r.oz + c.w;
  const float du = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float dv = a.w * r.dx + b.x * r.dy + b.y * r.dz;
  const float dw = b.z * r.dx + b.w * r.dy + c.x * r.dz;
  const unsigned s = __float_as_uint(dw) & 0x80000000u;
  const float n = __uint_as_float(__float_as_uint(ow) ^ s ^ 0x80000000u);
  const float un = __uint_as_float(__float_as_uint(ou * dw - ow * du) ^ s);
  const float vn = __uint_as_float(__float_as_uint(ov * dw - ow * dv) ^ s);
  const float d = fabsf(dw);
  const bool ok = (d * e.x > kMtEps) && (un >= 0.0f) && (vn >= 0.0f) &&
                  (un + vn <= d) && (n >= 0.0f) && (n * bd < bn * d);
  bn = ok ? n : bn;
  bd = ok ? d : bd;
  brow = ok ? k : brow;
}

// nearest row with t < cap (ties -> min row), or -1
template <int kStride>
__device__ __forceinline__ int nearest(const RGeo& g, const float* sgeo,
                                       const Ray& r, float cap, float& t) {
  float bn = cap, bd = 1.0f;
  int row = -1;
  if (g.resident()) {
    const float4* rows = reinterpret_cast<const float4*>(sgeo) + 1;
    const int n = *reinterpret_cast<const int*>(sgeo);
#pragma unroll 2
    for (int k = 0; k < n; ++k)
      test_row(rows[4 * k], rows[4 * k + 1], rows[4 * k + 2],
               rows[4 * k + 3], r, k, bn, bd, row);
  } else {
    const float4* src = reinterpret_cast<const float4*>(g.tab);
    for (int c = 0; c < g.n_chunks; ++c) {
      if (!box_reachable(g, c, r, row < 0 ? cap : bn / bd)) continue;
      for (int k = c * kChunk; k < (c + 1) * kChunk; ++k) {
        const float4* w = src + k * (kCols / 4);
        test_row(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3), r, k,
                 bn, bd, row);
      }
    }
  }
  t = row < 0 ? cap : bn / bd;
  return row;
}

}  // namespace orion

namespace {

using namespace orion;

__global__ void __launch_bounds__(kThreads, kPathBlocks)
fused_path_kernel(const PathParamsT<RGeo> p, int* next) {
  extern __shared__ float4 srows[];  // resident tables only: 1 + 4 T_pad
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  stage_rows(p.geo, srows);
  render_lanes<false, kRender>(p, reinterpret_cast<const float*>(srows),
                               p.W * p.H, next, nullptr,
                               nullptr ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
}

size_t smem_bytes(const RGeo& g) {
  return g.resident() ? sizeof(float4) * (1 + 4 * g.T_pad) : 0;
}

}  // namespace

// Occupancy and resources of the kernel as built (render_lane.cuh's
// kernel_info) at the shared memory of a resident table of T_pad rows.
extern "C" int fused_path_info(int T_pad, int* out) {
  return kernel_info(fused_path_kernel,
                     smem_bytes(RGeo{{nullptr, nullptr, nullptr, T_pad, 1}}),
                     out);
}

// `next`: one int32, zero, the persistent lanes' pixel counter
extern "C" int fused_path_launch(const float* cam, const float* tab,
                                 const float* clo, const float* chi,
                                 const float* em, float* out, int* next,
                                 int T_pad, int n_chunks, int n_em, int W,
                                 int H, int samples, int max_depth,
                                 int light_samples, int seed, void* stream) {
  PathParamsT<RGeo> p{cam, RGeo{{tab, clo, chi, T_pad, n_chunks}}, em, out,
                      nullptr, nullptr, n_em, W, H, samples, max_depth,
                      light_samples, static_cast<uint32_t>(seed)};
  const int n_pix = W * H;
  const size_t smem = smem_bytes(p.geo);
  if (n_pix > 0) {
    fused_path_kernel<<<persistent_blocks(fused_path_kernel, smem, n_pix),
                        kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        p, next);
  }
  return static_cast<int>(cudaGetLastError());
}
