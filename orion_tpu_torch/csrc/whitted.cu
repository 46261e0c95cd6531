// The Whitted megakernel over a swept triangle table (kernel 4): persistent
// lanes, point lights.
//
// Replaces: orion_tpu/ops/pallas_whitted.py::_make_whitted_kernel (launched
// by make_fused_whitted_renderer).
//
// The lane loop is whitted_common.cuh's `whitted_lanes`, as the BVH Whitted
// kernels run it (bvh_whitted.cu): a thread renders a pixel's samples,
// writes the pixel and takes the next one from a global counter (the
// wrapper hands each launch a zeroed int32), and the grid is as many
// blocks as stay resident at kTableWhittedBlocks an SM. The geometry is
// `WGeo` (below): the nearest sweep over the [T_pad, 40] table, chunk-culled
// past one chunk, and one any-hit shadow sweep per point light that leaves
// at its first hit.
//
// What bounds it on the H100: operations. Every bounce sweeps the table
// (39 FP32 operations per Woop test) for the nearest hit and once per light
// up to the first hit; the bytes are the table (L1/L2 resident, staged in
// shared memory when it fits one chunk), 12 bytes of image per pixel and a
// few constants. Design (PERF.md; tools/path_probe.py w measures it): the
// issue slots go to the row tests (56 SASS instructions a row, a fifth of
// them the division and its checks), so a resident table is staged once a
// block as float4 rows up to its last real row, and a warp skips a row's
// division and barycentric tests where no lane can win it (from the
// transformed origin's and direction's w alone, with margins for the
// division's rounding); the test is `woop`'s, its division kept, so every
// t, and so the image, is the per-pixel kernel's bit for bit.

#include "whitted_common.cuh"

namespace orion {

// Resident blocks an SM that the kernel is built for (__launch_bounds__);
// measured on the H100 (PERF.md; tools/path_probe.py w builds copies of
// this source with other values).
constexpr int kTableWhittedBlocks = 8;

// Kernel 4's table: Geo's [T_pad, 40] rows and chunk AABBs. A table of one
// chunk is staged once a block (`stage_rows`, RGeo's layout: one float4
// header whose x holds the rows to sweep as int bits, then a row's first 16
// floats as four float4) up to its last real row (a padding row has
// |n|^2 = 0 and never hits); larger tables take Geo's chunked sweeps.
struct WGeo : Geo {};

__host__ __device__ __forceinline__ size_t staged_bytes(const WGeo& g) {
  return g.resident() ? sizeof(float4) * (1 + 4 * g.T_pad) : 0;
}

__device__ __forceinline__ void stage_rows(const WGeo& g, float4* s) {
  if (!g.resident()) return;
  int* n_rows = reinterpret_cast<int*>(s);
  if (threadIdx.x == 0) *n_rows = 0;
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(g.tab);
  for (int k = threadIdx.x; k < g.T_pad * 4; k += blockDim.x) {
    const int row = k >> 2, q = k & 3;
    const float4 v = __ldg(src + row * (kWCols / 4) + q);
    s[1 + k] = v;
    if (q == 3 && v.x > 0.0f) atomicMax(n_rows, row + 1);  // |n|^2 > 0
  }
  __syncthreads();
}

// A staged row's Woop test in two steps, written as `woop` writes it (the
// same expressions, so the same t): the transformed origin and direction
// first, then the division and the barycentric tests.
struct WSums {
  float ou, ov, ow, du, dv, dw, w12;
};

__device__ __forceinline__ WSums row_sums(const float* sgeo, int k,
                                          const Ray& r) {
  const float4* q = reinterpret_cast<const float4*>(sgeo) + 1 + 4 * k;
  const float4 a = q[0], b = q[1], c = q[2];
  const float w0 = a.x, w1 = a.y, w2 = a.z, w3 = a.w, w4 = b.x, w5 = b.y,
              w6 = b.z, w7 = b.w, w8 = c.x, w9 = c.y, w10 = c.z, w11 = c.w;
  WSums s;
  s.ou = w0 * r.ox + w1 * r.oy + w2 * r.oz + w9;
  s.ov = w3 * r.ox + w4 * r.oy + w5 * r.oz + w10;
  s.ow = w6 * r.ox + w7 * r.oy + w8 * r.oz + w11;
  s.du = w0 * r.dx + w1 * r.dy + w2 * r.dz;
  s.dv = w3 * r.dx + w4 * r.dy + w5 * r.dz;
  s.dw = w6 * r.dx + w7 * r.dy + w8 * r.dz;
  s.w12 = q[3].x;
  return s;
}

__device__ __forceinline__ float row_t(const WSums& s) {
  const float t = -s.ow / s.dw;
  const float u = s.ou + t * s.du;
  const float v = s.ov + t * s.dv;
  const bool ok = (fabsf(s.dw) * s.w12 > kMtEps) && (u >= 0.0f) &&
                  (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                  (t >= 0.0f);
  return ok ? t : kBig;
}

// Can the row give no t with 0 <= t < t_best, whatever its barycentrics?
// Decided from ow and dw alone, with margins that cover the rounding of
// t = -ow / dw (correctly rounded, so monotone in the quotient): with ow
// and dw of one sign, |ow| >= 2^-100 and |dw| <= 2^40, the quotient is at
// most -2^-140 and t < 0; with opposite signs and |ow| >= |dw| t_best
// (1 + 2^-20) (the product at least 2^-100, so both roundings stay within
// 2^-24), the quotient exceeds t_best and t >= t_best. A zero dw never
// passes the test's first condition; NaNs decide nothing.
__device__ __forceinline__ bool cannot_win(const WSums& s, float t_best) {
  const float aow = fabsf(s.ow), adw = fabsf(s.dw);
  if ((s.ow > 0.0f) == (s.dw > 0.0f))
    return aow >= 0x1p-100f && adw <= 0x1p40f;
  const float p = __fmul_rn(__fmul_rn(adw, t_best), 1.0f + 0x1p-20f);
  return p >= 0x1p-100f && aow >= p;
}

// nearest row with t < cap (ties -> min row), or -1: Geo's sweep over the
// staged rows in row order; a row no lane of the warp can win is skipped
template <int kStride>
__device__ __forceinline__ int nearest(const WGeo& g, const float* sgeo,
                                       const Ray& r, float cap, float& t) {
  if (!g.resident())
    return nearest<kStride>(static_cast<const Geo&>(g), r, cap, t);
  const int n = *reinterpret_cast<const int*>(sgeo);
  float t_best = cap;
  int row = -1;
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    const WSums s = row_sums(sgeo, k, r);
    if (__all_sync(__activemask(), cannot_win(s, t_best))) continue;
    const float tk = row_t(s);
    if (tk < t_best) {  // strict: the smallest row wins
      t_best = tk;
      row = k;
    }
  }
  t = t_best;
  return row;
}

// does the ray hit any row at any t >= 0? Leaves at the first hit; a row
// that no lane of the warp can hit at t >= 0 is skipped.
template <int kStride>
__device__ __forceinline__ bool any_hit(const WGeo& g, const float* sgeo,
                                        const Ray& r) {
  if (!g.resident())
    return any_hit<kStride>(static_cast<const Geo&>(g), r);
  const int n = *reinterpret_cast<const int*>(sgeo);
#pragma unroll 2
  for (int k = 0; k < n; ++k) {
    const WSums s = row_sums(sgeo, k, r);
    if (__all_sync(__activemask(), cannot_win(s, kBig))) continue;
    if (row_t(s) < kBig) return true;
  }
  return false;
}

}  // namespace orion

namespace {

using namespace orion;

using WhittedParams = WhittedParamsT<WGeo>;

__global__ void __launch_bounds__(kThreads, kTableWhittedBlocks)
whitted_kernel(const WhittedParams p, int n_lanes, int* next) {
  extern __shared__ float4 srows[];  // resident tables only: 1 + 4 T_pad
  ORION_PC(LaneCounters pc; pc.t_start = pc.t_done = clock64();)
  stage_rows(p.geo, srows);
  whitted_lanes<WGeo, kWCols>(p, reinterpret_cast<const float*>(srows),
                              n_lanes, next, NoTexel() ORION_PC(, pc));
  ORION_PC(pc_flush(pc); __syncwarp(); pc_exit(pc.t_done);)
}

}  // namespace

// Occupancy and resources of the kernel as built (render_lane.cuh's
// kernel_info) at the shared memory of a resident table of T_pad rows.
extern "C" int whitted_info(int T_pad, int* out) {
  return kernel_info(whitted_kernel,
                     staged_bytes(WGeo{{nullptr, nullptr, nullptr, T_pad, 1}}),
                     out);
}

// The grid: as many blocks as stay resident, or, once whitted_set_grid gave
// it a count > 0, that many (the tests' check that the image is the same
// for any grid).
static int g_grid = 0;

extern "C" void whitted_set_grid(int blocks) { g_grid = blocks; }

// Renders the pixels pix_base + [0, n_lanes) into out [n_lanes, 3].
// `next`: one int32, zero, the persistent lanes' pixel counter.
extern "C" int whitted_launch(const float* cam, const float* tab,
                              const float* clo, const float* chi,
                              const float* lights, float* out, int T_pad,
                              int n_chunks, int n_lights, int W, int H,
                              int samples, int max_depth, int with_emissive,
                              int seed, int pix_base, int n_lanes, int* next,
                              void* stream) {
  const WhittedParams p{cam, WGeo{{tab, clo, chi, T_pad, n_chunks}}, lights,
                        out, n_lights, W, H, samples, max_depth,
                        with_emissive, static_cast<uint32_t>(seed),
                        pix_base};
  const size_t smem = staged_bytes(p.geo);
  if (n_lanes > 0) {
    const int blocks = g_grid > 0
                           ? g_grid
                           : persistent_blocks(whitted_kernel, smem, n_lanes);
    whitted_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(p, n_lanes, next);
  }
  return static_cast<int>(cudaGetLastError());
}
