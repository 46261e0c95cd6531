// Skip-pointer BVH walk: nearest hit, or any hit, of rays against a
// flattened tree.
//
// Replaces: orion_tpu/ops/pallas_bvh.py::_make_kernel(M, W, any_hit)
// (launched by _traverse_pallas_impl), the wavefront renderer's intersect
// for scenes past the brute sweep's gate, and its occlusion variant for
// Whitted shadow rays.
//
// Contract. Nodes are [M, 8] rows (lo xyz, hi xyz, skip, start; the last
// two are int32 bits), node i's subtree is [i + 1, skip[i]), a leaf has
// start >= 0 and owns the `leaf_width` rows [start, start + leaf_width) of
// the [B_pad, 16] Woop table (columns 0..12; padding rows always miss).
// Per ray: ptr = 0; at each node the slab test (tmax >= tmin, so flat boxes
// hit; tmax > 0; tmin < t_best); on a hit leaf the Woop test of its rows,
// winner min t with ties to the smallest row, replacing the best only when
// strictly smaller; ptr = hit && !leaf ? ptr + 1 : skip[ptr]. Nearest: (t,
// row) of the winner, or (+inf, -1). Any hit (kAnyHit): the ray leaves the
// loop at its first hit and reports (1.0, that row). Dead rays
// (alive == 0) leave at once with (+inf, -1). The Python wrapper maps rows
// to scene triangle ids.
//
// The TPU kernel walks one pointer per block of rays and enters a subtree
// if any lane hits its box. A thread here walks alone, which gives the same
// winners: a lane whose own slab test fails cannot improve inside that box.
//
// What bounds it on the H100: operations and latency, not bytes. A slab
// test is 12 FP32 operations (6 subtracts, 6 multiplies; the 10 min/max and
// the compares are not counted, as the Woop test's compares are not;
// chip_smoke.py's SLAB_TEST_FLOPS) on one 32-byte node row, a Woop test 39
// on a 64-byte row, and both tables stay in L2 (a 35k-triangle scene at
// leaf width 2 is about 1.2 MB of nodes and 2.3 MB of rows). Each step
// depends on the one before it (the pointer), so a warp's time is its
// longest lane's chain of dependent loads; incoherent rays diverge.
//
// Design: one thread per ray, its state (origin, direction, inverse
// direction, best t, best row, pointer) in registers. The walk is
// fused_common.cuh's walk_tree, the one the megakernels' tree walks use;
// a node row is read as two float4 through the read-only cache, a Woop row
// here as four. The Woop test is fused_common.cuh's woop_t_rn, written with
// explicit round-to-nearest multiplies and adds (as brute_intersect.cu),
// and the slab test has no multiply-add to contract, so
// (t, row) equal the plain PyTorch walk's bit for bit.

#include "fused_common.cuh"

namespace {

using orion::kBig;
using orion::kThreads;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_intersect_kernel(const float* __restrict__ orig,
                     const float* __restrict__ dirs,
                     const uint8_t* __restrict__ alive,
                     const float4* __restrict__ nodes,
                     const float4* __restrict__ tri, int M, int W, int N,
                     float* __restrict__ t_out, int* __restrict__ row_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float t_best = kBig;
  int row_best = -1;
  if (alive[i] != 0) {
    const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
    const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
    orion::walk_tree<kAnyHit>(
        nodes, 0, M, ox, oy, oz, dx, dy, dz, t_best, row_best,
        [&](int start, float& tb, int& rb) {
          for (int k = start; k < start + W; ++k) {
            const float t =
                orion::woop_t_rn<true>(tri + 4 * k, ox, oy, oz, dx, dy, dz);
            if (t < tb) {  // strict: smallest row, earliest leaf win a tie
              tb = t;
              rb = k;
            }
          }
        });
  }
  row_out[i] = row_best;
  t_out[i] = row_best < 0 ? __int_as_float(0x7f800000)  // +inf
                          : (kAnyHit ? 1.0f : t_best);
}

}  // namespace

extern "C" int bvh_intersect_launch(const float* orig, const float* dirs,
                                    const uint8_t* alive, const float* nodes,
                                    const float* tri, int M, int W, int N,
                                    int any_hit, float* t_out, int* row_out,
                                    void* stream) {
  if (N > 0) {
    const int blocks = (N + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* n4 = reinterpret_cast<const float4*>(nodes);
    const float4* t4 = reinterpret_cast<const float4*>(tri);
    if (any_hit)
      bvh_intersect_kernel<true><<<blocks, kThreads, 0, s>>>(
          orig, dirs, alive, n4, t4, M, W, N, t_out, row_out);
    else
      bvh_intersect_kernel<false><<<blocks, kThreads, 0, s>>>(
          orig, dirs, alive, n4, t4, M, W, N, t_out, row_out);
  }
  return static_cast<int>(cudaGetLastError());
}
