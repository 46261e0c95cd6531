// Grouped-pointer BVH walk (G8): nearest hit, or any hit, of rays against
// a flattened tree of 128-row leaves, one node pointer per group of lanes.
//
// Replaces: orion_tpu/ops/pallas_bvh_g8.py::_make_kernel(M, any_hit)
// (launched by _traverse_g8_impl), the JAX package's grouped-pointer
// redesign of the block-uniform walk, kept there as a measured negative
// result and reached by name (make_bvh_intersect_g8).
//
// Contract: kernel 5's (bvh_intersect.cu). Nodes [M, 8] (lo xyz, hi xyz,
// skip, start as int32 bits), leaves of 128 rows of the [B_pad, 16] Woop
// table. Nearest: (t, row) of the winner (min t, ties to the smallest row
// within a leaf, the earlier leaf across leaves), or (+inf, -1); any hit:
// (1.0, a hit row) or (+inf, -1); a dead lane (alive == 0) reports a miss.
//
// Scheduling, the only thing that differs from kernel 5: a warp of 32
// lanes shares ONE node pointer and walks the union of its lanes' paths
// (the TPU kernel gives each 128-lane group of its 1,024-ray block one
// pointer). At a node each live lane slab-tests its own segment [0,
// t_best); the warp descends when any lane passes (__any_sync) and
// otherwise jumps to the node's skip. At a leaf the warp stages the
// leaf's 128 rows (8 KB) into shared memory and every lane tests all of
// them, replacing its best only on a strictly smaller t, so a lane that
// did not need the leaf cannot change its answer. Any hit: a lane settles
// on its first leaf with a hit (t_best = -kBig, which no box passes), and
// the warp leaves the tree once every lane is settled or dead
// (__all_sync). The Woop test is woop_t_rn (explicit round-to-nearest),
// as kernel 5's.
//
// What bounds it on the H100: operations and latency, as kernel 5; the
// union walk trades divergence (a warp of kernel 5 waits for its longest
// lane) for extra node and leaf visits of the lanes that did not need
// them, and every leaf visit costs 128 Woop tests a lane where kernel 5 at
// the engine's leaf width 2 tests 2.

#include "fused_common.cuh"

namespace {

using orion::kBig;
using orion::kThreads;

constexpr int kLeaf = 128;                 // rows per leaf
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_g8_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
              const uint8_t* __restrict__ alive,
              const float4* __restrict__ nodes, const float4* __restrict__ tri,
              int M, int N, float* __restrict__ t_out,
              int* __restrict__ row_out) {
  __shared__ float4 leaf_rows[kWarps][kLeaf * 4];
  float4* rows = leaf_rows[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < N && alive[i] != 0;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (i < N) {
    ox = orig[3 * i]; oy = orig[3 * i + 1]; oz = orig[3 * i + 2];
    dx = dirs[3 * i]; dy = dirs[3 * i + 1]; dz = dirs[3 * i + 2];
  }
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  // a dead lane (and a settled any-hit lane) carries -kBig: no box passes
  float t_best = live ? kBig : -kBig;
  int row_best = -1;
  int ptr = 0;   // warp-uniform
  while (ptr < M) {
    const float4 n0 = __ldg(nodes + 2 * ptr);      // lo.xyz, hi.x
    const float4 n1 = __ldg(nodes + 2 * ptr + 1);  // hi.yz, skip, start
    const float tx0 = (n0.x - ox) * ix, tx1 = (n0.w - ox) * ix;
    const float ty0 = (n0.y - oy) * iy, ty1 = (n1.x - oy) * iy;
    const float tz0 = (n0.z - oz) * iz, tz1 = (n1.y - oz) * iz;
    const float tmin = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
    const float tmax = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                             fmaxf(tz0, tz1));
    const bool pass = (tmax >= tmin) && (tmax > 0.0f) && (tmin < t_best);
    const bool any = __any_sync(kAll, pass);
    const int start = __float_as_int(n1.w);
    if (any && start >= 0) {
      __syncwarp();   // the previous leaf's rows have been read
      const float4* src = tri + 4 * start;
      for (int k = lane; k < kLeaf * 4; k += 32) rows[k] = __ldg(src + k);
      __syncwarp();
      float tb = t_best;
      int rb = -1;
      for (int k = 0; k < kLeaf; ++k) {
        const float t =
            orion::woop_t_rn<false>(rows + 4 * k, ox, oy, oz, dx, dy, dz);
        if (t < tb) {   // strict: the smallest row, the earlier leaf
          tb = t;
          rb = start + k;
        }
      }
      if (rb >= 0) {
        t_best = kAnyHit ? -kBig : tb;
        row_best = rb;
      }
      if (kAnyHit && __all_sync(kAll, row_best >= 0 || t_best < 0.0f)) break;
    }
    ptr = (any && start < 0) ? ptr + 1 : __float_as_int(n1.z);
  }
  if (i < N) {
    row_out[i] = row_best;
    t_out[i] = row_best < 0 ? __int_as_float(0x7f800000)  // +inf
                            : (kAnyHit ? 1.0f : t_best);
  }
}

}  // namespace

extern "C" int bvh_g8_launch(const float* orig, const float* dirs,
                             const uint8_t* alive, const float* nodes,
                             const float* tri, int M, int N, int any_hit,
                             float* t_out, int* row_out, void* stream) {
  if (N > 0) {
    const int blocks = (N + kThreads - 1) / kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* n4 = reinterpret_cast<const float4*>(nodes);
    const float4* t4 = reinterpret_cast<const float4*>(tri);
    if (any_hit)
      bvh_g8_kernel<true><<<blocks, kThreads, 0, s>>>(
          orig, dirs, alive, n4, t4, M, N, t_out, row_out);
    else
      bvh_g8_kernel<false><<<blocks, kThreads, 0, s>>>(
          orig, dirs, alive, n4, t4, M, N, t_out, row_out);
  }
  return static_cast<int>(cudaGetLastError());
}
